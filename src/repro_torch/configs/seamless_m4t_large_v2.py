"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

Port copy of `repro.configs.seamless_m4t_large_v2`, field for field.

24L d_model=1024 16H (kv=16, MHA) d_ff=8192 vocab=256206.  Interpreted as
24 encoder + 24 decoder layers (the NLLB-style text backbone of M4T-large);
the speech frontend is stubbed — input_specs() provides frame embeddings
[B, n_frames, d_model].
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,                 # 24 enc + 24 dec
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    n_frames=4096,
    long_context_window=8192,
    microbatch=32,
    param_dtype="bfloat16",
    source="arXiv:2308.11596",
    accuracy_ak=52.0,
    n_params_note="~2.3B backbone",
)
