"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Port copy of `repro.configs.internvl2_2b`, field for field.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT
vision tower is stubbed; input_specs() provides patch embeddings
[B, 256, 1024] consumed through the MLP projector.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1e6,             # InternLM2
    n_patches=256,
    long_context_window=8192,   # sliding-window variant for long_500k
    microbatch=32,
    param_dtype="bfloat16",
    source="arXiv:2404.16821",
    accuracy_ak=55.0,
    n_params_note="~2.2B incl. stubbed ViT",
)
