"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

Port copy of `repro.configs.qwen3_1_7b`, field for field.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    long_context_window=8192,
    microbatch=32,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-8B (scaled per assignment)",
    accuracy_ak=62.0,
    n_params_note="~1.7B",
)
