"""qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family].

Port copy of `repro.configs.qwen2_5_14b`, field for field.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    long_context_window=8192,
    microbatch=32,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen2.5-0.5B (scaled per assignment)",
    accuracy_ak=63.0,
    n_params_note="~14B",
)
