"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954].

Port copy of `repro.configs.deepseek_67b`, field for field.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    long_context_window=8192,
    microbatch=32,
    param_dtype="bfloat16",
    source="arXiv:2401.02954",
    accuracy_ak=66.0,
    n_params_note="~67B",
)
