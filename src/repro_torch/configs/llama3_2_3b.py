"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B family].

Port copy of `repro.configs.llama3_2_3b`, field for field.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    long_context_window=8192,
    microbatch=32,
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-1B (scaled per assignment)",
    accuracy_ak=58.0,
    n_params_note="~3.2B",
)
