"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

Port copy of `repro.configs.granite_moe_3b_a800m`, field for field.

32L d_model=1536 24H (GQA kv=8) d_ff=512 (expert width) vocab=49155,
MoE 40e top-8.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                    # expert FFN width per the assignment
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    capacity_factor=1.25,
    rope_theta=10000.0,
    long_context_window=8192,
    microbatch=32,
    param_dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    accuracy_ak=48.0,
    n_params_note="~3B total, ~800M active",
)
