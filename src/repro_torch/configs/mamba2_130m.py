"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Port copy of `repro.configs.mamba2_130m`, field for field.

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, headdim 64 -> 24 SSD heads, 1 group.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                   # attention-free
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_kernel=4,
    microbatch=0,
    param_dtype="bfloat16",
    source="arXiv:2405.21060",
    accuracy_ak=35.0,
    n_params_note="~130M",
)
