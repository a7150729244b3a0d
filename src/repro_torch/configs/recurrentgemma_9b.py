"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, (rec,rec,attn)
pattern [arXiv:2402.19427].

Port copy of `repro.configs.recurrentgemma_9b`, field for field.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; local window 2048.
38 = 12 x (rec, rec, attn) + 2 tail recurrent layers.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_window=2048,
    conv_kernel=4,
    attn_logit_softcap=0.0,
    microbatch=32,
    param_dtype="bfloat16",
    source="arXiv:2402.19427",
    accuracy_ak=60.0,
    n_params_note="~9B",
)
