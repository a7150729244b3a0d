"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

Port copy of `repro.configs.deepseek_v3_671b`, field for field.

61L d_model=7168 128H d_ff=2048 (expert width) vocab=129280, MoE 256e
top-8.  MLA dims per the V3 report: q LoRA 1536, kv LoRA 512, nope 128,
rope 64, v 128; first 3 layers dense (d_ff 18432).  Adafactor for train
(AdamW state cannot fit 256 chips x 16 GB for 671B params).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,                   # routed-expert width
    vocab_size=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    n_dense_layers=3,
    dense_d_ff=18432,
    capacity_factor=1.25,
    expert_shard_axes=("data", "model"),  # 256 experts over 256 chips
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    # Absorbed-matmul decode is integral to MLA (V3 report §2.1): the
    # latent cache only works if W_UK/W_UV are absorbed at decode.  The
    # expand-vs-absorb comparison is kept as an ablation lever in §Perf.
    mla_absorb=True,
    mtp=True,
    rope_theta=10000.0,
    long_context_window=8192,
    microbatch=32,
    grad_accum_dtype="bfloat16",
    optimizer="adafactor",
    param_dtype="bfloat16",
    source="arXiv:2412.19437",
    accuracy_ak=75.0,
    n_params_note="671B total, ~37B active",
)
