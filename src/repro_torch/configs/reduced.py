"""Reduced same-family variants for CPU smoke tests and the real-execution
characterization campaign: <=2 layers, d_model<=512, <=4 experts, float32.
Port copy of `repro.configs.reduced`.

Each reduced config preserves the *family-defining structure* (GQA ratios,
MoE routing, MLA latents, SSD state, the (rec,rec,attn) pattern, enc-dec
split) so the smoke test exercises the same code paths as the full config.
"""

from __future__ import annotations

from repro_torch.models.common import ModelConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    kw: dict = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=256,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=512,
        param_dtype="float32",
        microbatch=0,
        remat=False,
        window=min(cfg.window, 64) if cfg.window else 0,
        long_context_window=64,
        n_frames=32,
    )
    if cfg.family in ("dense", "vlm", "encdec", "moe", "hybrid"):
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=32)
    if cfg.family == "vlm":
        kw.update(n_patches=8)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2, n_layers=4, n_kv_heads=4)
    if cfg.family == "moe":
        kw.update(
            n_experts=4, top_k=2, d_expert=0, d_ff=128,
            n_dense_layers=1 if cfg.n_dense_layers else 0,
            dense_d_ff=256 if cfg.dense_d_ff else 0,
            expert_shard_axes=("model",),
            n_shared_experts=min(cfg.n_shared_experts, 1),
        )
        if cfg.use_mla:
            kw.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                      qk_rope_dim=16, v_head_dim=32)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_ngroups=1,
                  ssm_chunk=16)
    if cfg.family == "hybrid":
        # 1 unit of (rec, rec, attn) + 2 tail rec layers = 5 layers
        kw.update(n_layers=5, lru_width=128, local_window=32, head_dim=64)
    return cfg.replace(**kw)
