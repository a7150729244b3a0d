"""Mixture-of-Experts transformers: parameter definitions.

Port of the shape tables of `repro.models.moe`: granite-moe-3b-a800m (GQA
attention, 40 experts top-8), Mixtral 8x7B (paper zoo; GQA, 8 experts
top-2) and deepseek-v3-671b (MLA attention, 1 shared + 256 routed top-8,
leading dense layers, MTP).  The cost model and the simulator count these
families' parameters through them.  The forward passes (capacity dispatch,
MLA prefill and absorbed decode) are not ported yet: ROADMAP queue 1.
"""

from __future__ import annotations

from repro_torch.models import dense
from repro_torch.models.common import ModelConfig, ParamDef, mlp_defs, padded_vocab


def moe_defs(cfg: ModelConfig, n_layers: int) -> dict:
    d = cfg.d_model
    de = cfg.d_expert or cfg.d_ff
    E = cfg.n_experts
    L = (n_layers,)
    A = ("layers",)
    defs = {
        "router": ParamDef(L + (d, E), A + ("embed_w", None), scale=0.02),
        "w_gate": ParamDef(L + (E, d, de), A + ("expert", "embed_w", "mlp")),
        "w_up": ParamDef(L + (E, d, de), A + ("expert", "embed_w", "mlp")),
        "w_down": ParamDef(L + (E, de, d), A + ("expert", "mlp", "embed_w"),
                           scale=0.02 / max(1, (2 * cfg.n_layers) ** 0.5)),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(d, de * cfg.n_shared_experts, n_layers)
    return defs


def mla_defs(cfg: ModelConfig, n_layers: int) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    Dn, Dr, Dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    L = (n_layers,)
    A = ("layers",)
    return {
        "w_q_a": ParamDef(L + (d, qr), A + ("embed_w", None)),
        "q_norm": ParamDef(L + (qr,), A + (None,), init="zeros"),
        "w_q_b": ParamDef(L + (qr, H, Dn + Dr), A + (None, "heads", None)),
        "w_kv_a": ParamDef(L + (d, kr + Dr), A + ("embed_w", None)),
        "kv_norm": ParamDef(L + (kr,), A + (None,), init="zeros"),
        "w_kv_b": ParamDef(L + (kr, H, Dn + Dv), A + (None, "heads", None)),
        "wo": ParamDef(L + (H, Dv, d), A + ("heads", None, "embed_w"),
                       scale=0.02 / max(1, (2 * cfg.n_layers) ** 0.5)),
    }


def layer_defs(cfg: ModelConfig) -> dict:
    """Two stacks: leading dense-FFN layers (DeepSeek-V3) + MoE layers."""
    nd = cfg.n_dense_layers
    nm = cfg.n_layers - nd
    att = mla_defs if cfg.use_mla else dense.attn_defs
    out: dict = {
        "moe_blocks": {
            "attn": att(cfg, nm),
            "moe": moe_defs(cfg, nm),
            "ln_attn": {"w": ParamDef((nm, cfg.d_model), ("layers", None), init="zeros")},
            "ln_mlp": {"w": ParamDef((nm, cfg.d_model), ("layers", None), init="zeros")},
        }
    }
    if nd:
        out["dense_blocks"] = {
            "attn": att(cfg, nd),
            "mlp": mlp_defs(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, nd),
            "ln_attn": {"w": ParamDef((nd, cfg.d_model), ("layers", None), init="zeros")},
            "ln_mlp": {"w": ParamDef((nd, cfg.d_model), ("layers", None), init="zeros")},
        }
    return out


def param_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": ParamDef((padded_vocab(cfg.vocab_size), cfg.d_model), ("vocab", "embed_w")),
        "blocks": layer_defs(cfg),
        "final_norm": {"w": ParamDef((cfg.d_model,), (None,), init="zeros")},
        "head": ParamDef((cfg.d_model, padded_vocab(cfg.vocab_size)), ("embed_w", "vocab")),
    }
    if cfg.mtp:
        defs["mtp"] = {
            "proj": ParamDef((2 * cfg.d_model, cfg.d_model), (None, "embed_w")),
            "ln": {"w": ParamDef((cfg.d_model,), (None,), init="zeros")},
            "mlp": mlp_defs(cfg.d_model, cfg.dense_d_ff or cfg.d_ff),
        }
    return defs
