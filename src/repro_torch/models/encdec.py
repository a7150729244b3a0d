"""Seamless-M4T-v2 text backbone (encoder-decoder, audio family):
parameter definitions.

Port of the shape tables of `repro.models.encdec`: an NLLB-style
backbone of encoder layers (bidirectional self-attention over the stubbed
speech frontend's frame embeddings) and decoder layers (causal
self-attention plus cross-attention into the encoder memory).  The cost
model and the simulator count its parameters through them.  The forward
passes are not ported yet: ROADMAP queue 1.
"""

from __future__ import annotations

from repro_torch.models import dense
from repro_torch.models.common import ModelConfig, ParamDef, mlp_defs, padded_vocab


def _xattn_defs(cfg: ModelConfig, n: int) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    L, A = (n,), ("layers",)
    return {
        "wq": ParamDef(L + (d, h, hd), A + ("embed_w", "heads", None)),
        "wk": ParamDef(L + (d, h, hd), A + ("embed_w", "kv_heads", None)),
        "wv": ParamDef(L + (d, h, hd), A + ("embed_w", "kv_heads", None)),
        "wo": ParamDef(L + (h, hd, d), A + ("heads", None, "embed_w"),
                       scale=0.02 / max(1, (2 * cfg.n_layers) ** 0.5)),
    }


def param_defs(cfg: ModelConfig) -> dict:
    ne, nd = cfg.enc_layers, cfg.dec_layers
    d = cfg.d_model
    return {
        "adapter": ParamDef((d, d), ("embed_w", None)),  # frame-embed adapter
        "embed": ParamDef((padded_vocab(cfg.vocab_size), d), ("vocab", "embed_w")),
        "encoder": {
            "attn": dense.attn_defs(cfg, ne),
            "mlp": mlp_defs(d, cfg.d_ff, ne),
            "ln_attn": {"w": ParamDef((ne, d), ("layers", None), init="zeros")},
            "ln_mlp": {"w": ParamDef((ne, d), ("layers", None), init="zeros")},
        },
        "enc_norm": {"w": ParamDef((d,), (None,), init="zeros")},
        "decoder": {
            "self": dense.attn_defs(cfg, nd),
            "cross": _xattn_defs(cfg, nd),
            "mlp": mlp_defs(d, cfg.d_ff, nd),
            "ln_self": {"w": ParamDef((nd, d), ("layers", None), init="zeros")},
            "ln_cross": {"w": ParamDef((nd, d), ("layers", None), init="zeros")},
            "ln_mlp": {"w": ParamDef((nd, d), ("layers", None), init="zeros")},
        },
        "final_norm": {"w": ParamDef((d,), (None,), init="zeros")},
        "head": ParamDef((d, padded_vocab(cfg.vocab_size)), ("embed_w", "vocab")),
    }
