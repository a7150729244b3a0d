"""InternVL2 language backbone (VLM family).

Port of `repro.models.vlm`.  The InternViT vision tower is the allowed
stub: the caller supplies precomputed patch embeddings [B, n_patches,
VISION_DIM] (`configs.shapes.token_specs`).  This module owns the MLP
projector (VISION_DIM -> d_model) and the InternLM2-style decoder
(llama-arch GQA), with the patch embeddings placed BEFORE the text tokens
in the causal stream, the standard VLM prefill layout.

Everything after the embedding is `repro_torch.models.dense`: the KV cache
covers patch positions + text positions, so decode is the dense decode
(kernel B1 on CUDA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import dense
from repro_torch.models.common import (
    ModelConfig,
    ParamDef,
    cross_entropy,
    embed_tokens,
    lm_logits,
    rmsnorm,
)

VISION_DIM = 1024  # InternViT-300M output width (frontend stub contract)


def param_defs(cfg: ModelConfig) -> dict:
    defs = dense.param_defs(cfg)
    defs["projector"] = {
        "w1": ParamDef((VISION_DIM, cfg.d_model), (None, "embed_w")),
        "b1": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "w2": ParamDef((cfg.d_model, cfg.d_model), ("embed_w", None)),
        "b2": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }
    return defs


def project_patches(params: dict, patches: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, P, VISION_DIM] -> [B, P, d]: two products in `dtype` with an f32
    GELU between them (tanh form, `jax.nn.gelu`'s default)."""
    p = params["projector"]
    h = patches.to(dtype) @ p["w1"] + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(dtype)
    return h @ p["w2"] + p["b2"]


def _embed_multimodal(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """[patches ; tokens] -> [B, P + S_text, d]."""
    x_txt = embed_tokens(params["embed"], batch["tokens"])
    x_img = project_patches(params, batch["patches"], x_txt.dtype)
    return torch.cat([x_img, x_txt], dim=1)


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """batch: {"patches": [B,P,VISION_DIM], "tokens": [B,S], "labels": [B,S]}.
    Labels cover only the text positions; patch positions are ignored."""
    x = _embed_multimodal(cfg, params, batch)
    h, _ = dense.forward_full(cfg, params["blocks"], x, window=cfg.window)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    P = batch["patches"].shape[1]
    logits = lm_logits(h[:, P:], dense.head_matrix(cfg, params), cfg.vocab_size)
    loss, _ = cross_entropy(logits, batch["labels"])
    return loss, {}


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int, long_context: bool = False):
    """batch: {"patches": [B,P,VISION_DIM], "tokens": [B,S]}.  The cache
    holds P + S positions, so `cache_len` counts the patches."""
    window = cfg.long_context_window if long_context else cfg.window
    x = _embed_multimodal(cfg, params, batch)
    S = x.shape[1]
    h, (ks, vs) = dense.forward_full(cfg, params["blocks"], x, window=window,
                                     collect_kv=True)
    h = rmsnorm(h[:, -1], params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, dense.head_matrix(cfg, params), cfg.vocab_size)
    return logits, dense._finish_cache(cfg, ks, vs, cache_len, window, S)


init_cache = dense.init_cache
decode_step = dense.decode_step
