"""Decoder-only dense transformer (Llama/Falcon/Mistral family).

Port of `repro.models.dense`: the paper's dense zoo (Falcon 7/40B,
Llama-2 7/13/70B, Mistral 7B), GQA with optional QKV bias, qk-norm and
sliding-window attention.  Layers are stacked `[L, ...]` and run in a
Python loop over the layer index.  Decode writes each layer's new K/V into
the cache in place (see `repro_torch.models.cache`) and attends through
kernel B1 on CUDA.
"""

from __future__ import annotations

import torch

from repro_torch import shard
from repro_torch.models import attention as attn
from repro_torch.models import cache as cachelib
from repro_torch.models.common import (
    ModelConfig,
    ParamDef,
    cross_entropy,
    embed_tokens,
    lm_logits,
    maybe_remat,
    mlp_defs,
    padded_vocab,
    rmsnorm,
    rope,
    swiglu,
    unstack_layers,
)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig, n_layers: int) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    L = (n_layers,)
    A = ("layers",)
    defs = {
        "wq": ParamDef(L + (d, hq, hd), A + ("embed_w", "heads", None)),
        "wk": ParamDef(L + (d, hkv, hd), A + ("embed_w", "kv_heads", None)),
        "wv": ParamDef(L + (d, hkv, hd), A + ("embed_w", "kv_heads", None)),
        "wo": ParamDef(L + (hq, hd, d), A + ("heads", None, "embed_w"),
                       scale=0.02 / max(1, (2 * cfg.n_layers) ** 0.5)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(L + (hq, hd), A + ("heads", None), init="zeros")
        defs["bk"] = ParamDef(L + (hkv, hd), A + ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef(L + (hkv, hd), A + ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef(L + (hd,), A + (None,), init="zeros")
        defs["k_norm"] = ParamDef(L + (hd,), A + (None,), init="zeros")
    return defs


def layer_defs(cfg: ModelConfig) -> dict:
    L = (cfg.n_layers,)
    A = ("layers",)
    return {
        "attn": attn_defs(cfg, cfg.n_layers),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, cfg.n_layers),
        "ln_attn": {"w": ParamDef(L + (cfg.d_model,), A + (None,), init="zeros")},
        "ln_mlp": {"w": ParamDef(L + (cfg.d_model,), A + (None,), init="zeros")},
    }


def param_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": ParamDef((padded_vocab(cfg.vocab_size), cfg.d_model), ("vocab", "embed_w")),
        "blocks": layer_defs(cfg),
        "final_norm": {"w": ParamDef((cfg.d_model,), (None,), init="zeros")},
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, padded_vocab(cfg.vocab_size)),
                                ("embed_w", "vocab"))
    return defs


def head_matrix(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------------------
# Attention sublayer
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('...d,dhe->...he', x, w) as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_qkv(cfg: ModelConfig, pl: dict, x: torch.Tensor):
    """x [..., d] -> q [..., Hq, Dh], k/v [..., Hkv, Dh] (roped by caller)."""
    q, k, v = _heads(x, pl["wq"]), _heads(x, pl["wk"]), _heads(x, pl["wv"])
    if cfg.qkv_bias:
        q, k, v = q + pl["bq"], k + pl["bk"], v + pl["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, pl["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, pl["k_norm"], cfg.rmsnorm_eps)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('...he,hed->...d', o, wo) as one matmul."""
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def attention_full(cfg: ModelConfig, pl: dict, x: torch.Tensor, *,
                   q_offset: int = 0, window: int = 0, causal: bool = True):
    """Full-sequence attention sublayer.  Returns (y, k, v) — roped k and raw
    v for the cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, pl, x)
    positions = (q_offset + torch.arange(S, device=x.device)).expand(B, S)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attn.full_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, softcap=cfg.attn_logit_softcap)
    return _out_proj(o, pl["wo"]), k, v


def _rope_token(cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rope one token's heads [B, H, Dh] at position pos (0-d tensor)."""
    return rope(x[:, None], pos.expand(x.shape[0], 1), cfg.rope_theta)[:, 0]


def attention_decode(cfg: ModelConfig, pl: dict, x: torch.Tensor,
                     k_l: torch.Tensor, v_l: torch.Tensor, pos: torch.Tensor,
                     slot: torch.Tensor, *, ring: bool) -> torch.Tensor:
    """One-token attention sublayer.  x [B, d] (normed); k_l/v_l
    [B, S, Hkv, Dh] this layer's cache, into which this token's roped K and
    V are written at `slot` before it attends (kernel B1 on CUDA).
    Returns y [B, d]."""
    q, k_new, v_new = _project_qkv(cfg, pl, x)
    cachelib.write_token(k_l, _rope_token(cfg, k_new, pos), slot)
    cachelib.write_token(v_l, v_new, slot)
    o = attn.decode_attention(_rope_token(cfg, q, pos), k_l, v_l, pos, ring=ring,
                              softcap=cfg.attn_logit_softcap)
    return _out_proj(o, pl["wo"])


def decode_layer(cfg: ModelConfig, pl: dict, h: torch.Tensor,
                 k_l: torch.Tensor, v_l: torch.Tensor, pos: torch.Tensor,
                 slot: torch.Tensor, *, ring: bool) -> torch.Tensor:
    """One layer of a one-token pass.  h [B, d]; k_l/v_l [B, S, Hkv, Dh]
    this layer's cache, into which this token's K/V is written at `slot`."""
    h = h + attention_decode(cfg, pl["attn"], rmsnorm(h, pl["ln_attn"]["w"], cfg.rmsnorm_eps),
                             k_l, v_l, pos, slot, ring=ring)
    m = swiglu(rmsnorm(h, pl["ln_mlp"]["w"], cfg.rmsnorm_eps),
               pl["mlp"]["w_gate"], pl["mlp"]["w_up"], pl["mlp"]["w_down"])
    return h + m


# ---------------------------------------------------------------------------
# Transformer stack
# ---------------------------------------------------------------------------


def forward_full(cfg: ModelConfig, blocks: dict, x: torch.Tensor, *,
                 q_offset: int = 0, window: int = 0, collect_kv: bool = False):
    """Run the layer stack over embeddings x [B, S, d].
    Returns (hidden, (ks, vs) | None); ks [L, B, S, Hkv, Dh].  Each layer
    is recomputed in the backward pass when cfg.remat is on."""

    def body(h, pl):
        h = shard.constrain(h, "batch", "seq", None)
        a, k, v = attention_full(cfg, pl["attn"],
                                 rmsnorm(h, pl["ln_attn"]["w"], cfg.rmsnorm_eps),
                                 q_offset=q_offset, window=window)
        h = h + a
        m = swiglu(rmsnorm(h, pl["ln_mlp"]["w"], cfg.rmsnorm_eps),
                   pl["mlp"]["w_gate"], pl["mlp"]["w_up"], pl["mlp"]["w_down"])
        return h + m, k, v

    body = maybe_remat(body, cfg.remat)
    h = x
    ks, vs = [], []
    for pl in unstack_layers(blocks):
        h, k, v = body(h, pl)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return h, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def decode_pass(cfg: ModelConfig, blocks: dict, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor, *, ring: bool) -> torch.Tensor:
    """One-token pass.  x [B, d]; k_cache [L, B, S, Hkv, Dh], updated in
    place.  Returns the hidden state [B, d]."""
    S = k_cache.shape[2]
    slot = torch.remainder(pos, S) if ring else torch.clamp(pos, max=S - 1)
    h = x
    for i, pl in enumerate(unstack_layers(blocks)):
        h = decode_layer(cfg, pl, h, k_cache[i], v_cache[i], pos, slot, ring=ring)
    return h


# ---------------------------------------------------------------------------
# Registry API
# ---------------------------------------------------------------------------


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Mean next-token cross-entropy of batch["tokens"] against
    batch["labels"] (-1 = ignored).  Returns (loss, metrics)."""
    x = embed_tokens(params["embed"], batch["tokens"])
    h, _ = forward_full(cfg, params["blocks"], x, window=cfg.window)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, head_matrix(cfg, params), cfg.vocab_size)
    loss, _ = cross_entropy(logits, batch["labels"])
    return loss, {}


def _finish_cache(cfg, ks, vs, cache_len, window, pos_end):
    """Stacked per-layer K/V [L,B,S,...] -> cache object sized cache_len or
    ring-packed into `window` slots."""
    ks = cachelib.to_cache_dtype(ks, cfg.kv_dtype)
    vs = cachelib.to_cache_dtype(vs, cfg.kv_dtype)
    # torch.full, not torch.tensor: a host int copied to the card is a
    # synchronizing copy, which a CUDA graph's capture refuses (pos_end is
    # fixed for a captured shape)
    pos = torch.full((), pos_end, dtype=torch.int32, device=ks.device)
    if window:
        k, v = cachelib.ring_pack(ks, vs, window, pos_end)
        return cachelib.WindowKVCache(k, v, pos)
    S = ks.shape[2]
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt {S}")
    shape = ks.shape[:2] + (cache_len,) + ks.shape[3:]
    k, v = ks.new_zeros(shape), vs.new_zeros(shape)
    k[:, :, :S] = ks
    v[:, :, :S] = vs
    return cachelib.KVCache(k, v, pos)


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int, long_context: bool = False):
    tokens = batch["tokens"]
    S = tokens.shape[1]
    window = cfg.long_context_window if long_context else cfg.window
    x = embed_tokens(params["embed"], tokens)
    h, (ks, vs) = forward_full(cfg, params["blocks"], x, window=window,
                               collect_kv=True)
    h = rmsnorm(h[:, -1], params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, head_matrix(cfg, params), cfg.vocab_size)
    cache = _finish_cache(cfg, ks, vs, cache_len, window, S)
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               long_context: bool = False, dtype=None, device):
    dtype = dtype or cfg.kv_dtype
    window = cfg.long_context_window if long_context else cfg.window
    if window:
        return cachelib.WindowKVCache.init(
            cfg.n_layers, batch, min(window, cache_len), cfg.n_kv_heads,
            cfg.head_dim_, dtype, device)
    return cachelib.KVCache.init(cfg.n_layers, batch, cache_len,
                                 cfg.n_kv_heads, cfg.head_dim_, dtype, device)


def decode_step(cfg: ModelConfig, params: dict, cache, batch: dict):
    """batch: {"token": [B] int32}.  Uses cache.pos as the write position;
    writes this token's K/V into the cache in place and returns the cache
    with pos + 1 (same k/v tensors)."""
    token = batch["token"]
    pos = cache.pos
    ring = isinstance(cache, cachelib.WindowKVCache)
    x = embed_tokens(params["embed"], token)
    h = decode_pass(cfg, params["blocks"], x, cache.k, cache.v, pos, ring=ring)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, head_matrix(cfg, params), cfg.vocab_size)
    return logits, type(cache)(cache.k, cache.v, pos + 1)
