"""Seamless-M4T-v2 text backbone: encoder-decoder transformer (audio family).

Port of `repro.models.encdec`.  The speech frontend (mel + conformer
feature extractor) is the allowed stub: the caller supplies precomputed
frame embeddings [B, T_frames, d_model] (`configs.shapes.token_specs`).
The backbone is NLLB-style: encoder layers (bidirectional self-attention
over the frames) and decoder layers (causal self-attention plus
cross-attention into the encoder memory).  RoPE positions the encoder's
and decoder's self-attention; cross-attention is position-free.

Decode state is an `EncDecCache`: the self-attention KV cache, written in
place each step, and the cross-attention K/V of the memory, computed once
at prefill.  A decode step attends twice a layer through kernel B1 on
CUDA: over its own cache (`dense.attention_decode`) and over all T_frames
memory positions.  Layers are stacked `[L, ...]` and run in a Python loop.
"""

from __future__ import annotations

import torch

from repro_torch import shard
from repro_torch.models import attention as attn
from repro_torch.models import cache as cachelib
from repro_torch.models import dense
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
    swiglu,
    unstack_layers,
)


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


def _mlp(cfg: ModelConfig, pl: dict, h: torch.Tensor) -> torch.Tensor:
    return swiglu(rmsnorm(h, pl["ln_mlp"]["w"], cfg.rmsnorm_eps),
                  pl["mlp"]["w_gate"], pl["mlp"]["w_up"], pl["mlp"]["w_down"])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, T, d] (stubbed frontend output) -> memory [B, T, d]."""

    def body(h, pl):
        h = shard.constrain(h, "batch", "seq", None)
        a, _, _ = dense.attention_full(cfg, pl["attn"],
                                       rmsnorm(h, pl["ln_attn"]["w"], cfg.rmsnorm_eps),
                                       causal=False)
        h = h + a
        return h + _mlp(cfg, pl, h)

    body = maybe_remat(body, cfg.remat)
    h = frames.to(cfg.dtype) @ params["adapter"]
    for pl in unstack_layers(params["encoder"]):
        h = body(h, pl)
    return rmsnorm(h, params["enc_norm"]["w"], cfg.rmsnorm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _cross_attention_full(cfg, pl, x, mem_k, mem_v):
    """x [B,S,d]; mem_k/mem_v [B,T,H,Dh] precomputed."""
    q = dense._heads(x, pl["wq"])
    o = attn.full_attention(q, mem_k, mem_v, causal=False)
    return dense._out_proj(o, pl["wo"])


def _cross_kv(cfg, pl, memory):
    return dense._heads(memory, pl["wk"]), dense._heads(memory, pl["wv"])


def _cross_attention_token(cfg, pl, x, k_l, v_l, last):
    """x [B,d]; k_l/v_l [B,T,H,Dh]; `last` the 0-d int32 T-1: every memory
    position is valid (kernel B1 on CUDA, no ring, no softcap)."""
    q = dense._heads(x, pl["wq"])
    o = attn.decode_attention(q, k_l, v_l, last)
    return dense._out_proj(o, pl["wo"])


def decode_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                memory: torch.Tensor, *, window: int = 0, collect: bool = False):
    """Teacher-forced decoder pass.  Returns (hidden, (ks, vs, ck, cv) |
    None), each stacked over layers: ks [L, B, S, H, Dh], ck [L, B, T, H, Dh]."""

    def body(h, pl):
        h = shard.constrain(h, "batch", "seq", None)
        a, k, v = dense.attention_full(
            cfg, pl["self"], rmsnorm(h, pl["ln_self"]["w"], cfg.rmsnorm_eps),
            window=window)
        h = h + a
        ck, cv = _cross_kv(cfg, pl["cross"], memory)
        h = h + _cross_attention_full(
            cfg, pl["cross"], rmsnorm(h, pl["ln_cross"]["w"], cfg.rmsnorm_eps), ck, cv)
        return h + _mlp(cfg, pl, h), k, v, ck, cv

    body = maybe_remat(body, cfg.remat)
    h = embed_tokens(params["embed"], tokens)
    kv = ([], [], [], [])
    for pl in unstack_layers(params["decoder"]):
        h, *layer_kv = body(h, pl)
        if collect:
            for acc, t in zip(kv, layer_kv):
                acc.append(t)
    return h, (tuple(torch.stack(acc) for acc in kv) if collect else None)


# ---------------------------------------------------------------------------
# Registry API
# ---------------------------------------------------------------------------


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """batch: {"frames": [B,T,d], "tokens": [B,S], "labels": [B,S]}: the
    decoder's mean next-token cross-entropy over the encoded frames."""
    memory = encode(cfg, params, batch["frames"])
    h, _ = decode_full(cfg, params, batch["tokens"], memory, window=cfg.window)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    loss, _ = cross_entropy(logits, batch["labels"])
    return loss, {}


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int, long_context: bool = False):
    """batch: {"frames": [B,T,d], "tokens": [B,S]}: encodes, runs the
    decoder prefix, returns the last logits and an EncDecCache.  Self K/V
    are cast to kv_dtype (ring-packed when windowed, else padded to
    cache_len); cross K/V stay in the compute dtype, as in the reference."""
    window = cfg.long_context_window if long_context else cfg.window
    memory = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    S = tokens.shape[1]
    h, (ks, vs, ck, cv) = decode_full(cfg, params, tokens, memory,
                                      window=window, collect=True)
    hl = rmsnorm(h[:, -1], params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(hl, params["head"], cfg.vocab_size)
    ks = cachelib.to_cache_dtype(ks, cfg.kv_dtype)
    vs = cachelib.to_cache_dtype(vs, cfg.kv_dtype)
    if window:
        ks, vs = cachelib.ring_pack(ks, vs, window, S)
    else:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} is shorter than the prompt {S}")
        shape = ks.shape[:2] + (cache_len,) + ks.shape[3:]
        k, v = ks.new_zeros(shape), vs.new_zeros(shape)
        k[:, :, :S] = ks
        v[:, :, :S] = vs
        ks, vs = k, v
    # capture-safe: no host-to-card copy (see dense._finish_cache)
    pos = torch.full((), S, dtype=torch.int32, device=tokens.device)
    return logits, cachelib.EncDecCache(ks, vs, ck, cv, pos)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               long_context: bool = False, dtype=None, device):
    dtype = dtype or cfg.kv_dtype
    window = cfg.long_context_window if long_context else cfg.window
    s_len = min(window, cache_len) if window else cache_len
    return cachelib.EncDecCache.init(cfg.dec_layers, batch, s_len, cfg.n_frames,
                                     cfg.n_kv_heads, cfg.head_dim_, dtype, device)


def decode_step(cfg: ModelConfig, params: dict, cache, batch: dict):
    """batch: {"token": [B] int32}.  Writes this token's self K/V into the
    cache in place at the reference's slot and returns the cache with
    pos + 1 (same tensors).  Kernel B1 runs twice a layer on CUDA."""
    token = batch["token"]
    pos = cache.pos
    S = cache.cache_len
    # ring when the cache is windowed (long-context mode): the reference's rule
    ring = bool(cfg.long_context_window and S == cfg.long_context_window) or bool(cfg.window)
    slot = torch.remainder(pos, S) if ring else torch.clamp(pos, max=S - 1)
    last = torch.full((), cache.cross_k.shape[2] - 1, dtype=torch.int32, device=pos.device)
    h = embed_tokens(params["embed"], token)
    for i, pl in enumerate(unstack_layers(params["decoder"])):
        h = h + dense.attention_decode(
            cfg, pl["self"], rmsnorm(h, pl["ln_self"]["w"], cfg.rmsnorm_eps),
            cache.self_k[i], cache.self_v[i], pos, slot, ring=ring)
        h = h + _cross_attention_token(
            cfg, pl["cross"], rmsnorm(h, pl["ln_cross"]["w"], cfg.rmsnorm_eps),
            cache.cross_k[i], cache.cross_v[i], last)
        h = h + _mlp(cfg, pl, h)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    return logits, cachelib.EncDecCache(cache.self_k, cache.self_v, cache.cross_k,
                                        cache.cross_v, pos + 1)
