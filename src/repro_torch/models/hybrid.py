"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427).

Port of `repro.models.hybrid`.  Repeating block pattern (recurrent,
recurrent, local-attention); each temporal-mixing block is followed by its
own MLP residual.  The RG-LRU recurrence

    r_t = sigmoid(W_a u_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)            (input gate)
    a_t = exp(c * r_t * log(sigmoid(Lambda)))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

keeps its gates and matmuls in plain PyTorch (`_lru_coeffs`); the
recurrence over the sequence goes through kernel B4
(`repro_torch.kernels.rglru_scan`) on CUDA.  Local attention is MQA with a
bounded window held in a ring cache; its decode attends through kernel B1.

38 layers = 12 x (rec, rec, attn) + (rec, rec) tail.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import shard
from repro_torch.kernels import rglru_scan as _rglru
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
from repro_torch.models.ssm import _causal_conv

LRU_C = 8.0


def pattern_counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_units, n_tail_rec, n_attn).  Unit = (rec, rec, attn)."""
    per = len(cfg.block_pattern)            # 3
    n_units = cfg.n_layers // per
    rem = cfg.n_layers - n_units * per      # 38 - 36 = 2 tail rec layers
    return n_units, rem, n_units


def n_rec_layers(cfg: ModelConfig) -> int:
    n_units, tail, _ = pattern_counts(cfg)
    return 2 * n_units + tail


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def _rec_defs(cfg: ModelConfig, n: int) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or cfg.d_model
    L, A = (n,), ("layers",)
    return {
        "w_gate": ParamDef(L + (d, w), A + ("embed_w", "lru")),
        "w_x": ParamDef(L + (d, w), A + ("embed_w", "lru")),
        "conv_w": ParamDef(L + (cfg.conv_kernel, w), A + (None, "lru"), scale=0.1),
        "conv_b": ParamDef(L + (w,), A + ("lru",), init="zeros"),
        "w_a": ParamDef(L + (w, w), A + ("lru", None), scale=0.02),
        "b_a": ParamDef(L + (w,), A + ("lru",), init="zeros"),
        "w_i": ParamDef(L + (w, w), A + ("lru", None), scale=0.02),
        "b_i": ParamDef(L + (w,), A + ("lru",), init="zeros"),
        "lam": ParamDef(L + (w,), A + ("lru",), init="ones", scale=1.0),
        "w_out": ParamDef(L + (w, d), A + ("lru", "embed_w"),
                          scale=0.02 / max(1, (2 * cfg.n_layers) ** 0.5)),
        "ln_mix": {"w": ParamDef(L + (d,), A + (None,), init="zeros")},
        "mlp": mlp_defs(d, cfg.d_ff, n),
        "ln_mlp": {"w": ParamDef(L + (d,), A + (None,), init="zeros")},
    }


def _attn_block_defs(cfg: ModelConfig, n: int) -> dict:
    return {
        "attn": dense.attn_defs(cfg, n),
        "ln_mix": {"w": ParamDef((n, cfg.d_model), ("layers", None), init="zeros")},
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, n),
        "ln_mlp": {"w": ParamDef((n, cfg.d_model), ("layers", None), init="zeros")},
    }


def param_defs(cfg: ModelConfig) -> dict:
    n_units, tail, _ = pattern_counts(cfg)
    defs: dict = {
        "embed": ParamDef((padded_vocab(cfg.vocab_size), cfg.d_model), ("vocab", "embed_w")),
        "units": {
            "rec_a": _rec_defs(cfg, n_units),
            "rec_b": _rec_defs(cfg, n_units),
            "attn": _attn_block_defs(cfg, n_units),
        },
        "final_norm": {"w": ParamDef((cfg.d_model,), (None,), init="zeros")},
        "head": ParamDef((cfg.d_model, padded_vocab(cfg.vocab_size)), ("embed_w", "vocab")),
    }
    if tail:
        defs["tail"] = {"rec": _rec_defs(cfg, tail)}
    return defs


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _lru_coeffs(pl: dict, u: torch.Tensor):
    """u [..., w] -> (a_t, b_t) of h_t = a_t*h + b_t, in f32."""
    uf = u.float()
    r = torch.sigmoid(uf @ pl["w_a"].float() + pl["b_a"].float())
    i = torch.sigmoid(uf @ pl["w_i"].float() + pl["b_i"].float())
    # replicated under DTensor: log_sigmoid_backward has no sharding strategy
    log_a0 = shard.replicated(F.logsigmoid)(pl["lam"].float())   # [w]
    log_a = LRU_C * r * log_a0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def rglru_scan(pl: dict, u: torch.Tensor, h0: torch.Tensor | None = None):
    """RG-LRU over u [B,S,w] through kernel B4.  Returns (h [B,S,w] f32,
    h_last [B,w])."""
    a, b = _lru_coeffs(pl, u)
    if not shard.is_dtensor(a):
        return _rglru.rglru_scan(a, b, h0)
    # on DTensors, B4 on each device's shards (`shard.local_call`): batch and
    # width stay as they are sharded, a sharded sequence (the scan's axis)
    # is gathered first
    ab_pl = shard.moved(a.placements, {0: 0, 2: 2})
    last_pl = shard.moved(a.placements, {0: 0, 2: 1})
    split = [m for m, p in enumerate(ab_pl) if p.is_shard()]
    return shard.local_call(_rglru.rglru_scan, a.device_mesh, (a, b, h0),
                            (ab_pl, ab_pl, last_pl), [ab_pl, last_pl], split_dims=split)


def rglru_step(pl: dict, u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One-token RG-LRU.  u [B,w]; h [B,w] f32."""
    a, b = _lru_coeffs(pl, u)
    return a * h + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's `jax.nn.gelu`, whose default is the tanh form."""
    return F.gelu(x, approximate="tanh")


def _rec_mix_full(cfg, pl, x):
    """Recurrent temporal-mixing branch, full sequence.  x [B,S,d]."""
    gate = _gelu((x @ pl["w_gate"]).float())
    u = shard.constrain(x @ pl["w_x"], "batch", "seq", "lru")
    u, conv_state = _causal_conv(u, pl["conv_w"], pl["conv_b"])
    h, h_last = rglru_scan(pl, u)
    y = (gate * h).to(x.dtype)
    return y @ pl["w_out"], h_last, conv_state


def _rec_mix_step(cfg, pl, x, h, conv_state):
    """x [B,d]; h [B,w] f32; conv_state [B,K-1,w]."""
    gate = _gelu((x @ pl["w_gate"]).float())
    u, conv_state = _causal_conv((x @ pl["w_x"])[:, None], pl["conv_w"], pl["conv_b"],
                                 state=conv_state)
    h = rglru_step(pl, u[:, 0], h)
    y = (gate * h).to(x.dtype)
    return y @ pl["w_out"], h, conv_state


def _mlp_residual(cfg, pl, x):
    m = swiglu(rmsnorm(x, pl["ln_mlp"]["w"], cfg.rmsnorm_eps),
               pl["mlp"]["w_gate"], pl["mlp"]["w_up"], pl["mlp"]["w_down"])
    return x + m


def _rec_block_full(cfg, pl, x):
    mix, h_last, conv = _rec_mix_full(cfg, pl, rmsnorm(x, pl["ln_mix"]["w"], cfg.rmsnorm_eps))
    return _mlp_residual(cfg, pl, x + mix), h_last, conv


def _rec_block_step(cfg, pl, x, h, conv):
    mix, h, conv = _rec_mix_step(cfg, pl, rmsnorm(x, pl["ln_mix"]["w"], cfg.rmsnorm_eps),
                                 h, conv)
    return _mlp_residual(cfg, pl, x + mix), h, conv


def _attn_block_full(cfg, pl, x, window):
    a, k, v = dense.attention_full(cfg, pl["attn"],
                                   rmsnorm(x, pl["ln_mix"]["w"], cfg.rmsnorm_eps),
                                   window=window)
    return _mlp_residual(cfg, pl, x + a), k, v


def _attn_block_step(cfg, pl, x, k_l, v_l, pos, slot):
    """k_l, v_l [B, W, Hkv, Dh] this layer's ring cache; this token's K/V
    is written at `slot` = pos % W, in place, before it attends."""
    a = dense.attention_decode(cfg, pl["attn"],
                               rmsnorm(x, pl["ln_mix"]["w"], cfg.rmsnorm_eps),
                               k_l, v_l, pos, slot, ring=True)
    return _mlp_residual(cfg, pl, x + a)


# ---------------------------------------------------------------------------
# Full forward / decode over the (rec, rec, attn) units
# ---------------------------------------------------------------------------


def forward_full(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                 collect: bool = False):
    """Run the units and the tail over embeddings x [B,S,d].  Returns
    (hidden, (lru [Lr,B,w], conv [Lr,B,K-1,w], ks, vs [La,B,S,Hkv,Dh]) |
    None), the recurrent states in layer order.  Each unit and each tail
    layer is recomputed in the backward pass when cfg.remat is on, as the
    reference's scan bodies are."""

    def unit_body(h, pu):
        h = shard.constrain(h, "batch", "seq", None)
        h, st_a, cv_a = _rec_block_full(cfg, pu["rec_a"], h)
        h, st_b, cv_b = _rec_block_full(cfg, pu["rec_b"], h)
        h, k, v = _attn_block_full(cfg, pu["attn"], h, cfg.local_window)
        return h, st_a, cv_a, st_b, cv_b, k, v

    unit_body = maybe_remat(unit_body, cfg.remat)
    tail_body = maybe_remat(functools.partial(_rec_block_full, cfg), cfg.remat)
    h = x
    lru, conv, ks, vs = [], [], [], []
    for pu in unstack_layers(params["units"]):
        h, st_a, cv_a, st_b, cv_b, k, v = unit_body(h, pu)
        lru += [st_a, st_b]
        conv += [cv_a, cv_b]
        ks.append(k)
        vs.append(v)
    if "tail" in params:
        for pl in unstack_layers(params["tail"]["rec"]):
            h, st, cv = tail_body(pl, h)
            lru.append(st)
            conv.append(cv)
    if not collect:
        return h, None
    return h, tuple(map(torch.stack, (lru, conv, ks, vs)))


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Mean next-token cross-entropy.  On CUDA the RG-LRU goes through
    kernel B4 in both directions (its backward kernel carries the
    gradients)."""
    x = embed_tokens(params["embed"], batch["tokens"])
    h, _ = forward_full(cfg, params, x)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    loss, _ = cross_entropy(logits, batch["labels"])
    return loss, {}


def _assemble_cache(cfg, states, pos_end):
    lru, conv, ks, vs = states
    k, v = cachelib.ring_pack(cachelib.to_cache_dtype(ks, cfg.kv_dtype),
                              cachelib.to_cache_dtype(vs, cfg.kv_dtype),
                              cfg.local_window, pos_end)
    # capture-safe: no host-to-card copy (see dense._finish_cache)
    pos = torch.full((), pos_end, dtype=torch.int32, device=lru.device)
    return cachelib.HybridCache(lru, conv, k, v, pos)


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int = 0, long_context: bool = False):
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens)
    h, states = forward_full(cfg, params, x, collect=True)
    hl = rmsnorm(h[:, -1], params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(hl, params["head"], cfg.vocab_size)
    return logits, _assemble_cache(cfg, states, tokens.shape[1])


def init_cache(cfg: ModelConfig, batch: int, cache_len: int = 0, *,
               long_context: bool = False, dtype=None, device):
    n_units, tail, n_attn = pattern_counts(cfg)
    return cachelib.HybridCache.init(
        2 * n_units + tail, n_attn, batch, cfg.lru_width or cfg.d_model,
        cfg.conv_kernel, cfg.local_window, cfg.n_kv_heads, cfg.head_dim_,
        dtype or cfg.kv_dtype, device)


def decode_step(cfg: ModelConfig, params: dict, cache, batch: dict):
    """batch: {"token": [B] int32}.  Overwrites the recurrent states and
    writes this token's K/V into the rings in place; returns the cache with
    pos + 1 (same tensors)."""
    pos = cache.pos
    slot = torch.remainder(pos, cache.window)
    n_units = pattern_counts(cfg)[0]
    h = embed_tokens(params["embed"], batch["token"])

    def rec(pl, r, h):
        h, st, cv = _rec_block_step(cfg, pl, h, cache.lru[r], cache.conv[r])
        cache.lru[r].copy_(st)
        cache.conv[r].copy_(cv)
        return h

    for i, pu in enumerate(unstack_layers(params["units"])):
        h = rec(pu["rec_a"], 2 * i, h)
        h = rec(pu["rec_b"], 2 * i + 1, h)
        h = _attn_block_step(cfg, pu["attn"], h, cache.k[i], cache.v[i], pos, slot)
    if "tail" in params:
        for i, pl in enumerate(unstack_layers(params["tail"]["rec"])):
            h = rec(pl, 2 * n_units + i, h)

    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    return logits, cachelib.HybridCache(cache.lru, cache.conv, cache.k, cache.v, pos + 1)
