"""Mixture-of-Experts transformers.

Port of `repro.models.moe`'s inference path: granite-moe-3b-a800m (GQA
attention, 40 experts top-8), Mixtral 8x7B (paper zoo; GQA, 8 experts
top-2) and deepseek-v3-671b (MLA attention, 1 shared + 256 routed top-8,
leading dense layers, MTP).

Dispatch is capacity-based, with the reference's index tables: the
(token, k) pairs are sorted by expert (a stable sort), gathered into an
[E, C, d] buffer, run through the stacked expert products over the whole
buffer, and combined back with the router gates.  Inference is dropless
(C >= T); `dropless=False` drops the pairs past the capacity-factor
capacity as the reference's training path does.  C follows from the token
count alone, so no table is read back to the host.

Dense-attention layers reuse `repro_torch.models.dense` (decode writes the
KV cache in place and attends through kernel B1 on CUDA); MLA layers keep
a latent cache (`cache.MLACache`) and attend in plain PyTorch, as the
reference runs MLA outside any Pallas kernel.  The reference's custom VJPs
of the dispatch and combine, `train_loss` and the MTP head's use in it
are training: not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import shard
from repro_torch.models import attention as attnlib
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
    rope,
    swiglu,
    unstack_layers,
)


# ---------------------------------------------------------------------------
# Router + capacity dispatch
# ---------------------------------------------------------------------------


def expert_capacity(n_tokens: int, cfg: ModelConfig, *,
                    dropless: bool = False) -> int:
    """Per-expert slot count.  Dropless (inference): capacity T rounded up
    to 8, so no pair is ever dropped and prefill/decode agree with the
    teacher-forced pass.  Otherwise the capacity-factor formula, past which
    pairs are dropped."""
    if dropless:
        return max(8, int(math.ceil(n_tokens / 8)) * 8)
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8)) * 8)


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


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """xt [T, d] -> (probs [T, E] f32, gates [T, K] f32, eidx [T, K] int64).

    The top K by a stable descending sort: on ties the lower expert index
    comes first, as `jax.lax.top_k` returns them (`torch.topk` promises no
    order).  Gates are renormalized over the K chosen."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, eidx


@dataclasses.dataclass
class Dispatch:
    """Index tables of one capacity dispatch, as the reference builds them.
    Out-of-range entries mark empty slots and dropped pairs."""
    counts: torch.Tensor     # [E] pairs routed to each expert
    keep: torch.Tensor       # [T*K] bool, per pair in expert-sorted order
    slot2tok: torch.Tensor   # [E, C] token feeding each slot (T = empty)
    slot2pair: torch.Tensor  # [E, C] pair feeding each slot (T*K = empty)
    tok2slot: torch.Tensor   # [T, K] flat slot of each pair (E*C = dropped)
    inv_order: torch.Tensor  # [T*K] each pair's place in expert-sorted order


def dispatch_tables(eidx: torch.Tensor, n_experts: int, capacity: int) -> Dispatch:
    """Sort-based dispatch tables for eidx [T, K] into E experts of
    `capacity` slots: a pair keeps its place in a stable sort by expert,
    and the first `capacity` pairs of each expert are kept."""
    T, K = eidx.shape
    E, C = n_experts, capacity
    dev = eidx.device
    pair_e = eidx.reshape(T * K)
    order = torch.argsort(pair_e, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(T * K, device=dev)
    pair_e_s = pair_e[order]
    # scatter_add_, not bincount: bincount on CUDA reads its input's max
    # back to the host to size its output
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, pair_e, torch.ones_like(pair_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - starts[pair_e_s]
    keep = rank < C
    arange_c = torch.arange(C, device=dev)[None, :]
    src = (starts[:, None] + arange_c).clamp(max=T * K - 1)
    valid = arange_c < counts[:, None]
    slot2tok = torch.where(valid, (order // K)[src], T)
    slot2pair = torch.where(valid, order[src], T * K)
    slot_sorted = torch.where(keep, pair_e_s * C + rank, E * C)
    tok2slot = slot_sorted[inv_order].reshape(T, K)
    return Dispatch(counts, keep, slot2tok, slot2pair, tok2slot, inv_order)


def _masked_take(operand: torch.Tensor, idx: torch.Tensor, oob: int) -> torch.Tensor:
    """operand [N, d] gathered at idx [...] with idx == oob -> zeros."""
    safe = idx.clamp(max=operand.shape[0] - 1)
    out = operand.index_select(0, safe.reshape(-1)).reshape(*idx.shape, operand.shape[-1])
    return out * (idx < oob)[..., None].to(out.dtype)


class _Dispatch(torch.autograd.Function):
    """xt [T, d] -> expert buffer [E, C, d] through slot2tok [E, C]
    (T = empty slot).  Backward: the reference's `_dispatch_bwd`, a gather
    of the buffer's gradient through tok2slot [T, K] (E*C = dropped),
    summed over each token's K pairs."""

    @staticmethod
    def forward(ctx, xt, slot2tok, tok2slot):
        ctx.save_for_backward(tok2slot)
        ctx.rules = shard.capture()     # the backward may run on another thread
        buf = _masked_take(xt, slot2tok, xt.shape[0])
        return shard.constrain(buf, None, None, "moe_embed")

    @staticmethod
    def backward(ctx, g):
        tok2slot, = ctx.saved_tensors
        E, C, d = g.shape
        with ctx.rules():
            g = shard.constrain(g, None, None, "moe_embed")
            gt = _masked_take(g.reshape(E * C, d), tok2slot, E * C)      # [T, K, d]
            gt = shard.constrain(gt, None, None, "moe_embed")
            return gt.sum(1), None, None


class _Combine(torch.autograd.Function):
    """y [E, C, d], gates [T, K] -> out [T, d]: each token's pairs gathered
    from their slots through tok2slot and weighted by their gates.
    Backward: the reference's `_combine_bwd`; the buffer's gradient is a
    gather of the pairs' gradients through slot2pair [E, C] (T*K = empty)."""

    @staticmethod
    def forward(ctx, y, gates, tok2slot, slot2pair):
        ctx.save_for_backward(y, gates, tok2slot, slot2pair)
        ctx.rules = shard.capture()
        E, C, d = y.shape
        y = shard.constrain(y, None, None, "moe_embed")
        pairs = _masked_take(y.reshape(E * C, d), tok2slot, E * C)     # [T, K, d]
        pairs = shard.constrain(pairs, None, None, "moe_embed")
        return (pairs * gates[..., None].to(pairs.dtype)).sum(1)

    @staticmethod
    def backward(ctx, g):
        with ctx.rules():
            return _Combine._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        y, gates, tok2slot, slot2pair = ctx.saved_tensors
        E, C, d = y.shape
        T, K = gates.shape
        g = shard.constrain(g, None, "moe_embed")
        grad_pairs = g[:, None, :] * gates[..., None].to(g.dtype)      # [T, K, d]
        grad_pairs = shard.constrain(grad_pairs, None, None, "moe_embed")
        grad_y = _masked_take(grad_pairs.reshape(T * K, d), slot2pair, T * K)
        grad_y = shard.constrain(grad_y.reshape(E, C, d), None, None, "moe_embed")
        pairs = _masked_take(y.reshape(E * C, d), tok2slot, E * C)
        pairs = shard.constrain(pairs, None, None, "moe_embed")
        grad_gates = (pairs.to(g.dtype) * g[:, None, :]).sum(-1)
        return grad_y.to(y.dtype), grad_gates.to(gates.dtype), None, None


def moe_ffn(cfg: ModelConfig, pl: dict, x: torch.Tensor, *,
            dropless: bool = False):
    """x [B, S, d] -> (y [B, S, d], aux_loss 0-d f32).

    Token counts beyond cfg.moe_token_chunk (and a multiple of it) run in
    chunks of that many tokens, each with its own capacity; the aux loss
    is the chunks' mean."""
    B, S, d = x.shape
    T = B * S
    chunk = cfg.moe_token_chunk
    if chunk and T > chunk and T % chunk == 0:
        n = T // chunk
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        # DTensor unbinds no sharded dim: a sharded chunk axis is gathered
        for xg in shard.gather_dim(x.reshape(n, chunk, 1, d), 0):
            out_g, aux_g = _moe_ffn_inner(cfg, pl, xg, dropless=dropless)
            aux = aux + aux_g
            outs.append(out_g)
        return torch.stack(outs).reshape(B, S, d), aux / n
    return _moe_ffn_inner(cfg, pl, x, dropless=dropless)


def _moe_ffn_inner(cfg: ModelConfig, pl: dict, x: torch.Tensor, *,
                   dropless: bool = False):
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    probs, gates, eidx = route(cfg, pl["router"], xt)
    C = expert_capacity(T, cfg, dropless=dropless)
    tab = shard.replicated(dispatch_tables)(eidx, E, C)

    xt_sh = shard.constrain(xt, None, "moe_embed")
    buf = _Dispatch.apply(xt_sh, tab.slot2tok, tab.tok2slot)      # [E, C, d]
    buf = shard.constrain(buf, "expert", "capacity", None)        # all-to-all
    g = F.silu(torch.bmm(buf, pl["w_gate"]).float())
    u = torch.bmm(buf, pl["w_up"])
    h = g.to(x.dtype) * u
    h = shard.constrain(h, "expert", "capacity", "mlp")
    y = torch.bmm(h, pl["w_down"])                                # [E, C, d]
    y = shard.constrain(y, "expert", "capacity", None)            # local GEMM out
    y = shard.constrain(y, None, None, "moe_embed")               # all-to-all back

    out = _Combine.apply(y, gates.to(y.dtype), tab.tok2slot, tab.slot2pair)
    out = shard.constrain(out, None, "moe_embed").reshape(B, S, d)
    if cfg.n_shared_experts:
        sh = pl["shared"]
        out = out + swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = shard.replicated(_load_fractions)(eidx, tab.keep, tab.inv_order, E)
    aux = cfg.router_aux_coef * E * torch.sum(f * probs.mean(0))
    return out, aux


def _load_fractions(eidx: torch.Tensor, keep: torch.Tensor, inv_order: torch.Tensor,
                    n_experts: int) -> torch.Tensor:
    """[E] f32: the share of the T*K pairs each expert kept."""
    n = eidx.numel()
    kept = keep[inv_order].to(torch.float32)
    return torch.zeros(n_experts, dtype=torch.float32, device=eidx.device).scatter_add_(
        0, eidx.reshape(n), kept) / max(n, 1)


def moe_ffn_token(cfg: ModelConfig, pl: dict, x: torch.Tensor):
    """Decode-path MoE for [B, d] single tokens (wraps the batched path)."""
    y, aux = moe_ffn(cfg, pl, x[:, None, :], dropless=True)
    return y[:, 0, :], aux


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


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


def _mla_q(cfg, pl, x, positions):
    """x [..., d] -> q_nope [..., H, Dn], q_rope [..., H, Dr] (roped)."""
    Dn = cfg.qk_nope_dim
    cq = rmsnorm(x @ pl["w_q_a"], pl["q_norm"], cfg.rmsnorm_eps)
    q = dense._heads(cq, pl["w_q_b"])
    return q[..., :Dn], rope(q[..., Dn:], positions, cfg.rope_theta)


def _mla_latents(cfg, pl, x, positions):
    """x [..., d] -> c_kv (normed) [..., kr], k_rope (roped) [..., Dr]."""
    kr = cfg.kv_lora_rank
    kv = x @ pl["w_kv_a"]
    c_kv = rmsnorm(kv[..., :kr], pl["kv_norm"], cfg.rmsnorm_eps)
    # shared-across-heads rope: add a head axis of 1 for the helper
    k_rope = rope(kv[..., kr:][..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_attention_full(cfg: ModelConfig, pl: dict, x: torch.Tensor, *,
                       q_offset: int = 0, window: int = 0):
    """Full-sequence MLA.  Returns (y, c_kv, k_rope) for the latent cache."""
    B, S, _ = x.shape
    Dn = cfg.qk_nope_dim
    positions = (q_offset + torch.arange(S, device=x.device)).expand(B, S)
    q_nope, q_rope = _mla_q(cfg, pl, x, positions)
    c_kv, k_rope = _mla_latents(cfg, pl, x, positions)
    kv = dense._heads(c_kv, pl["w_kv_b"])
    o = attnlib.mla_full_attention(q_nope, q_rope, kv[..., :Dn], k_rope, kv[..., Dn:],
                                   causal=True, window=window)
    return dense._out_proj(o, pl["wo"]), c_kv, k_rope


def mla_attention_decode(cfg: ModelConfig, pl: dict, x: torch.Tensor,
                         c_kv_l: torch.Tensor, k_rope_l: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """One-token MLA over the latent cache (already holding this token).
    cfg.mla_absorb=False expands K/V from the latents each step; True
    attends in latent space (`attention.mla_decode_absorbed`)."""
    B = x.shape[0]
    Dn, Dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(cfg, pl, x[:, None], pos.expand(B, 1))
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]     # [B,H,*]
    scale = 1.0 / ((Dn + Dr) ** 0.5)

    c_kv_l = c_kv_l.to(x.dtype)
    k_rope_l = k_rope_l.to(x.dtype)
    w_kv_b = pl["w_kv_b"]                           # [kr, H, Dn + Dv]
    if cfg.mla_absorb:
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_kv_b[..., :Dn])
        o = attnlib.mla_decode_absorbed(q_lat, q_rope, c_kv_l, k_rope_l,
                                        w_kv_b[..., Dn:].permute(1, 0, 2), pos, scale)
    else:
        kv = dense._heads(c_kv_l, w_kv_b)           # [B, S, H, Dn + Dv]
        k_nope, value = kv[..., :Dn], kv[..., Dn:]
        s = torch.einsum("bhn,bshn->bhs", q_nope.float(), k_nope.float())
        s = s + torch.einsum("bhr,bsr->bhs", q_rope.float(), k_rope_l.float())
        s = s * scale
        valid = torch.arange(c_kv_l.shape[1], device=x.device) <= pos
        s = torch.where(valid, s, attnlib.NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bshv->bhv", w.to(value.dtype), value)
    return dense._out_proj(o, pl["wo"])


# ---------------------------------------------------------------------------
# Blocks / stacks
# ---------------------------------------------------------------------------


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


def _layers(cfg: ModelConfig, blocks: dict):
    """(layer params, is MoE) in cache order: the dense stack, then the MoE
    stack."""
    if cfg.n_dense_layers:
        for pl in unstack_layers(blocks["dense_blocks"]):
            yield pl, False
    for pl in unstack_layers(blocks["moe_blocks"]):
        yield pl, True


def _ffn(cfg, pl, x, moe: bool, *, dropless: bool = False):
    """The layer's FFN on x [B, S, d], or [B, d] for a decode token (always
    dropless): (y, aux loss or None)."""
    if not moe:
        mp = pl["mlp"]
        return swiglu(x, mp["w_gate"], mp["w_up"], mp["w_down"]), None
    if x.dim() == 2:
        return moe_ffn_token(cfg, pl["moe"], x)
    return moe_ffn(cfg, pl["moe"], x, dropless=dropless)


def forward_full(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                 window: int = 0, collect: bool = False,
                 dropless: bool = False):
    """Run both stacks over embeddings x [B, S, d].  Returns (hidden,
    aux_loss, caches): caches stacks the layers' (k, v), or (c_kv, k_rope)
    under MLA, dense layers first; None unless `collect`.  Each layer is
    recomputed in the backward pass when cfg.remat is on."""

    def body(h, aux, pl, moe):
        h = shard.constrain(h, "batch", "seq", None)
        xin = rmsnorm(h, pl["ln_attn"]["w"], cfg.rmsnorm_eps)
        if cfg.use_mla:
            a, *kv = mla_attention_full(cfg, pl["attn"], xin, window=window)
        else:
            a, *kv = dense.attention_full(cfg, pl["attn"], xin, window=window)
        h = h + a
        m, a_loss = _ffn(cfg, pl, rmsnorm(h, pl["ln_mlp"]["w"], cfg.rmsnorm_eps), moe,
                         dropless=dropless)
        if a_loss is not None:
            aux = aux + a_loss
        return h + m, aux, *kv

    body = maybe_remat(body, cfg.remat)
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for pl, moe in _layers(cfg, params["blocks"]):
        h, aux, *kv = body(h, aux, pl, moe)
        if collect:
            kvs.append(kv)
    if not collect:
        return h, aux, None
    return h, aux, tuple(torch.stack([kv[i] for kv in kvs]) for i in range(2))


# ---------------------------------------------------------------------------
# Registry API
# ---------------------------------------------------------------------------


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Cross-entropy + the routers' aux loss (+ 0.3 x the MTP head's loss,
    which predicts token t+2 from h_t and the embedding of t+1).  Pairs
    past an expert's capacity are dropped, as in the reference's training.
    Returns (loss, {"aux_loss", and "mtp_loss" with MTP})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_tokens(params["embed"], tokens)
    h, aux, _ = forward_full(cfg, params, x, window=cfg.window)
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    loss, _ = cross_entropy(logits, labels)
    metrics = {"aux_loss": aux}
    if cfg.mtp:
        mtp = params["mtp"]
        hm = rmsnorm(h[:, :-1], mtp["ln"]["w"], cfg.rmsnorm_eps)
        z = torch.cat([hm, embed_tokens(params["embed"], tokens[:, 1:])], dim=-1) @ mtp["proj"]
        mp = mtp["mlp"]
        z = z + swiglu(z, mp["w_gate"], mp["w_up"], mp["w_down"])
        mtp_logits = lm_logits(z, params["head"], cfg.vocab_size)
        mtp_loss, _ = cross_entropy(mtp_logits, labels[:, 1:])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    return loss + aux, metrics


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int, long_context: bool = False):
    tokens = batch["tokens"]
    S = tokens.shape[1]
    window = cfg.long_context_window if long_context else cfg.window
    x = embed_tokens(params["embed"], tokens)
    h, _, kv = forward_full(cfg, params, x, window=window, collect=True, dropless=True)
    h = rmsnorm(h[:, -1], params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    if not cfg.use_mla:
        return logits, dense._finish_cache(cfg, kv[0], kv[1], cache_len, window, S)
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt {S}")
    c_kv, k_rope = (cachelib.to_cache_dtype(a, cfg.kv_dtype) for a in kv)
    shape = c_kv.shape[:2] + (cache_len,)
    c, r = c_kv.new_zeros(shape + c_kv.shape[3:]), k_rope.new_zeros(shape + k_rope.shape[3:])
    c[:, :, :S] = c_kv
    r[:, :, :S] = k_rope
    # capture-safe: no host-to-card copy (see dense._finish_cache)
    return logits, cachelib.MLACache(c, r, torch.full((), S, dtype=torch.int32,
                                                      device=tokens.device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               long_context: bool = False, dtype=None, device):
    dtype = dtype or cfg.kv_dtype
    if cfg.use_mla:
        return cachelib.MLACache.init(cfg.n_layers, batch, cache_len, cfg.kv_lora_rank,
                                      cfg.qk_rope_dim, dtype, device)
    window = cfg.long_context_window if long_context else cfg.window
    if window:
        return cachelib.WindowKVCache.init(cfg.n_layers, batch, min(window, cache_len),
                                           cfg.n_kv_heads, cfg.head_dim_, dtype, device)
    return cachelib.KVCache.init(cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                                 cfg.head_dim_, dtype, device)


def decode_step(cfg: ModelConfig, params: dict, cache, batch: dict):
    """batch: {"token": [B] int32}.  Writes this token's K/V (or latents)
    into the cache in place at cache.pos and returns the cache with
    pos + 1 (same tensors)."""
    token = batch["token"]
    pos = cache.pos
    B = token.shape[0]
    h = embed_tokens(params["embed"], token)
    if cfg.use_mla:
        arrays = (cache.c_kv, cache.k_rope)
        slot = torch.clamp(pos, max=cache.c_kv.shape[2] - 1)
    else:
        arrays = (cache.k, cache.v)
        ring = isinstance(cache, cachelib.WindowKVCache)
        S = cache.k.shape[2]
        slot = torch.remainder(pos, S) if ring else torch.clamp(pos, max=S - 1)
    for i, (pl, moe) in enumerate(_layers(cfg, params["blocks"])):
        xin = rmsnorm(h, pl["ln_attn"]["w"], cfg.rmsnorm_eps)
        if cfg.use_mla:
            c_l, r_l = cache.c_kv[i], cache.k_rope[i]
            c_new, r_new = _mla_latents(cfg, pl["attn"], xin, pos.expand(B))
            cachelib.write_token(c_l, c_new, slot)
            cachelib.write_token(r_l, r_new, slot)
            a = mla_attention_decode(cfg, pl["attn"], xin, c_l, r_l, pos)
        else:
            a = dense.attention_decode(cfg, pl["attn"], xin, cache.k[i], cache.v[i], pos,
                                       slot, ring=ring)
        h = h + a
        m, _ = _ffn(cfg, pl, rmsnorm(h, pl["ln_mlp"]["w"], cfg.rmsnorm_eps), moe)
        h = h + m
    h = rmsnorm(h, params["final_norm"]["w"], cfg.rmsnorm_eps)
    logits = lm_logits(h, params["head"], cfg.vocab_size)
    return logits, type(cache)(*arrays, pos + 1)
