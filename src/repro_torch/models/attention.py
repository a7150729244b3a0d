"""Attention primitives: chunked full-sequence attention (never materializes
the [S, S] score matrix for long sequences), single-token decode attention
over a cache, and DeepSeek-V3's multi-head latent attention (MLA).

Port of `repro.models.attention`.  Full attention and MLA are plain tensor
code, as XLA ran them in the reference.  Decode attention, the serving hot
spot, goes to kernel B1 (`repro_torch.kernels.decode_attention`) on CUDA
tensors and to its plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch import shard
from repro_torch.kernels import decode_attention as _decode_kernel

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(s / cap) * cap
    return s


def _f32_out(*operands) -> bool:
    """Whether a score product may multiply its operands in their own
    16-bit type into f32 (`torch.bmm(..., out_dtype=torch.float32)`), as the
    reference's `preferred_element_type=jnp.float32` does: CUDA tensors of
    one 16-bit type, with no gradient taken.  Otherwise the operands are
    cast to f32 first.  Under grad because `aten::bmm.dtype` has no
    derivative (a `torch.autograd.Function` around it would be needed); on
    the CPU because the overload has no CPU kernel.  bf16 x bf16 is exact in
    f32, so both give the same products, summed in another order."""
    a = operands[0]
    if shard.is_dtensor(a):      # DTensor has no sharding strategy for bmm.dtype
        return False
    return (a.is_cuda and a.dtype in (torch.bfloat16, torch.float16)
            and all(t.dtype == a.dtype for t in operands)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in operands)))


def _gqa_scores(q, k):
    """q [B,Cq,Hkv,G,D] . k [B,Sk,Hkv,D] -> f32 scores [B,Hkv,G,Cq,Sk]."""
    if shard.is_dtensor(q) or shard.is_dtensor(k):
        # on each device's shards, with this function's own arithmetic
        return shard.local_einsum("bqhgd,bkhd->bhgqk", (q, k), _gqa_scores)
    if _f32_out(q, k):
        # 16-bit operands, f32 output: on the card, no gradient taken
        B, Cq, Hkv, G, D = q.shape
        Sk = k.shape[1]
        s = torch.bmm(q.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * Cq, D),
                      k.permute(0, 2, 3, 1).reshape(B * Hkv, D, Sk), out_dtype=torch.float32)
        return s.reshape(B, Hkv, G, Cq, Sk)
    # under grad or on the CPU: f32 operands (see `_f32_out`)
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _attend_block(q, k, v, mask, scale, softcap):
    """One (q-chunk × full-K) attention block.
    q [B,Cq,Hkv,G,D]; k,v [B,Sk,Hkv,D]; mask [Cq,Sk]."""
    s = _gqa_scores(q, k) * scale
    s = _softcap(s, softcap)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v).to(q.dtype)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    chunk_q: int = 512,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Full-sequence attention.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] (Hq % Hkv == 0).
    Returns [B, Sq, Hq, D].  When Sq > chunk_q and divisible, loops over
    query chunks so peak score memory is [B, Hq, chunk_q, Sk].
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Sq, Hkv, G, D)
    qg = shard.constrain(qg, "batch", "seq", "kv_heads", None, None)
    k = shard.constrain(k, "batch", "seq", "kv_heads", None)
    v = shard.constrain(v, "batch", "seq", "kv_heads", None)
    k_pos = torch.arange(Sk, device=q.device)

    def mask_for(q_pos):
        m = torch.ones((len(q_pos), Sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= k_pos[None, :] <= q_pos[:, None]
        if window and window > 0:
            m &= k_pos[None, :] > q_pos[:, None] - window
        return m

    if Sq <= chunk_q or Sq % chunk_q != 0:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        out = _attend_block(qg, k, v, mask_for(q_pos), scale, softcap)
        return out.reshape(B, Sq, Hq, D)

    outs = []
    for i in range(Sq // chunk_q):
        q_pos = q_offset + i * chunk_q + torch.arange(chunk_q, device=q.device)
        q_chunk = qg[:, i * chunk_q:(i + 1) * chunk_q]
        outs.append(_attend_block(q_chunk, k, v, mask_for(q_pos), scale, softcap))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,
    *,
    ring: bool = False,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One-token attention over a cache.

    q: [B, Hq, D]; k_cache, v_cache: [B, S, Hkv, D]; pos: 0-d int32 tensor —
    absolute position of the current token (already written into the cache).

    ring=False: entries with index > pos are masked (cache longer than
    generated prefix).  ring=True: sliding-window ring buffer — every slot
    is valid once pos+1 >= S, else slots > pos are masked.
    """
    if shard.is_dtensor(k_cache):
        k_cache = shard.constrain(k_cache, "batch", "kv_seq", "kv_heads", None)
        v_cache = shard.constrain(v_cache, "batch", "kv_seq", "kv_heads", None)
        return _decode_attention_sharded(q, k_cache, v_cache, pos, ring=ring,
                                         softcap=softcap)
    return _decode_kernel.decode_attention(q, k_cache, v_cache, pos, ring=ring,
                                           softcap=softcap)


def _decode_attention_sharded(q, k_cache, v_cache, pos, *, ring, softcap):
    """decode_attention over DTensor caches: B1 on each device's shard
    (`shard.local_call`, the pattern of DTensor's `local_map`), q laid out
    as the cache's batch and heads are.  Where the cache's sequence is
    sharded (the decode rules' flash-decode layout), each shard attends over its own keys (a shard starting at s0
    sees position pos - s0; one wholly past pos gives nothing, its LSE
    -inf) and the shards' outputs are merged by their log-sum-exps: an
    all-reduce of the max, then of the rescaled sums, over the mesh dims
    that shard S.  The ring rule keeps the keys idx <= pos for every
    pos >= 0, so on a shard it is applied with global indices by the
    same clamp."""
    import torch.distributed._functional_collectives as funcol

    mesh = k_cache.device_mesh
    cache_pl = tuple(k_cache.placements)
    q_pl = shard.moved(cache_pl, {0: 0, 2: 1})        # [B,S,Hkv,D] -> [B,Hq,D]
    s_dims = shard.mesh_dims_of(k_cache, 1)
    s0, s_len = shard.shard_offset(k_cache, 1)
    pos_pl = tuple(pos.placements) if shard.is_dtensor(pos) else None

    def local(q_l, k_l, v_l, pos_l):
        if not s_dims:
            return _decode_kernel.decode_attention(q_l.contiguous(), k_l, v_l, pos_l,
                                                   ring=ring, softcap=softcap)
        p = pos_l - s0
        o, lse = _decode_kernel.decode_attention(
            q_l.contiguous(), k_l, v_l, p.clamp(0, s_len - 1), softcap=softcap, lse=True)
        lse = torch.where(p >= 0, lse, -torch.inf)
        m = lse
        for d in s_dims:
            m = funcol.all_reduce(m, "max", (mesh, d))
        w = torch.exp(lse - m)
        num = o.float() * w[..., None]
        for d in s_dims:
            num = funcol.all_reduce(num, "sum", (mesh, d))
            w = funcol.all_reduce(w, "sum", (mesh, d))
        return (num / w[..., None]).to(q_l.dtype)

    return shard.local_call(local, mesh, (q, k_cache, v_cache, pos),
                            (q_pl, cache_pl, cache_pl, pos_pl), [q_pl])


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3)
# ---------------------------------------------------------------------------


def mla_full_attention(
    q_nope: torch.Tensor,   # [B,S,H,Dn]
    q_rope: torch.Tensor,   # [B,S,H,Dr]
    k_nope: torch.Tensor,   # [B,S,H,Dn]
    k_rope: torch.Tensor,   # [B,S,Dr] (shared across heads)
    value: torch.Tensor,    # [B,S,H,Dv]
    *,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 512,
) -> torch.Tensor:
    """Full-sequence MLA attention (decoupled rope scores).  Scores in f32,
    as the reference's `preferred_element_type`.  Returns [B,S,H,Dv]."""
    B, Sq, H, Dn = q_nope.shape
    Dr = q_rope.shape[-1]
    Sk = k_nope.shape[1]
    scale = 1.0 / ((Dn + Dr) ** 0.5)
    k_pos = torch.arange(Sk, device=q_nope.device)

    def block(q_n, q_r, q_pos):
        if _f32_out(q_n, k_nope, q_r, k_rope):
            # 16-bit operands, f32 output: on the card, no gradient taken
            Cq = q_n.shape[1]
            s = torch.bmm(q_n.permute(0, 2, 1, 3).reshape(B * H, Cq, Dn),
                          k_nope.permute(0, 2, 3, 1).reshape(B * H, Dn, Sk),
                          out_dtype=torch.float32).reshape(B, H, Cq, Sk)
            s = s + torch.bmm(q_r.permute(0, 2, 1, 3).reshape(B, H * Cq, Dr),
                              k_rope.transpose(1, 2), out_dtype=torch.float32
                              ).reshape(B, H, Cq, Sk)
        else:
            # under grad or on the CPU: f32 operands (see `_f32_out`)
            s = torch.einsum("bqhd,bkhd->bhqk", q_n.float(), k_nope.float())
            s = s + torch.einsum("bqhr,bkr->bhqk", q_r.float(), k_rope.float())
        s = s * scale
        m = torch.ones((q_n.shape[1], Sk), dtype=torch.bool, device=q_n.device)
        if causal:
            m &= k_pos[None, :] <= q_pos[:, None]
        if window:
            m &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(m, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(value.dtype), value)

    if Sq <= chunk_q or Sq % chunk_q != 0:
        return block(q_nope, q_rope, torch.arange(Sq, device=q_nope.device))
    outs = []
    for i in range(Sq // chunk_q):
        sl = slice(i * chunk_q, (i + 1) * chunk_q)
        outs.append(block(q_nope[:, sl], q_rope[:, sl],
                          i * chunk_q + torch.arange(chunk_q, device=q_nope.device)))
    return torch.cat(outs, dim=1)


def mla_decode_absorbed(
    q_latent: torch.Tensor,  # [B,H,Ckv]  (q_nope absorbed through W_uk)
    q_rope: torch.Tensor,    # [B,H,Dr]
    c_kv: torch.Tensor,      # [B,S,Ckv]  latent cache (already rms-normed)
    k_rope: torch.Tensor,    # [B,S,Dr]
    w_uv: torch.Tensor,      # [H,Ckv,Dv] (up-projection for V)
    pos: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Absorbed-matmul MLA decode: scores and values computed in latent
    space, O(S·Ckv) cache traffic instead of O(S·H·Dn) expansion.
    Returns [B, H, Dv]."""
    c_kv = c_kv.to(q_latent.dtype)
    k_rope = k_rope.to(q_rope.dtype)
    if _f32_out(q_latent, c_kv, q_rope, k_rope):
        # 16-bit operands, f32 output: on the card, no gradient taken
        s = torch.bmm(q_latent, c_kv.transpose(1, 2), out_dtype=torch.float32)
        s = s + torch.bmm(q_rope, k_rope.transpose(1, 2), out_dtype=torch.float32)
    else:
        # under grad or on the CPU: f32 operands (see `_f32_out`)
        s = torch.einsum("bhc,bkc->bhk", q_latent.float(), c_kv.float())
        s = s + torch.einsum("bhr,bkr->bhk", q_rope.float(), k_rope.float())
    s = s * scale
    valid = torch.arange(c_kv.shape[1], device=c_kv.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_latent = torch.einsum("bhk,bkc->bhc", w.to(c_kv.dtype), c_kv)
    return torch.einsum("bhc,hcd->bhd", o_latent, w_uv)
