"""Attention primitives: chunked full-sequence attention (never materializes
the [S, S] score matrix for long sequences) and single-token decode
attention over a cache.

Port of `repro.models.attention`.  Full attention is plain tensor code, as
XLA ran it in the reference.  Decode attention, the serving hot spot, goes
to kernel B1 (`repro_torch.kernels.decode_attention`) on CUDA tensors and
to its plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode_kernel

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(s / cap) * cap
    return s


def _attend_block(q, k, v, mask, scale, softcap):
    """One (q-chunk × full-K) attention block.
    q [B,Cq,Hkv,G,D]; k,v [B,Sk,Hkv,D]; mask [Cq,Sk]."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
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
    return _decode_kernel.decode_attention(q, k_cache, v_cache, pos, ring=ring,
                                           softcap=softcap)
