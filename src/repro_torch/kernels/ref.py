"""Sequential oracles for the kernels, in plain PyTorch.

Port of `repro.kernels.ref`: each function walks the sequence one step at
a time, as the reference's `lax.scan` does, with the reference's
signatures and casts.  They are the tests' and `chip_smoke.py`'s
independent check, through autograd, of the kernels' forward and
backward; no model path imports this module.

The reference casts its inputs to float32; here the cast is to at least
float32, which is the same for the bf16 and f32 inputs the reference can
take, and keeps float64 inputs (tests' gradient checks) in float64.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _f32(t: torch.Tensor) -> torch.Tensor:
    """The reference's `astype(float32)`, keeping float64 as it is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos) -> torch.Tensor:
    """Flash-decode oracle.  q [B,Hq,D]; k,v [B,S,Hkv,D]; entries with
    index > pos masked.  Returns [B,Hq,D] in q.dtype."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qg), _f32(k)) / (D ** 0.5)
    valid = torch.arange(S, device=q.device) <= torch.as_tensor(pos, device=q.device)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, _f32(v))
    return o.reshape(B, Hq, D).to(q.dtype)


def ssd_scan_ref(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, h0: torch.Tensor | None = None):
    """Sequential SSD oracle.

    xdt [b,s,h,p] (x*dt), dA [b,s,h] (dt*A, negative), B,C [b,s,h,n]
    (per head).  Returns (y [b,s,h,p] f32, final_state [b,h,p,n] f32).
    State recurrence: S_t = exp(dA_t)*S_{t-1} + B_t (x) xdt_t; y_t = C_t . S_t.
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    dtype = torch.promote_types(xdt.dtype, torch.float32)
    state = (torch.zeros((b, h, p, n), dtype=dtype, device=xdt.device)
             if h0 is None else _f32(h0))
    ys = []
    for t in range(s):
        decay = torch.exp(_f32(dA[:, t]))[:, :, None, None]
        upd = torch.einsum("bhp,bhn->bhpn", _f32(xdt[:, t]), _f32(B[:, t]))
        state = state * decay + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, _f32(C[:, t])))
    return torch.stack(ys, dim=1), state


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """Linear-recurrence oracle: h_t = a_t*h_{t-1} + b_t, h_0 given.
    a, b [B,S,W] f32.  Returns h [B,S,W] f32."""
    Bsz, S, W = a.shape
    h = (torch.zeros((Bsz, W), dtype=torch.promote_types(a.dtype, torch.float32),
                     device=a.device) if h0 is None else _f32(h0))
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
