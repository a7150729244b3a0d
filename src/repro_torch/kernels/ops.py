"""The reference's public kernel names over the port's wrappers.

Port of `repro.kernels.ops`, call for call: `decode_attention` (B1),
`ssd` (B3) and `rglru` (B4).  Each runs its CUDA kernel on CUDA tensors
and its plain PyTorch version on CPU tensors (the wrappers in this
package decide by the tensors' device).  The block sizes of the Pallas
kernels are accepted and ignored: the port's kernels pick their own tiles
from the shapes.  `interpret=True`, the reference's way to run a kernel
without its chip, has no counterpart here and raises: pass CPU tensors
instead.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _kda
from repro_torch.kernels import rglru_scan as _krg
from repro_torch.kernels import ssd_scan as _kss


def _no_interpret(interpret: bool) -> None:
    if interpret:
        raise ValueError("interpret=True has no counterpart in the port: pass "
                         "device=\"cpu\" tensors to run the plain PyTorch version")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                     block_s: int = 512, interpret: bool = False) -> torch.Tensor:
    """Flash-decode GQA: q [B,Hq,D]; k,v [B,S,Hkv,D]; pos scalar (keys
    with index <= pos attend).  Returns [B,Hq,D] in q's dtype."""
    _no_interpret(interpret)
    return _kda.decode_attention(q, k, v, pos)


def ssd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
        chunk: int = 128, interpret: bool = False):
    """Mamba-2 SSD chunk scan.  xdt [b,s,h,p]; dA [b,s,h]; B, C [b,s,h,n]
    per head, as the reference takes them.  Returns (y in xdt's dtype,
    final_state [b,h,p,n] f32)."""
    _no_interpret(interpret)
    return _kss.ssd_scan(xdt, dA, B, C, chunk=chunk)


def rglru(a: torch.Tensor, b: torch.Tensor, *, block_s: int = 256,
          block_w: int = 512, interpret: bool = False) -> torch.Tensor:
    """RG-LRU recurrence h_t = a_t h_{t-1} + b_t over a, b [B,S,W] f32.
    Returns h [B,S,W] f32."""
    _no_interpret(interpret)
    return _krg.rglru_scan(a, b)[0]
