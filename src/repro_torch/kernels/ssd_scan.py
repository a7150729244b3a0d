"""Mamba-2 SSD chunk scan (kernel B3): the state-space recurrence

    S_t = exp(dA_t) * S_{t-1} + xdt_t (x) B_t,     y_t = S_t . C_t

over a whole sequence, chunked: quadratic within a chunk, linear across
chunks.

Replaces the TPU kernel `repro.kernels.ssd_scan.ssd_scan` with the
hand-written CUDA kernels in `csrc/ssd_scan.cu` (see the note there for
their bound and design), and computes what the model path
`repro.models.ssm.ssd_chunked` computes, without its limits: any S (the
last chunk may be shorter) and an initial state `h0`.  B and C come per
group, [b, s, g, n], and head h reads group h // (H/G); the reference
broadcasts them to heads first.

The library holds two kernels, one per input type.  bf16, the models'
type, runs the chunk products on the tensor cores (`mma.sync` bf16 ->
f32, 64-step chunks), rounding to bf16 where this module's plain version
and the reference round: the decay-masked scores, the state that enters a
chunk, and the decay-weighted inputs of the state update.  f32 runs them
in scalar f32 (32-step chunks): TF32 products would miss the f32 gate.

The backward (`ssd_scan_bwd_launch`, two kernels over one template, f32
sums) differentiates the unrounded chunked form in 32-step chunks.  A
states kernel carries each chunk's entering state forward and the adjoint
of its leaving state back, adding each chunk's increment as one
tensor-core product; a chunk kernel then takes every chunk in parallel,
looping over the heads of a group, and computes dx, ddA and the group's dB
and dC (summed over its heads on chip, in head order) with every product
on the tensor cores.  f32 operands (f32 inputs, the states, the decay-
weighted ones) go in as bf16 hi and lo planes.  What bounds it is bytes
(85.5 MB in and out at mamba2-130m's training shape, 0.0255 ms on an
H100); the note in the source gives what still holds it back.  `_SSDScan`
wraps forward and backward as one `torch.autograd.Function`.

`ssd_scan` is the one entry point.  For CPU tensors it runs
`ssd_scan_plain`, the port of `ssd_chunked` in plain PyTorch, which
autograd differentiates; for CUDA tensors it launches the kernel of the
input type (through `_SSDScan` when an input needs a gradient) or raises,
and never falls back.  Fake tensors (a dry run's) take the plain
version: the outputs' shapes without a launch, its FLOPs counted.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

# Launches of the forward and the backward kernels since the last reset; a
# run sets them to 0 and reads them to show that it went through B3.
launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
P_TILE = 16          # head-dim rows of the state per block (csrc kPT)
MAX_STATE = 256      # largest state size N the kernels take
N_STEP = 16          # bf16: the state size is a multiple of the mma depth
CHUNK = {torch.float32: 32, torch.bfloat16: 64}   # the kernels' chunk lengths
BWD_CHUNK = 32       # the backward's chunk length (csrc kBQ)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> lower-triangular segment sums [..., T, T]:
    out[..., i, j] = sum(x[..., j+1 : i+1]) for i >= j, -inf above."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, -torch.inf)


def ssd_scan_plain(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None):
    """Chunked SSD in plain PyTorch: the reference's `ssd_chunked`, with
    its casts, for any S.

    xdt [b,s,h,p] (x pre-multiplied by dt), dA [b,s,h] (dt * A, negative),
    B, C [b,s,g,n] with h % g == 0, h0 [b,h,p,n] or None.  The sequence is
    zero-padded to a whole number of chunks (dA = 0, B = x = 0 leave the
    state as it is) and y cut back to s.
    Returns (y [b,s,h,p] in xdt's dtype, final_state [b,h,p,n] f32); the
    f32 casts keep float64 inputs in float64."""
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    B = B.repeat_interleave(h // g, dim=2)
    C = C.repeat_interleave(h // g, dim=2)
    cl = min(chunk, s)
    nc = math.ceil(s / cl)
    pad = nc * cl - s
    if pad:
        xdt, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xdt, B, C))
        dA = F.pad(dA, (0, 0, 0, pad))

    f32 = torch.promote_types(xdt.dtype, torch.float32)
    xdt_c = xdt.reshape(b, nc, cl, h, p)
    dA_c = dA.reshape(b, nc, cl, h).to(f32)
    B_c = B.reshape(b, nc, cl, h, n)
    C_c = C.reshape(b, nc, cl, h, n)

    dA_cs = torch.cumsum(dA_c, dim=2)                         # [b,nc,cl,h]
    # intra-chunk (quadratic) term
    Lmat = torch.exp(_segsum(dA_c.permute(0, 1, 3, 2)))      # [b,nc,h,cl,cl]
    scores = torch.einsum("bclhn,bcshn->bchls", C_c.to(f32), B_c.to(f32))
    scores = scores * Lmat
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores.to(xdt.dtype), xdt_c)

    # per-chunk input states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # [b,nc,cl,h]
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", B_c,
                          decay_states.to(B_c.dtype), xdt_c)

    # inter-chunk linear recurrence
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # [b,nc,h]
    state = (torch.zeros((b, h, p, n), dtype=f32, device=xdt.device)
             if h0 is None else h0.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c].to(f32)
    prev_states = torch.stack(prev, dim=1)                    # [b,nc,h,p,n]

    state_decay = torch.exp(dA_cs)                            # [b,nc,cl,h]
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", C_c,
                         prev_states.to(C_c.dtype), state_decay.to(C_c.dtype))
    y = (y_diag + y_off).reshape(b, nc * cl, h, p)[:, :s]
    return y, state


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None):
    """`ssd_scan_plain`'s function: the plain version on CPU tensors, the
    CUDA kernels on CUDA tensors, the backward kernel carrying the
    gradients of every input when one of them needs one.  `chunk` is the
    plain version's chunk length (the config's `ssm_chunk`); the kernels
    walk the sequence in chunks of their own (`CHUNK`, `BWD_CHUNK`), which
    changes only the rounding order: the chunked form is exact for any
    chunk length."""
    if xdt.dim() != 4 or dA.dim() != 3 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"want xdt [b,s,h,p], dA [b,s,h], B/C [b,s,g,n]; got "
                         f"{tuple(xdt.shape)}, {tuple(dA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(dA.shape) != (b, s, h) or tuple(B.shape[:2]) != (b, s) or h % g
            or s < 1 or (h0 is not None and tuple(h0.shape) != (b, h, p, n))):
        raise ValueError(f"shapes do not fit: xdt {tuple(xdt.shape)}, dA "
                         f"{tuple(dA.shape)}, B/C {tuple(B.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    tensors = [xdt, dA, B, C] + ([] if h0 is None else [h0])
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")} or any(isinstance(t, FakeTensor) for t in tensors):
        return ssd_scan_plain(xdt, dA, B, C, chunk=chunk, h0=h0)
    if len(devices) != 1 or xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CPU or CUDA tensors on one device; "
                         f"got {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _SSDScan.apply(xdt, dA, B, C, h0)
    return _launch(xdt, dA, B, C, h0)


class _SSDScan(torch.autograd.Function):
    """B3 forward and backward.  The forward saves its inputs (the
    backward recomputes the chunk states from them); the backward takes dy
    and d_final (None, the loss not reaching the final state in training,
    counts as zeros) and returns dxdt, dB and dC (per group) in the
    inputs' type, ddA and dh0 in f32."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C, h0):
        ctx.set_materialize_grads(False)
        y, final = _launch(xdt, dA, B, C, h0)
        ctx.save_for_backward(xdt, dA, B, C, h0)
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        xdt, dA, B, C, h0 = ctx.saved_tensors
        if dy is None and d_final is None:
            return None, None, None, None, None
        dy = torch.zeros_like(xdt) if dy is None else dy.to(xdt.dtype).contiguous()
        if dy.data_ptr() % 16:      # a view off the kernel's 16-byte pieces
            dy = dy.clone()
        if d_final is not None:
            d_final = d_final.contiguous()
        want_h0 = h0 is not None and ctx.needs_input_grad[4]
        return _launch_bwd(xdt, dA, B, C, h0, dy, d_final, want_h0)


@functools.cache
def _kernel():
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xdt, dA, B, C, h0):
    """Launch the kernel of xdt's type: a dispatch between the library's
    two hand-written kernels (bf16 on the tensor cores, f32 in scalar
    f32), not a fallback; both count in `launches`."""
    global launches
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    if xdt.dtype not in _DTYPE_CODES or B.dtype != xdt.dtype or C.dtype != xdt.dtype:
        raise TypeError(f"the SSD kernel takes xdt, B and C in one of float32 or "
                        f"bfloat16; got {xdt.dtype}, {B.dtype}, {C.dtype}")
    if dA.dtype != torch.float32 or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("the SSD kernel takes dA and h0 in float32")
    if p % P_TILE or n > MAX_STATE:
        raise ValueError(f"the SSD kernel takes head dims that are multiples of "
                         f"{P_TILE} and states up to {MAX_STATE}; got p={p}, n={n}")
    if xdt.dtype == torch.bfloat16 and n % N_STEP:
        raise ValueError(f"the bf16 SSD kernel takes state sizes that are multiples "
                         f"of {N_STEP}; got n={n}")
    for name, t in (("xdt", xdt), ("dA", dA), ("B", B), ("C", C), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if (xdt.dtype == torch.bfloat16 and name != "dA" and t is not None
                and t.data_ptr() % 16):
            raise ValueError(f"the bf16 SSD kernel reads xdt, B, C and h0 in wide "
                             f"pieces: {name} must start on a 16-byte boundary")
    fn = _kernel()
    y = torch.empty_like(xdt)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=xdt.device)
    err = fn(
        xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), final.data_ptr(),
        _DTYPE_CODES[xdt.dtype], b, s, h, p, g, n,
        torch.cuda.current_stream(xdt.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t {err}")
    launches += 1
    return y, final


@functools.cache
def _bwd_kernel():
    fn = _build.load("ssd_scan").ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(xdt, dA, B, C, h0, dy, d_final, want_h0):
    """The backward kernels: (dxdt, ddA, dB, dC, dh0 or None).  Scratch
    (each chunk's entering state and outgoing adjoint, as bf16 hi and lo
    planes of the f32 state, n padded to a multiple of 16) is allocated
    here and freed on return."""
    global bwd_launches
    b, s, h, p = xdt.shape
    g, n = B.shape[2], B.shape[3]
    if xdt.dtype not in _DTYPE_CODES or any(t.dtype != xdt.dtype for t in (B, C, dy)):
        raise TypeError(f"the SSD backward takes xdt, B, C and dy in one of float32 or "
                        f"bfloat16; got {xdt.dtype}, {B.dtype}, {C.dtype}, {dy.dtype}")
    if any(t is not None and t.dtype != torch.float32 for t in (dA, h0, d_final)):
        raise TypeError("the SSD backward takes dA, h0 and d_final in float32")
    if p % P_TILE or n > MAX_STATE:
        raise ValueError(f"the SSD backward takes head dims that are multiples of "
                         f"{P_TILE} and states up to {MAX_STATE}; got p={p}, n={n}")
    if xdt.dtype == torch.bfloat16 and n % N_STEP:
        raise ValueError(f"the bf16 SSD backward takes state sizes that are multiples "
                         f"of {N_STEP}; got n={n}")
    for name, t in (("xdt", xdt), ("dA", dA), ("B", B), ("C", C), ("h0", h0), ("dy", dy),
                    ("d_final", d_final)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if (xdt.dtype == torch.bfloat16 and name in ("xdt", "B", "C", "dy")
                and t.data_ptr() % 16):
            raise ValueError(f"the bf16 SSD backward reads xdt, B, C and dy in wide "
                             f"pieces: {name} must start on a 16-byte boundary")
    fn = _bwd_kernel()
    f32, dev = torch.float32, xdt.device
    nc, n_pad = -(-s // BWD_CHUNK), -(-n // N_STEP) * N_STEP
    dxdt, dB, dC = torch.empty_like(xdt), torch.empty_like(B), torch.empty_like(C)
    ddA = torch.empty((b, s, h), dtype=f32, device=dev)
    dh0 = torch.empty((b, h, p, n), dtype=f32, device=dev) if want_h0 else None
    states = torch.empty((2, b, h, nc, 2, p, n_pad), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(), ptr(h0),
             dy.data_ptr(), ptr(d_final), dxdt.data_ptr(), ddA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), ptr(dh0), states[0].data_ptr(), states[1].data_ptr(),
             _DTYPE_CODES[xdt.dtype], b, s, h, p, g, n,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dxdt, ddA, dB, dC, dh0
