"""RG-LRU linear recurrence (kernel B4): h_t = a_t * h_{t-1} + b_t per
channel, over a whole sequence.

Replaces the TPU kernel `repro.kernels.rglru_scan.rglru_scan_pallas` with
the hand-written CUDA kernel in `csrc/rglru_scan.cu` (see the note there
for its bound and design), and computes the recurrence of the model path
`repro.models.hybrid.rglru_scan` after `_lru_coeffs`: any S and W (the
Pallas kernel needs block multiples) and an initial state `h0`, folded
in as the reference folds it.

The kernel is a one-pass segmented scan: a block takes 32 channels of
one batch row and splits the sequence into `nseg` segments of `seg_len`
steps; each thread loads its whole segment before using any of it,
composes the segment's affine map, scans the maps of the segments before
it through shared memory, and replays its segment with that carry-in.
`plan` picks the split from the shape; `segmented_scan_emulated` in
tests/test_torch_scan_kernels.py follows the same split on the CPU.

The backward kernel in the same source walks the adjoint recurrence
g_t = dh_t + a_{t+1} g_{t+1} in reverse with the same split, and reads the
saved h one step back for da_t = g_t h_{t-1}; `_RGLRUScan` wraps the two
kernels as one `torch.autograd.Function`.

`rglru_scan` is the one entry point.  For CPU tensors it runs
`rglru_scan_plain`, the same function in plain PyTorch, which autograd
differentiates; for CUDA tensors it launches the kernel (through
`_RGLRUScan` when an input needs a gradient) or raises, and never falls
back.  Fake tensors (a dry run's) take the plain version: the
outputs' shapes without a launch, its FLOPs counted.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

# Launches of the forward and the backward kernel since the last reset; a
# run sets them to 0 and reads them to show that it went through B4.
launches = 0
bwd_launches = 0

ROW_CHANNELS = 32    # channels a block covers: 128 bytes of a row (csrc kRowChannels)
SEG_LEN = 8          # steps a thread holds in registers (csrc kMaxLen)
MAX_THREADS = 256    # threads a block


def plan(S: int, W: int, aligned: bool = True) -> tuple[int, int, int]:
    """(vec, nseg, seg_len) of the kernel for sequence length S and width
    W: 4 channels a thread (float4) when W % 4 == 0 and the tensors start
    on 16-byte boundaries, else 1; segments of up to SEG_LEN steps, as many
    as S needs up to the block's threads, so a longer sequence is walked in
    tiles of nseg * seg_len steps with the state carried over.  At
    recurrentgemma-9b's serve shapes (S <= 256) one tile covers S and every
    load of a and b is in flight at once.  Longer segments make a shorter
    scan of the maps; 8 steps keep a thread's a and b in 64 registers."""
    vec = 4 if aligned and W % 4 == 0 else 1
    nseg = min(MAX_THREADS * vec // ROW_CHANNELS, -(-S // SEG_LEN))
    return vec, nseg, min(SEG_LEN, -(-S // nseg))


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor | None = None):
    """The recurrence in plain PyTorch: a doubling (Hillis-Steele) scan of
    the affine maps (a_t, b_t), log2(S) whole-tensor steps, as the Pallas
    kernel does within a block.  a, b [B,S,W]; h0 [B,W] or None.
    Returns (h [B,S,W] f32, h_last [B,W] f32); float64 inputs stay
    float64."""
    dtype = torch.promote_types(a.dtype, torch.float32)
    a = a.to(dtype)
    b = b.to(dtype)
    if h0 is not None:
        # fold the initial state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(dtype)[:, None], b[:, 1:]], dim=1)
    n = 1
    while n < a.shape[1]:
        b = torch.cat([b[:, :n], a[:, n:] * b[:, :-n] + b[:, n:]], dim=1)
        a = torch.cat([a[:, :n], a[:, n:] * a[:, :-n]], dim=1)
        n *= 2
    return b, b[:, -1]


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None):
    """`rglru_scan_plain`'s function: the plain version on CPU tensors, the
    CUDA kernels on CUDA tensors, the backward kernel carrying the
    gradients of a, b and h0 when one of them needs one."""
    if a.dim() != 3 or b.shape != a.shape or a.shape[1] < 1:
        raise ValueError(f"want a, b [B,S,W] of one shape; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    Bsz, _, W = a.shape
    if h0 is not None and tuple(h0.shape) != (Bsz, W):
        raise ValueError(f"h0 must be [B,W] = {(Bsz, W)}; got {tuple(h0.shape)}")
    tensors = [a, b] + ([] if h0 is None else [h0])
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")} or any(isinstance(t, FakeTensor) for t in tensors):
        return rglru_scan_plain(a, b, h0)
    if len(devices) != 1 or a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CPU or CUDA tensors on one device; "
                         f"got {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _RGLRUScan.apply(a, b, h0)
    return _launch(a, b, h0)


class _RGLRUScan(torch.autograd.Function):
    """B4 forward and backward.  The forward saves a, h and h0; the
    backward takes dh and dh_last (None, the loss not reaching h_last in
    training, counts as zeros) and returns da, db and dh0 in f32."""

    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.set_materialize_grads(False)
        h, h_last = _launch(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        if dh is None and dh_last is None:
            return None, None, None
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        want_h0 = h0 is not None and ctx.needs_input_grad[2]
        return _launch_bwd(a, h, h0, dh, dh_last, want_h0)


@functools.cache
def _kernel():
    fn = _build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, b, h0):
    global launches
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the RG-LRU kernel takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Bsz, S, W = a.shape
    fn = _kernel()
    h = torch.empty_like(a)
    h_last = torch.empty((Bsz, W), dtype=torch.float32, device=a.device)
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (a, b, h0, h, h_last))
    vec, nseg, seg_len = plan(S, W, aligned)
    err = fn(a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
             h.data_ptr(), h_last.data_ptr(), Bsz, S, W, vec, nseg, seg_len,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError_t {err}")
    launches += 1
    return h, h_last


@functools.cache
def _bwd_kernel():
    fn = _build.load("rglru_scan").rglru_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(a, h, h0, dh, dh_last, want_h0):
    """The backward kernel: (da, db, dh0 or None), all f32."""
    global bwd_launches
    for name, t in (("a", a), ("h", h), ("h0", h0), ("dh", dh), ("dh_last", dh_last)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the RG-LRU backward takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Bsz, S, W = a.shape
    fn = _bwd_kernel()
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = torch.empty((Bsz, W), dtype=torch.float32, device=a.device) if want_h0 else None
    aligned = all(t is None or t.data_ptr() % 16 == 0
                  for t in (a, h, h0, dh, dh_last, da, db, dh0))
    vec, nseg, seg_len = plan(S, W, aligned)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(a.data_ptr(), h.data_ptr(), ptr(h0), dh.data_ptr(), ptr(dh_last),
             da.data_ptr(), db.data_ptr(), ptr(dh0), Bsz, S, W, vec, nseg, seg_len,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan backward kernel launch failed: cudaError_t {err}")
    bwd_launches += 1
    return da, db, dh0
