"""Flash-decode GQA attention (kernel B1): one new query token per sequence
attends over a KV cache.

Replaces the TPU kernel `repro.kernels.decode_attention.flash_decode_gqa`
with the hand-written CUDA kernel in `csrc/decode_attention.cu` (see the
note there for its bound and design), and computes what the model path
`repro.models.attention.decode_attention` needs: any S, softcap, the
ring-buffer rule and fp8 e4m3 caches (computed in q's dtype).

`decode_attention` is the one entry point.  For CPU tensors it runs
`decode_attention_plain`, the same function in plain PyTorch; for CUDA
tensors it launches the kernel or raises, and never falls back.  Fake
tensors (the dry run's, which hold no data) go through the plain version
too: it gives the outputs' shapes and dtypes without a launch,
and its ops are the FLOPs a trace counts for the kernel.

With `lse=True` both also return each query row's log-sum-exp of its
scores over the valid keys, [B, Hq] f32: what merging the outputs of
sequence shards needs (`models.attention` does so when the cache is
sharded along S).  The kernel writes it only when asked.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

NEG_INF = -1e30

# Launches of the CUDA kernel through `decode_attention` since the last
# reset; a run sets it to 0 and reads it to show that it went through B1.
launches = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, cache dtype) pairs the kernel takes; fp8 caches compute in q's
# dtype, as the reference upcasts them.
_PAIRS = {(torch.float32, torch.float32), (torch.float32, torch.float8_e4m3fn),
          (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float8_e4m3fn)}
_HEAD_DIMS = (32, 64, 128, 256)
_HEADS_PER_BLOCK = {torch.float32: 8, torch.bfloat16: 16}   # kF32Heads, kMmaHeads
_MAX_SPLITS = 256              # kMaxSplits
_MIN_KEYS = 128                # kMinKeys: fewest keys a split takes
# Bytes a second the block merging the splits reads from L2, over the bytes
# a second a split's block reads from device memory (see `plan`).
_MERGE_RATIO = 2.0


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos, *, ring: bool = False,
                           softcap: float = 0.0, lse: bool = False):
    """One-token attention over a cache, in plain PyTorch.

    q: [B, Hq, D]; k_cache, v_cache: [B, S, Hkv, D]; pos: absolute position
    of the current token (already written into the cache).
    ring=False: entries with index > pos are masked.  ring=True: sliding-
    window ring buffer, every slot valid once pos+1 >= S, else slots > pos
    masked.  Returns [B, Hq, D] in q's dtype, and with lse=True also the
    rows' log-sum-exp of the masked scores, [B, Hq] f32."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, G, D)
    k = k_cache.to(q.dtype)
    v = v_cache.to(q.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    if not isinstance(pos, torch.Tensor):
        _refuse_int_pos_in_capture()
    pos = torch.as_tensor(pos, device=q.device)
    valid = torch.arange(S, device=q.device) <= pos
    if ring:
        valid = valid | (pos >= S - 1)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w.to(v.dtype), v).reshape(B, Hq, D)
    if lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, Hq)
    return o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, ring: bool = False,
                     softcap: float = 0.0, lse: bool = False):
    """`decode_attention_plain`'s function: the plain version on CPU
    tensors (and on fake ones), the CUDA kernel on CUDA tensors.
    `pos` is an int or a 0-d int32 tensor on q's device.  The kernel has
    no backward: on CUDA inputs that need a gradient it raises."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q [B,Hq,D], k/v [B,S,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D or Hq % Hkv or S < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k_cache.shape)}")
    devices = {q.device, k_cache.device, v_cache.device}
    if devices == {torch.device("cpu")} or isinstance(q, FakeTensor):
        return decode_attention_plain(q, k_cache, v_cache, pos, ring=ring,
                                      softcap=softcap, lse=lse)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors on one "
                         f"device; got {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("decode_attention: kernel B1 has no backward, so its output "
                           "would carry no gradient to its inputs; run it under "
                           "torch.no_grad()")
    # The ring rule keeps the same keys as idx <= pos for every pos >= 0, so
    # the kernel needs no ring flag (see the note in the CUDA source).
    return _launch(q, k_cache, v_cache, pos, softcap, lse)


@functools.lru_cache(maxsize=256)
def plan(B: int, Hq: int, Hkv: int, S: int, D: int, q_dtype: torch.dtype,
         cache_dtype: torch.dtype, sms: int = 132) -> int:
    """Splits of S in the kernel's grid: enough blocks for one wave over
    the `sms` SMs (two blocks an SM at D <= 128, one at D = 256, as the
    kernel's shared-memory budget allows), at least 128 keys a split,
    and no more than balance the merge.  The block that merges reads every
    split's partial (rows x D f32) after the others read their keys
    (S/n x D x 2 x itemsize), so n beyond
    sqrt(S * itemsize * _MERGE_RATIO / (2 * rows)) lengthens the merge by
    more than it shortens the reads."""
    heads = _HEADS_PER_BLOCK[q_dtype]
    G = Hq // Hkv
    blocks = B * Hkv * math.ceil(G / heads)
    per_sm = 2 if D <= 128 else 1
    n = min(max(1, per_sm * sms // blocks), math.ceil(S / _MIN_KEYS), _MAX_SPLITS)
    n_merge = math.sqrt(S * cache_dtype.itemsize * _MERGE_RATIO / (2 * min(G, heads)))
    return max(1, min(n, int(n_merge)))


@functools.cache
def _kernel():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (partials f32, counters int32).  The kernel
# leaves every counter at 0, so a workspace is zeroed once, when made;
# keying by stream keeps two streams' launches off each other's counters.
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
# Open `record_workspaces` lists: each collects the workspaces handed out
# while it is open.
_recording: list[list] = []


@contextlib.contextmanager
def record_workspaces():
    """Collects every workspace the kernel is given while the block runs.
    A CUDA graph captured in the block keeps the list: its replays write
    those workspaces, so none of them may be freed (and its memory handed
    to other work, its counters left dirty) while the graph lives, even
    after a larger one replaced it in `_workspaces`."""
    used: list = []
    _recording.append(used)
    try:
        yield used
    finally:
        _recording.remove(used)


def _workspace(device: torch.device, stream: int, n_part: int, n_counters: int):
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_counters:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # Zeroing a workspace made in a capture would run only when that
            # graph replays, and another graph could use it first: it is made
            # by an eager run of the step on the capturing stream.
            raise RuntimeError("decode_attention: no workspace large enough on this "
                               "stream; run the step once eagerly on the stream before "
                               "capturing it into a CUDA graph")
        # A smaller one is dropped (graphs that used it keep it, see
        # `record_workspaces`): the caching allocator hands its memory only
        # to work queued after it on this same stream.
        n_part = max(n_part, ws[0].numel() if ws else 0)
        n_counters = max(n_counters, ws[1].numel() if ws else 0)
        ws = (torch.empty(n_part, dtype=torch.float32, device=device),
              torch.zeros(n_counters, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    for used in _recording:
        if not any(w is ws for w in used):
            used.append(ws)
    return ws


def _refuse_int_pos_in_capture() -> None:
    """A Python int position captured into a CUDA graph would be frozen
    into every replay: while a graph is captured `pos` must be a tensor."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_attention: pos is a Python int while a CUDA graph is "
                           "captured; pass it as a 0-d int32 tensor on the device")


def _launch(q, k_cache, v_cache, pos, softcap, want_lse=False):
    global launches
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    if v_cache.dtype != k_cache.dtype or (q.dtype, k_cache.dtype) not in _PAIRS:
        raise TypeError(f"the decode kernel takes q float32 or bfloat16 with a cache in "
                        f"q's dtype or float8_e4m3fn; got q {q.dtype}, k {k_cache.dtype}, "
                        f"v {v_cache.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head dims {_HEAD_DIMS}, not {D}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    fn = _kernel()
    if not isinstance(pos, torch.Tensor):
        _refuse_int_pos_in_capture()
        pos = torch.tensor(int(pos), dtype=torch.int32, device=q.device)
    if pos.dtype != torch.int32 or pos.numel() != 1 or pos.device != q.device:
        raise ValueError(f"pos must be one int32 on {q.device}; got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")

    n_splits = plan(B, Hq, Hkv, S, D, q.dtype, k_cache.dtype, _sm_count(q.device.index))
    heads = _HEADS_PER_BLOCK[q.dtype]
    n_bhg = B * Hkv * math.ceil(Hq // Hkv / heads)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = _workspace(q.device, stream, n_bhg * n_splits * heads * (D + 2), n_bhg)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device) if want_lse else None
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
             out.data_ptr(), part.data_ptr(), counters.data_ptr(),
             lse.data_ptr() if want_lse else None, _Q_CODES[q.dtype],
             int(k_cache.dtype == torch.float8_e4m3fn), B, Hq, Hkv, S, D, n_splits,
             1.0 / math.sqrt(D), float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    launches += 1
    return (out, lse) if want_lse else out
