"""Flash-decode GQA attention (kernel B1): one new query token per sequence
attends over a KV cache.

Replaces the TPU kernel `repro.kernels.decode_attention.flash_decode_gqa`
with the hand-written CUDA kernel in `csrc/decode_attention.cu` (see the
note there for its bound and design), and computes what the model path
`repro.models.attention.decode_attention` needs: any S, softcap and the
ring-buffer rule.

`decode_attention` is the one entry point.  For CPU tensors it runs
`decode_attention_plain`, the same function in plain PyTorch; for CUDA
tensors it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

# Launches of the CUDA kernel through `decode_attention` since the last
# reset; a run sets it to 0 and reads it to show that it went through B1.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_GROUP_BLOCK = 8
_TARGET_BLOCKS = 2 * 132       # two blocks for each of the H100's 132 SMs
_MIN_KEYS_PER_SPLIT = 64


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos, *, ring: bool = False,
                           softcap: float = 0.0) -> torch.Tensor:
    """One-token attention over a cache, in plain PyTorch.

    q: [B, Hq, D]; k_cache, v_cache: [B, S, Hkv, D]; pos: absolute position
    of the current token (already written into the cache).
    ring=False: entries with index > pos are masked.  ring=True: sliding-
    window ring buffer, every slot valid once pos+1 >= S, else slots > pos
    masked.  Returns [B, Hq, D] in q's dtype."""
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
    pos = torch.as_tensor(pos, device=q.device)
    valid = torch.arange(S, device=q.device) <= pos
    if ring:
        valid = valid | (pos >= S - 1)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w.to(v.dtype), v)
    return o.reshape(B, Hq, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, ring: bool = False,
                     softcap: float = 0.0) -> torch.Tensor:
    """`decode_attention_plain`'s function: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors.  `pos` is an int or a 0-d
    int32 tensor on q's device."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q [B,Hq,D], k/v [B,S,Hkv,D]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D or Hq % Hkv or S < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache {tuple(k_cache.shape)}")
    devices = {q.device, k_cache.device, v_cache.device}
    if devices == {torch.device("cpu")}:
        return decode_attention_plain(q, k_cache, v_cache, pos, ring=ring,
                                      softcap=softcap)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors on one "
                         f"device; got {sorted(map(str, devices))}")
    # The ring rule keeps the same keys as idx <= pos for every pos >= 0, so
    # the kernel needs no ring flag (see the note in the CUDA source).
    return _launch(q, k_cache, v_cache, pos, softcap)


@functools.cache
def _kernel():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_cache, v_cache, pos, softcap):
    global launches
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"the decode kernel takes a cache in q's dtype; got q "
                        f"{q.dtype}, k {k_cache.dtype}, v {v_cache.dtype} "
                        f"(fp8 caches are not supported yet)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the decode kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the decode kernel takes head dims {_HEAD_DIMS}, not {D}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    fn = _kernel()
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(int(pos), dtype=torch.int32, device=q.device)
    if pos.dtype != torch.int32 or pos.numel() != 1 or pos.device != q.device:
        raise ValueError(f"pos must be one int32 on {q.device}; got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")

    G = Hq // Hkv
    group_block = min(_MAX_GROUP_BLOCK, 1 << (G - 1).bit_length())
    blocks = B * Hkv * math.ceil(G / group_block)
    n_splits = max(1, min(math.ceil(_TARGET_BLOCKS / blocks),
                          math.ceil(S / _MIN_KEYS_PER_SPLIT)))
    out = torch.empty_like(q)
    part_ml = torch.empty((2, B * Hq * n_splits), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B * Hq * n_splits, D), dtype=torch.float32, device=q.device)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        part_acc.data_ptr(), _DTYPE_CODES[q.dtype], B, Hq, Hkv, S, D, n_splits,
        group_block, 1.0 / math.sqrt(D), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
