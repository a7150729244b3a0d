"""Decode-time caches.

Port of the attention, MLA latent, SSM, hybrid and encoder-decoder caches
of `repro.models.cache`.  `pos` is a 0-d int32
tensor on the cache's device: the absolute position of the *next* token to
be written, so a decode loop never reads it back to the host.
Sliding-window caches are ring buffers of size `window`; keys are stored
already-roped at absolute positions so the ring overwrite is safe.

The reference writes one token with `onehot_write`, an elementwise blend
of the whole per-layer cache (which keeps a sharded layout elementwise
under GSPMD).  Here `write_token` writes the one slot in place with
`index_copy_`; the cache holds the same values afterwards, and a step
moves one token's K/V instead of the whole cache.  (One difference: the
blend multiplies the whole cache by the one-hot mask, so a NaN written to
an fp8 cache spreads in the reference over that element's slots and never
leaves; here it stays in its slot until overwritten.)  The caller's cache
tensors are therefore updated in place.  The recurrent states of
`SSMCache` and `HybridCache` are likewise overwritten in place by each
decode step.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import shard


@dataclasses.dataclass
class KVCache:
    """Full attention cache: k, v [L, B, S, Hkv, Dh]."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor   # 0-d int32

    @staticmethod
    def init(n_layers, batch, cache_len, n_kv, head_dim, dtype, device) -> "KVCache":
        shape = (n_layers, batch, cache_len, n_kv, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros((), dtype=torch.int32, device=device))

    @property
    def cache_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class WindowKVCache:
    """Ring-buffer sliding-window cache: k, v [L, B, W, Hkv, Dh]."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(n_layers, batch, window, n_kv, head_dim, dtype, device) -> "WindowKVCache":
        shape = (n_layers, batch, window, n_kv, head_dim)
        return WindowKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros((), dtype=torch.int32, device=device))

    @property
    def window(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class MLACache:
    """DeepSeek-V3 latent cache: c_kv [L, B, S, kv_lora], k_rope [L, B, S,
    rope_dim].  Written like the KV caches (`write_token`, values cast by
    `to_cache_dtype`)."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(n_layers, batch, cache_len, kv_lora, rope_dim, dtype, device) -> "MLACache":
        return MLACache(
            torch.zeros((n_layers, batch, cache_len, kv_lora), dtype=dtype, device=device),
            torch.zeros((n_layers, batch, cache_len, rope_dim), dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    @property
    def cache_len(self) -> int:
        return self.c_kv.shape[2]


@dataclasses.dataclass
class SSMCache:
    """Mamba-2 state: conv [L, B, K-1, conv_ch], state [L, B, H, P, N] f32."""
    conv: torch.Tensor
    state: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(n_layers, batch, conv_kernel, conv_ch, nheads, headdim, state,
             dtype, device) -> "SSMCache":
        return SSMCache(
            torch.zeros((n_layers, batch, conv_kernel - 1, conv_ch), dtype=dtype,
                        device=device),
            torch.zeros((n_layers, batch, nheads, headdim, state),
                        dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass
class HybridCache:
    """RecurrentGemma: RG-LRU states lru [Lr, B, width] f32 and conv states
    conv [Lr, B, K-1, width] of the recurrent layers; sliding-window ring
    K/V [La, B, window, Hkv, Dh] of the attention layers."""
    lru: torch.Tensor
    conv: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(n_rec, n_attn, batch, width, conv_kernel, window, n_kv, head_dim,
             dtype, device) -> "HybridCache":
        kv = (n_attn, batch, window, n_kv, head_dim)
        return HybridCache(
            torch.zeros((n_rec, batch, width), dtype=torch.float32, device=device),
            torch.zeros((n_rec, batch, conv_kernel - 1, width), dtype=dtype,
                        device=device),
            torch.zeros(kv, dtype=dtype, device=device),
            torch.zeros(kv, dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))

    @property
    def window(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class EncDecCache:
    """Seamless decoder cache: self-attention K/V self_k, self_v
    [L, B, S, H, Dh] and the cross-attention K/V of the encoder memory,
    computed once at prefill, cross_k, cross_v [L, B, T_frames, H, Dh]."""
    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(n_layers, batch, cache_len, n_frames, n_kv, head_dim, dtype,
             device) -> "EncDecCache":
        s = (n_layers, batch, cache_len, n_kv, head_dim)
        c = (n_layers, batch, n_frames, n_kv, head_dim)
        return EncDecCache(torch.zeros(s, dtype=dtype, device=device),
                           torch.zeros(s, dtype=dtype, device=device),
                           torch.zeros(c, dtype=dtype, device=device),
                           torch.zeros(c, dtype=dtype, device=device),
                           torch.zeros((), dtype=torch.int32, device=device))

    @property
    def cache_len(self) -> int:
        return self.self_k.shape[2]


# The largest magnitude that rounds to a finite float8_e4m3fn: 448 is the
# largest finite value, and 464 lies halfway to the next step, which is NaN.
_E4M3_ROUNDS_FINITE = 464.0


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in the cache's dtype, cast as the reference casts it.  For
    float8_e4m3fn that is NaN (with x's sign) where |x| > 464 or x = +-inf,
    where torch's cast saturates to +-448; elsewhere the two agree."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    nan = torch.where(x.signbit(), 0xFF, 0x7F).to(torch.uint8)
    bits = torch.where(x.abs() <= _E4M3_ROUNDS_FINITE, y.view(torch.uint8), nan)
    return bits.view(dtype)


def write_token(cache_l: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write one token in place into a per-layer cache slice at `slot`.

    cache_l [B, S, ...rest]; new [B, ...rest]; slot a 0-d integer tensor on
    the cache's device.  fp8 slots are written through a uint8 view, since
    `index_copy_` has no float8 kernel."""
    if shard.is_dtensor(cache_l):
        return _write_token_sharded(cache_l, new, slot)
    new = to_cache_dtype(new[:, None], cache_l.dtype)
    if cache_l.dtype == torch.float8_e4m3fn:
        cache_l, new = cache_l.view(torch.uint8), new.view(torch.uint8)
    cache_l.index_copy_(1, slot.reshape(1).long(), new)


def _write_token_sharded(cache_l, new, slot) -> None:
    """write_token into a DTensor cache, on each device's shard: where the
    sequence is sharded, only the shard holding `slot` writes it (the
    others write back what they hold, so no device reads `slot` to the
    host)."""
    cache_pl = tuple(cache_l.placements)
    new_pl = shard.moved(cache_pl, {0: 0, **{d: d - 1 for d in range(2, cache_l.ndim)}})
    s0, s_len = shard.shard_offset(cache_l, 1)
    slot_pl = tuple(slot.placements) if shard.is_dtensor(slot) else None

    def local(c_l, n_l, slot_l):
        n_l = to_cache_dtype(n_l[:, None], c_l.dtype)
        if c_l.dtype == torch.float8_e4m3fn:
            c_l, n_l = c_l.view(torch.uint8), n_l.view(torch.uint8)
        at = slot_l - s0
        idx = at.clamp(0, s_len - 1).reshape(1).long()
        here = (at >= 0) & (at < s_len)
        c_l.index_copy_(1, idx, torch.where(here, n_l, c_l.index_select(1, idx)))

    shard.local_call(local, cache_l.device_mesh, (cache_l, new, slot),
                     (cache_pl, new_pl, slot_pl), [])


def ring_pack(ks: torch.Tensor, vs: torch.Tensor, window: int, pos_end: int):
    """Pack full-sequence K/V [L,B,S,H,D] into ring buffers [L,B,W,H,D]
    holding the last min(S, W) positions at slot = pos % W.  DTensors are
    packed replicated (DTensor has no sharding strategy for the indexed
    write, `index_put_`, on some versions); the cache's layout follows."""
    if shard.is_dtensor(ks):
        return shard.replicated(_ring_pack)(ks, vs, window, pos_end)
    return _ring_pack(ks, vs, window, pos_end)


def _ring_pack(ks, vs, window, pos_end):
    S = ks.shape[2]
    take = min(S, window)
    slots = torch.arange(pos_end - take, pos_end, device=ks.device) % window
    shape = ks.shape[:2] + (window,) + ks.shape[3:]
    k = ks.new_zeros(shape)
    v = vs.new_zeros(shape)
    k[:, :, slots] = ks[:, :, S - take:]
    v[:, :, slots] = vs[:, :, S - take:]
    return k, v
