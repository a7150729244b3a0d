// RG-LRU linear recurrence for Hopper (sm_90a): kernel B4 of the port.
//
// Replaces the TPU kernel `repro/kernels/rglru_scan.py` `rglru_scan_pallas`
// (Pallas body `_kernel`) and computes the recurrence of the model path
// `repro/models/hybrid.py` `rglru_scan` beyond it: any S and W (no block
// multiples) and an initial state h0.
//
//   h_t = a_t * h_{t-1} + b_t   per (batch, channel);   a, b, h [B,S,W] f32
//
// What bounds it on the H100: bytes.  It reads a and b once and writes h
// once, 12 bytes a step a channel for one multiply-add: the bound is
// (3*B*S*W + B*W)*4 bytes / 3.35 TB/s, 3.8 us at recurrentgemma-9b's
// W = 4096, B = 2, S = 128.  Reaching it takes a few MB of loads in flight
// at once; walking S in order, one thread a channel, keeps B*W = 8,192
// threads with a chain of dependent steps each, far too few.
//
// Design: a one-pass segmented scan.  A block takes a run of channels of
// one batch row (V = 4 channels a thread through 16-byte float4 accesses
// where W % 4 == 0 and the pointers are 16-byte aligned, else V = 1) and
// splits the sequence into nseg segments of seg_len steps, one group of
// `ct` threads each (ct * V = 32 channels: 128 contiguous bytes a row).
// The block walks S in tiles of nseg * seg_len steps, and per tile:
//   1. each thread issues all of its segment's loads of a and b before it
//      uses any (seg_len <= kMaxLen steps, held in registers), then
//      composes the segment's affine map h -> A h + Bc;
//   2. the maps go to shared memory, and each thread walks the maps of
//      the segments before its own from the tile's carry-in (h0 or 0 at
//      the start): an exclusive scan of the nseg maps, the rest of the
//      walk gives the carry into the next tile;
//   3. each thread replays its segment from registers with its carry-in
//      and stores h; after the last tile, h_last is the carry.
// a and b are read once and h written once.  `nseg` and `seg_len` come
// from the wrapper (kernels/rglru_scan.py `plan`), which picks them from
// (B, S, W) so that a serve prefill's whole sequence is one tile and its
// loads are all in flight together.
//
// Backward (`rglru_scan_bwd_kernel`).  With incoming gradients dh [B,S,W]
// and dh_last [B,W] (null: zero), the adjoint is the same recurrence run
// from the end with its coefficient one step ahead:
//   g_{S-1} = dh_{S-1} + dh_last,   g_t = dh_t + a_{t+1} g_{t+1},
//   db_t = g_t,   da_t = g_t h_{t-1} (h_{-1} = h0 or 0),   dh0 = a_0 g_0.
// The kernel is the forward's segmented scan walked in reverse time
// (reversed step r is t = S-1-r, its coefficient a_{t+1}, or 1 at r = 0
// with dh_last as the carry-in), with an epilogue that reads the saved
// forward h one step back.  Bound: bytes.  It reads a, h and dh and
// writes da and db, 20 bytes a step a channel (plus the [B,W] rows), the
// same split (`plan`) as the forward, one pass, no atomics: every output
// element is written by one thread in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 8;        // steps a thread holds in registers per tile
constexpr int kRowChannels = 32;  // channels a segment row covers (128 bytes)

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T fill(float x) { return x; }
  static __device__ __forceinline__ T fma(T a, T h, T b) { return fmaf(a, h, b); }
  static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T fill(float x) { return make_float4(x, x, x, x); }
  static __device__ __forceinline__ T fma(T a, T h, T b) {
    return make_float4(fmaf(a.x, h.x, b.x), fmaf(a.y, h.y, b.y), fmaf(a.z, h.z, b.z),
                       fmaf(a.w, h.w, b.w));
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  }
};

template <int V>
__global__ void __launch_bounds__(256)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W, int nseg, int seg_len) {
  using Ops = Vec<V>;
  using T = typename Ops::T;
  constexpr int ct = kRowChannels / V;           // threads along the channels
  extern __shared__ __align__(16) unsigned char smem[];
  T* map_a = reinterpret_cast<T*>(smem);         // [nseg][ct] composed multipliers
  T* map_b = map_a + nseg * ct;                  // [nseg][ct] composed offsets

  const int seg = threadIdx.x / ct, ci = threadIdx.x % ct;
  const int w = (blockIdx.x * ct + ci) * V;      // first channel of this thread
  const int bb = blockIdx.y;
  const bool active = w < W;                     // V = 4 only when W % 4 == 0
  const T* av_g = reinterpret_cast<const T*>(a + (size_t)bb * S * W + w);
  const T* bv_g = reinterpret_cast<const T*>(b + (size_t)bb * S * W + w);
  T* h_g = reinterpret_cast<T*>(h + (size_t)bb * S * W + w);
  const size_t step = W / V;                     // one time step, in units of T

  T carry = Ops::fill(0.f);
  if (h0 && active) carry = *reinterpret_cast<const T*>(h0 + (size_t)bb * W + w);
  const int tile = nseg * seg_len;

  for (int t0 = 0; t0 < S; t0 += tile) {
    const int ts = t0 + seg * seg_len;           // this segment's first step
    const int n = active ? max(0, min(seg_len, S - ts)) : 0;
    T av[kMaxLen], bv[kMaxLen];
#pragma unroll
    for (int u = 0; u < kMaxLen; ++u) {
      if (u < n) {
        av[u] = av_g[(size_t)(ts + u) * step];
        bv[u] = bv_g[(size_t)(ts + u) * step];
      }
    }
    T A = Ops::fill(1.f), Bc = Ops::fill(0.f);
#pragma unroll
    for (int u = 0; u < kMaxLen; ++u) {
      if (u < n) {
        Bc = Ops::fma(av[u], Bc, bv[u]);
        A = Ops::mul(av[u], A);
      }
    }
    map_a[seg * ct + ci] = A;
    map_b[seg * ct + ci] = Bc;
    __syncthreads();

    T hin = carry, mine = carry;
#pragma unroll 4
    for (int s = 0; s < nseg; ++s) {
      if (s == seg) mine = hin;
      hin = Ops::fma(map_a[s * ct + ci], hin, map_b[s * ct + ci]);
    }
    carry = hin;

#pragma unroll
    for (int u = 0; u < kMaxLen; ++u) {
      if (u < n) {
        mine = Ops::fma(av[u], mine, bv[u]);
        h_g[(size_t)(ts + u) * step] = mine;
      }
    }
    __syncthreads();   // the maps are read before the next tile writes them
  }
  if (seg == 0 && active) *reinterpret_cast<T*>(h_last + (size_t)bb * W + w) = carry;
}

template <int V>
__global__ void __launch_bounds__(256)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ h0, const float* __restrict__ dh,
                      const float* __restrict__ dh_last, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dh0, int S, int W, int nseg,
                      int seg_len) {
  using Ops = Vec<V>;
  using T = typename Ops::T;
  constexpr int ct = kRowChannels / V;
  extern __shared__ __align__(16) unsigned char smem[];
  T* map_a = reinterpret_cast<T*>(smem);         // [nseg][ct]
  T* map_b = map_a + nseg * ct;                  // [nseg][ct]

  const int seg = threadIdx.x / ct, ci = threadIdx.x % ct;
  const int w = (blockIdx.x * ct + ci) * V;
  const int bb = blockIdx.y;
  const bool active = w < W;
  const size_t row = (size_t)bb * S * W + w;
  const T* a_g = reinterpret_cast<const T*>(a + row);
  const T* h_g = reinterpret_cast<const T*>(h + row);
  const T* dh_g = reinterpret_cast<const T*>(dh + row);
  T* da_g = reinterpret_cast<T*>(da + row);
  T* db_g = reinterpret_cast<T*>(db + row);
  const size_t step = W / V;

  T carry = Ops::fill(0.f);
  if (dh_last && active) carry = *reinterpret_cast<const T*>(dh_last + (size_t)bb * W + w);
  T h_init = Ops::fill(0.f);
  if (h0 && active) h_init = *reinterpret_cast<const T*>(h0 + (size_t)bb * W + w);
  const int tile = nseg * seg_len;

  for (int r0 = 0; r0 < S; r0 += tile) {
    const int rs = r0 + seg * seg_len;           // this segment's first reversed step
    const int n = active ? max(0, min(seg_len, S - rs)) : 0;
    T cv[kMaxLen], gv[kMaxLen], hv[kMaxLen];
#pragma unroll
    for (int u = 0; u < kMaxLen; ++u) {
      if (u < n) {
        const int t = S - 1 - (rs + u);
        cv[u] = t + 1 < S ? a_g[(size_t)(t + 1) * step] : Ops::fill(1.f);
        gv[u] = dh_g[(size_t)t * step];
        hv[u] = t >= 1 ? h_g[(size_t)(t - 1) * step] : h_init;
      }
    }
    T A = Ops::fill(1.f), Bc = Ops::fill(0.f);
#pragma unroll
    for (int u = 0; u < kMaxLen; ++u) {
      if (u < n) {
        Bc = Ops::fma(cv[u], Bc, gv[u]);
        A = Ops::mul(cv[u], A);
      }
    }
    map_a[seg * ct + ci] = A;
    map_b[seg * ct + ci] = Bc;
    __syncthreads();

    T gin = carry, mine = carry;
#pragma unroll 4
    for (int s = 0; s < nseg; ++s) {
      if (s == seg) mine = gin;
      gin = Ops::fma(map_a[s * ct + ci], gin, map_b[s * ct + ci]);
    }
    carry = gin;

#pragma unroll
    for (int u = 0; u < kMaxLen; ++u) {
      if (u < n) {
        const int t = S - 1 - (rs + u);
        mine = Ops::fma(cv[u], mine, gv[u]);
        db_g[(size_t)t * step] = mine;
        da_g[(size_t)t * step] = Ops::mul(mine, hv[u]);
      }
    }
    __syncthreads();
  }
  // carry is g_0 now
  if (dh0 && seg == 0 && active)
    *reinterpret_cast<T*>(dh0 + (size_t)bb * W + w) = Ops::mul(a_g[0], carry);
}

}  // namespace

// a, b, h [B,S,W] and h0, h_last [B,W], all f32 and contiguous; h0 may be
// null (zero initial state).  vec = 4 needs W % 4 == 0 and 16-byte aligned
// pointers, else vec = 1.  nseg * (32 / vec) threads a block, at most 256;
// 1 <= seg_len <= 8.  Returns a cudaError_t.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, void* h_last, int B, int S, int W, int vec,
                                 int nseg, int seg_len, void* stream) {
  if (B < 1 || S < 1 || W < 1 || nseg < 1 || seg_len < 1 || seg_len > kMaxLen)
    return cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || W % 4)) return cudaErrorInvalidValue;
  const int ct = kRowChannels / vec;
  if (nseg * ct > 256) return cudaErrorInvalidValue;
  const dim3 grid((W + kRowChannels - 1) / kRowChannels, B);
  const size_t smem = 2 * sizeof(float) * vec * ct * nseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* h0f = static_cast<const float*>(h0);
  if (vec == 4)
    rglru_scan_kernel<4><<<grid, nseg * ct, smem, st>>>(
        af, bf, h0f, static_cast<float*>(h), static_cast<float*>(h_last), S, W, nseg, seg_len);
  else
    rglru_scan_kernel<1><<<grid, nseg * ct, smem, st>>>(
        af, bf, h0f, static_cast<float*>(h), static_cast<float*>(h_last), S, W, nseg, seg_len);
  return cudaGetLastError();
}

// The backward: a, h, dh, da, db [B,S,W] and h0, dh_last, dh0 [B,W], all f32
// and contiguous; h0 and dh_last may be null (zero), dh0 null when the
// initial state's gradient is not wanted.  The split (vec, nseg, seg_len)
// follows the forward's rules, with every pointer in the alignment rule.
// Returns a cudaError_t.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h, const void* h0,
                                     const void* dh, const void* dh_last, void* da, void* db,
                                     void* dh0, int B, int S, int W, int vec, int nseg,
                                     int seg_len, void* stream) {
  if (B < 1 || S < 1 || W < 1 || nseg < 1 || seg_len < 1 || seg_len > kMaxLen)
    return cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || W % 4)) return cudaErrorInvalidValue;
  const int ct = kRowChannels / vec;
  if (nseg * ct > 256) return cudaErrorInvalidValue;
  const dim3 grid((W + kRowChannels - 1) / kRowChannels, B);
  const size_t smem = 2 * sizeof(float) * vec * ct * nseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (vec == 4)
    rglru_scan_bwd_kernel<4><<<grid, nseg * ct, smem, st>>>(
        f(a), f(h), f(h0), f(dh), f(dh_last), static_cast<float*>(da), static_cast<float*>(db),
        static_cast<float*>(dh0), S, W, nseg, seg_len);
  else
    rglru_scan_bwd_kernel<1><<<grid, nseg * ct, smem, st>>>(
        f(a), f(h), f(h0), f(dh), f(dh_last), static_cast<float*>(da), static_cast<float*>(db),
        static_cast<float*>(dh0), S, W, nseg, seg_len);
  return cudaGetLastError();
}
