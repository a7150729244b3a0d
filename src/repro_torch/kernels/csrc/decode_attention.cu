// Flash-decode GQA attention for Hopper (sm_90a): kernel B1 of the port.
//
// Replaces the TPU kernel `repro/kernels/decode_attention.py`
// `flash_decode_gqa` (Pallas body `_kernel`), and covers what the model path
// `repro/models/attention.py` `decode_attention` needs beyond it: any S (the
// ragged edge is masked, no S % block restriction), logit softcap, and the
// ring-buffer validity rule.  That rule, `idx <= pos || (ring && pos >= S-1)`,
// keeps the same keys as `idx <= pos` for every pos >= 0, so one kernel
// serves both caches: the valid keys are the prefix [0, min(pos+1, S)).
//
// One query token per sequence: q [B,Hq,D], k/v [B,S,Hkv,D] contiguous,
// pos an int32 on the device (read here, so the decode loop never syncs
// with the host).  The G = Hq/Hkv query heads of a KV head share its K/V.
// Softmax and accumulation run in f32; the output is written in q's type.
//
// What bounds it on the H100: bytes.  It reads K and V up to pos+1 (or S
// once the ring is full) plus q, and writes out: 4*G/sizeof(T) flops per
// byte, far below the ~295 flop/byte at which the tensor cores would be the
// limit, so the bound is bytes / 3.35 TB/s.
//
// Design (correct and simple first):
//  * One block per (S-split, KV head, group of up to GB query heads, batch).
//    S is split because B*Hkv alone is too few blocks: 128 for llama2-7b at
//    B=4 and 32 for llama2-70b, against 132 SMs.  The splits share the valid
//    prefix evenly, computed on the device from pos, so no block is idle
//    however short the prefix.
//  * Each K/V row is read with coalesced 16-byte loads by LPR lanes of a
//    warp; a warp covers 32/LPR rows at once.  A row wider than a warp's
//    32 loads (D=256 in f32) is read in PIECES loads a lane, 512 bytes
//    apart, so a lane holds E = PIECES * VEC of its dims.  Each such row group is an
//    independent online-softmax stream (running max m, normalizer l and
//    accumulator acc in f32 registers) over its own keys.  The query rows
//    live in shared memory in f32.
//  * The streams are merged within the warp by shuffles, across warps
//    through shared memory, and written as one partial (m, l, acc) per
//    split.  A second small kernel merges the splits and normalizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T, widened to f32.
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// exp(m - M), with an empty stream (m = -inf) weighing 0.
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int S, int Hkv, int G,
                    int n_splits, float scale, float softcap) {
  constexpr int VEC = Vec16<T>::N;     // elements per 16-byte load
  constexpr int LPR = D / VEC < 32 ? D / VEC : 32;   // lanes per K/V row
  constexpr int PIECES = D / (VEC * LPR);            // 16-byte loads per lane per row
  constexpr int E = PIECES * VEC;      // dims a lane holds
  static_assert(D % (VEC * LPR) == 0 && LPR >= 2 && 32 % LPR == 0,
                "head dim must fill whole 16-byte lanes of one warp");
  constexpr int RPW = 32 / LPR;        // rows a warp reads at once
  constexpr int NS = kWarps * RPW;     // online-softmax streams per block

  const int split = blockIdx.x;
  const int n_gchunks = (G + GB - 1) / GB;
  const int h = blockIdx.y / n_gchunks;
  const int g0 = (blockIdx.y % n_gchunks) * GB;
  const int b = blockIdx.z;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;          // which row of the warp's RPW rows
  const int sub = lane % LPR;          // which 16-byte piece of that row

  __shared__ float q_s[GB][D];
  __shared__ float w_m[kWarps][GB];
  __shared__ float w_l[kWarps][GB];
  __shared__ float w_acc[kWarps][GB][D];

  for (int i = threadIdx.x; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = (g0 + g < G)
        ? to_f32(q[((size_t)b * Hq + (size_t)h * G + g0 + g) * D + d]) : 0.f;
  }
  __syncthreads();

  // Valid keys are [0, n_valid).  pos < 0 leaves no key valid, where the
  // reference's softmax over all-masked scores is uniform over all S keys.
  const int pos = *pos_ptr;
  const bool uniform = pos < 0;
  const int n_valid = uniform ? S : min(pos + 1, S);
  const int chunk = (n_valid + n_splits - 1) / n_splits;
  const int kb = min(split * chunk, n_valid);
  const int ke = min(kb + chunk, n_valid);

  // Element e of a lane is dim dim_of(e) of the row.
  auto dim_of = [&](int e) { return (e / VEC) * VEC * LPR + sub * VEC + e % VEC; };

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const size_t head_off = ((size_t)b * S * Hkv + h) * D + (size_t)sub * VEC;
  const T* kp = k + head_off;
  const T* vp = v + head_off;

  // Warp-uniform trip count, so every lane reaches the shuffles.
  for (int base = kb + warp * RPW; base < ke; base += NS) {
    const int j = base + grp;
    const bool live = j < ke;
    float kv[E], vv[E];
    if (live) {
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
        Vec16<T>::load(kp + (size_t)j * row_stride + pc * VEC * LPR, kv + pc * VEC);
        Vec16<T>::load(vp + (size_t)j * row_stride + pc * VEC * LPR, vv + pc * VEC);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = vv[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(q_s[g][dim_of(e)], kv[e], s);
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2) s += __shfl_xor_sync(kFull, s, off);
      s *= scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      if (uniform) s = 0.f;
      if (live) {
        const float m_new = fmaxf(m[g], s);
        const float alpha = rescale(m[g], m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // Merge the RPW row-group streams of this warp: lanes at the same `sub`
  // hold the same dims, LPR lanes apart.
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float a = rescale(m[g], M), ao = rescale(mo, M);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float acc_o = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * ao;
      }
      m[g] = M;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (sub == 0) {
        w_m[warp][g] = m[g];
        w_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) w_acc[warp][g][dim_of(e)] = acc[g][e];
    }
  }
  __syncthreads();

  // Merge the warps and write this split's partial.
  for (int i = threadIdx.x; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    if (g0 + g >= G) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = rescale(w_m[w][g], M);
      L += w_l[w][g] * a;
      A += w_acc[w][g][d] * a;
    }
    const size_t row = ((size_t)b * Hq + (size_t)h * G + g0 + g) * n_splits + split;
    part_acc[row * D + d] = A;
    if (d == 0) {
      part_m[row] = M;
      part_l[row] = L;
    }
  }
}

// One block per (batch, query head): merge the splits' partials.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int D, int n_splits) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, pm[s]);
  float L = 0.f;
  for (int s = 0; s < n_splits; ++s) L += pl[s] * rescale(pm[s], M);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
    for (int s = 0; s < n_splits; ++s)
      A += part_acc[(row * n_splits + s) * D + d] * rescale(pm[s], M);
    store(out + row * D + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int GB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos,
                   void* out, void* part_m, void* part_l, void* part_acc,
                   int B, int Hq, int Hkv, int S, int n_splits, float scale,
                   float softcap, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const dim3 grid(n_splits, Hkv * ((G + GB - 1) / GB), B);
  decode_split_kernel<T, D, GB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, Hkv, G,
      n_splits, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * Hq, D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), D, n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(int group_block, const void* q, const void* k,
                           const void* v, const void* pos, void* out, void* pm,
                           void* pl, void* pa, int B, int Hq, int Hkv, int S,
                           int n_splits, float scale, float softcap,
                           cudaStream_t st) {
  switch (group_block) {
    case 1: return launch<T, D, 1>(q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    case 2: return launch<T, D, 2>(q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    case 4: return launch<T, D, 4>(q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    case 8: return launch<T, D, 8>(q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, int group_block, const void* q, const void* k,
                         const void* v, const void* pos, void* out, void* pm,
                         void* pl, void* pa, int B, int Hq, int Hkv, int S,
                         int n_splits, float scale, float softcap,
                         cudaStream_t st) {
  switch (D) {
    case 32: return dispatch_group<T, 32>(group_block, q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    case 64: return dispatch_group<T, 64>(group_block, q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    case 128: return dispatch_group<T, 128>(group_block, q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    case 256: return dispatch_group<T, 256>(group_block, q, k, v, pos, out, pm, pl, pa, B, Hq, Hkv, S, n_splits, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  group_block: query heads per block
// (1, 2, 4 or 8).  part_m/part_l hold B*Hq*n_splits floats and part_acc
// B*Hq*n_splits*D floats of scratch.  Returns a cudaError_t.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* part_m, void* part_l, void* part_acc, int dtype, int B, int Hq,
    int Hkv, int S, int D, int n_splits, int group_block, float scale,
    float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(D, group_block, q, k, v, pos, out, part_m, part_l,
                               part_acc, B, Hq, Hkv, S, n_splits, scale, softcap, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, group_block, q, k, v, pos, out, part_m,
                                       part_l, part_acc, B, Hq, Hkv, S, n_splits,
                                       scale, softcap, st);
  return cudaErrorInvalidValue;
}
