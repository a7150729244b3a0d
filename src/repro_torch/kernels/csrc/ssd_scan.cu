// Mamba-2 SSD chunk scan for Hopper (sm_90a): kernel B3 of the port.
//
// Replaces the TPU kernel `repro/kernels/ssd_scan.py` `ssd_scan` (Pallas
// body `_kernel`) and computes what the model path `repro/models/ssm.py`
// `ssd_chunked` computes, beyond both: any S (the last chunk may be short)
// and an initial state h0.
//
//   S_t = exp(dA_t) S_{t-1} + xdt_t (x) B_t,   y_t[p] = sum_n C_t[n] S_t[p, n]
//
// Inputs: xdt [b,s,h,p] and B, C [b,s,g,n] in T (f32 or bf16; head h
// reads group h / (H/G)), dA [b,s,h] f32, h0 [b,h,p,n] f32 or null.
// Outputs: y [b,s,h,p] in T, final state [b,h,p,n] f32.  All arithmetic
// is f32.
//
// What bounds it on the H100: at mamba2-130m's shapes in bf16, bytes.  It
// must read x (P values a step a head), B and C (N values a step a group,
// shared by the H/G heads of the group) and dA, and write y and the f32
// final state, which at S <= 256 is the largest single transfer.  The
// recurrence needs 4*P*N flops a step a head (state update and read-out),
// well under the bf16 rate for those bytes.  This kernel does its
// multiply-adds in f32 on the CUDA cores and recomputes each chunk's scores
// in every p-tile, so it is held by those operations rather than by the
// bytes; moving the two chunk products to mma/wgmma is later work.
//
// Design (correct and simple first):
//  * One block per (p-tile of kPT state rows, head, batch).  The state
//    rows are independent (S[p, :] evolves alone, y_t[p] needs only row
//    p), so the head dim is split across blocks: at b=2, mamba2-130m gives
//    4 x 24 x 2 = 192 blocks for 132 SMs, where (b, h) alone gives 48.
//  * Each block walks the sequence in chunks of kT = 32 steps (one warp's
//    width, so the inclusive cumsum of dA is one warp scan).  It stages
//    the chunk's B, C rows [kT, N], x [kT, kPT] and the decays in shared
//    memory, keeps its [kPT, N] state in shared memory across chunks, and
//    per chunk:
//      scores  G[t][j] = exp(cs_t - cs_j) * (C_t . B_j)   for j <= t
//      y[t]          = sum_{j<=t} G[t][j] x[j] + exp(cs_t) * (C_t . S)
//      S            <- exp(cs_last) S + sum_t exp(cs_last - cs_t) x_t (x) B_t
//    which is the reference's chunked form with chunk kT: quadratic within
//    a chunk, linear across chunks, the state never leaving the SM.
//  * Rows in shared memory have stride N+1, so a warp walking a column
//    (32 rows at one n) hits 32 banks.  Steps past the end of the
//    sequence load dA = 0 and B = C = x = 0 and change nothing.
//  * Each p-tile block recomputes its chunk's scores (P/kPT-fold work, about
//    half the state work at P=64): simple, and the price of the 4x blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;      // steps per chunk: one warp's lanes
constexpr int kPT = 16;     // state rows (head-dim entries) per block
constexpr int kMaxN = 256;  // largest state size
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Shared-memory floats one block needs for state size N.
__host__ __device__ constexpr int smem_floats(int N) {
  return 2 * kT * (N + 1)      // B and C rows of the chunk
       + kPT * (N + 1)         // state rows
       + kT * (kT + 1)         // decay-weighted scores
       + kT * kPT              // x of the chunk
       + 3 * kT;               // exp(cs_t), exp(cs_last - cs_t), cs_t
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ final_state, int S, int H, int P,
                      int G, int N) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* b_s = smem;                  // [kT][NP]
  float* c_s = b_s + kT * NP;         // [kT][NP]
  float* st_s = c_s + kT * NP;        // [kPT][NP]
  float* g_s = st_s + kPT * NP;       // [kT][kT+1]
  float* x_s = g_s + kT * (kT + 1);   // [kT][kPT]
  float* din_s = x_s + kT * kPT;      // [kT] exp(cs_t): decay from chunk start
  float* dout_s = din_s + kT;         // [kT] exp(cs_last - cs_t): decay to chunk end
  float* cs_s = dout_s + kT;          // [kT] inclusive cumsum of dA

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;

  for (int i = tid; i < kPT * N; i += kThreads) {
    const int pp = i / N, n = i % N;
    st_s[pp * NP + n] = h0 ? h0[state_base + i] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int len = min(kT, S - t0);
    __syncthreads();   // the last chunk's readers are done with the staging

    for (int i = tid; i < kT * N; i += kThreads) {
      const int t = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < len) {
        const size_t off = (((size_t)b * S + t0 + t) * G + g) * N + n;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      b_s[t * NP + n] = bv;
      c_s[t * NP + n] = cv;
    }
    for (int i = tid; i < kT * kPT; i += kThreads) {
      const int t = i / kPT, pp = i % kPT;
      x_s[i] = t < len ? to_f32(xdt[(((size_t)b * S + t0 + t) * H + h) * P + p0 + pp]) : 0.f;
    }
    if (warp == 0) {
      float cs = lane < len ? dA[((size_t)b * S + t0 + lane) * H + h] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(kFull, cs, off);
        if (lane >= off) cs += up;
      }
      const float last = __shfl_sync(kFull, cs, kT - 1);
      cs_s[lane] = cs;
      din_s[lane] = expf(cs);
      dout_s[lane] = expf(last - cs);
    }
    __syncthreads();

    // scores: one warp per row t, lane j
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int t = i / kT, j = i % kT;
      float acc = 0.f;
      if (j <= t && t < len) {
        const float* cr = c_s + t * NP;
        const float* br = b_s + j * NP;
        for (int n = 0; n < N; ++n) acc = fmaf(cr[n], br[n], acc);
        acc *= expf(cs_s[t] - cs_s[j]);
      }
      g_s[t * (kT + 1) + j] = acc;
    }
    __syncthreads();

    // y: intra-chunk term plus the carried state's
    for (int i = tid; i < kT * kPT; i += kThreads) {
      const int t = i / kPT, pp = i % kPT;
      if (t >= len) continue;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc = fmaf(g_s[t * (kT + 1) + j], x_s[j * kPT + pp], acc);
      const float* cr = c_s + t * NP;
      const float* sr = st_s + pp * NP;
      float carried = 0.f;
      for (int n = 0; n < N; ++n) carried = fmaf(cr[n], sr[n], carried);
      acc = fmaf(din_s[t], carried, acc);
      store(y + (((size_t)b * S + t0 + t) * H + h) * P + p0 + pp, acc);
    }
    __syncthreads();

    // state: decay to the chunk's end, plus the chunk's inputs
    const float chunk_decay = din_s[kT - 1];
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int pp = i / N, n = i % N;
      float acc = chunk_decay * st_s[pp * NP + n];
      for (int t = 0; t < len; ++t)
        acc = fmaf(dout_s[t] * x_s[t * kPT + pp], b_s[t * NP + n], acc);
      st_s[pp * NP + n] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < kPT * N; i += kThreads) {
    const int pp = i / N, n = i % N;
    final_state[state_base + i] = st_s[pp * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* xdt, const void* dA, const void* B, const void* C,
                   const void* h0, void* y, void* fin, int batch, int S, int H,
                   int P, int G, int N, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / kPT, H, batch);
  ssd_chunk_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(dA),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(fin),
      S, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xdt, B, C and y).  h0 may be null
// (zero initial state).  P must be a multiple of 16, N at most 256, H a
// multiple of G.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* xdt, const void* dA, const void* B,
                               const void* C, const void* h0, void* y,
                               void* final_state, int dtype, int batch, int S,
                               int H, int P, int G, int N, void* stream) {
  if (S < 1 || P % kPT || N < 1 || N > kMaxN || G < 1 || H % G) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xdt, dA, B, C, h0, y, final_state, batch, S, H, P, G, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xdt, dA, B, C, h0, y, final_state, batch, S, H, P, G, N, st);
  return cudaErrorInvalidValue;
}
