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
// Outputs: y [b,s,h,p] in T, final state [b,h,p,n] f32.
//
// What bounds it on the H100: bytes.  It must read x (P values a step a
// head), B and C (N values a step a group, shared by the H/G heads of the
// group) and dA, and write y and the f32 final state.  At mamba2-130m's
// serve shapes that is about 3 MB, 1 us at 3.35 TB/s; the chunked form's
// products are about 0.1 GFLOP, 0.1 us at the bf16 tensor rate.  So the
// kernel's time is latency: how soon its loads arrive and how few
// dependent steps sit between them and the stores.
//
// The library holds two kernels, chosen by the input type (the wrapper
// `_launch` in kernels/ssd_scan.py documents the same dispatch):
//
// bf16 (`ssd_chunk_scan_bf16_kernel`, the models' type): the chunked form
// on the tensor cores.  One block of 8 warps per (16-row p-tile, head,
// batch), so mamba2-130m at b=2 gives 4 x 24 x 2 = 192 blocks for 132 SMs,
// up to three blocks an SM.  Each block walks the sequence in chunks of kQ = 64
// steps (S <= 128, the serve shapes, is one or two chunks), and per chunk,
// with every product an `mma.sync.m16n8k16` bf16 -> f32 fed by `ldmatrix`
// from shared memory:
//   G(i,j) = C_i B_j^T * exp(cs_t - cs_j) [j <= t]   16-step tiles, j <= i
//   y_i    = sum_j bf16(G(i,j)) x_j + exp(cs_t) (C_i bf16(S)^T)
//   S      = exp(cs_last) S + bf16(x exp(cs_last - cs_t))^T B
// The ten causal score tiles and the four carried-state tiles C_i S^T are
// fourteen units of equal size (a 16 x 16 product over N), spread two a
// warp; each leaves an f32 [16, 16] partial of y in shared memory, and
// after a barrier every thread sums four outputs' partials and stores
// them in bf16.  A score tile's accumulator fragments, masked by the decay
// in registers, are the A operand of its product with x as they lie.
// Units whose rows lie past S are skipped.  The f32 state lives in the
// warps' mma accumulators across chunks (warp w owns the 16-column blocks
// w, w + 8); a bf16 copy of it, double-buffered, feeds the next chunk's
// C S^T, so the state update needs no barrier of its own.  The bf16
// roundings are the plain version's and the reference's
// (`scores.to(dtype)`, `prev_states.to(dtype)`, `decay_states.to(dtype)`);
// every sum is f32.  Each block recomputes C B^T: sharing it across the
// p-tiles and heads would cost a pass through device memory for a product
// of a few hundred cycles.
// B and C [64, N], x [64, 16] and dA [64] of chunk c+1 are copied with
// 16-byte `cp.async` (4 bytes for dA) into the second of two stages while
// chunk c computes (one stage when S <= 64); steps past S copy zeros
// (dA = 0, B = C = x = 0 leave the state as it is), which masks the
// ragged last chunk.  Shared rows are padded by 8 bf16 (16 bytes), so
// the 8 row addresses of an `ldmatrix` fall in 8 distinct 4-bank groups
// for every N % 16 == 0.  Each warp keeps its own copy of the chunk's
// cumulative sum of dA and its decays, so the scan needs no barrier.
// What still holds it back is latency, not bytes or operations: the first
// chunk's loads, then per chunk a few dependent chains of shared loads,
// shuffles and mma with only a few warps to each scheduler.
// N is read at run time.  Limits: P % 16 == 0, N % 16 == 0, N <= 256
// (179 KB of shared memory at N = 256 and S > 64).
//
// f32 (`ssd_chunk_scan_f32_kernel`, reduced models and f32 tests): the
// same chunked form in scalar f32 on the CUDA cores, 32-step chunks, one
// block per (16-row p-tile, head, batch), state in shared memory.  TF32
// products would miss the f32 gate (atol 2e-4, rtol 1e-3), and f32 is not
// on the full-width path.  Limits: P % 16 == 0, N <= 256.
//
// Backward (two kernels, one template over T, f32 sums;
// `ssd_scan_bwd_launch`).  It differentiates the unrounded chunked form,
// so a bf16 forward's gradients are those of its f32 function.  With cs_t
// the cumulative sum of dA inside a chunk of kBQ = 32 steps, S_in the state
// entering the chunk and dS_out the adjoint of the state leaving it:
//   dS_in = e^{cs_last} dS_out + (dy o e^{cs_t})^T C             (dh0 at c = 0)
//   S_out = e^{cs_last} S_in + (x o e^{cs_last-cs_t})^T B
//   dx_j  = sum_{t>=j} e^{cs_t-cs_j} (C_t.B_j) dy_t + e^{cs_last-cs_j} dS_out B_j
//   dB_j  = sum_{t>=j} e^{cs_t-cs_j} (dy_t.x_j) C_t + e^{cs_last-cs_j} dS_out^T x_j
//   dC_t  = sum_{j<=t} e^{cs_t-cs_j} (dy_t.x_j) B_j + e^{cs_t} S_in^T dy_t
// and dcs_t from the pair terms, the carried state and dS_out, summed from
// the end of the chunk into ddA; dB and dC summed over a group's heads.
// What bounds it on the H100: bytes.  It must read x, dy, B, C and dA and
// write dx, dB, dC and ddA: 85.5 MB at mamba2-130m's training shape
// (b=16, s=512, h=24, p=64, g=1, n=128, bf16), 0.0255 ms at 3.35 TB/s; its
// 16.4 GFLOP take 0.0166 ms at the bf16 tensor rate.
//   1. `ssd_bwd_states_kernel`: the pass from chunk to chunk.  Each
//      chunk's increment is one [16 kMTiles x 32] . [32 x N] tensor-core
//      product, so a walk is ceil(s/32) steps of a product and an
//      elementwise decay (16 at that shape), not s rank-1 updates; walk 0
//      (forward, S_in) and walk 1 (backward, dS_out and dh0) run as
//      separate blocks.  It stores every S_in and dS_out as bf16 hi and lo
//      planes: 2 x b*h*ceil(s/32)*p*N x 4 bytes of scratch (2 x 201 MB at
//      that shape), the only intermediate that goes through device memory.
//   2. `ssd_bwd_chunk_kernel`: one block per (chunk, group, batch), every
//      chunk in parallel, looping over the group's heads and their 16-row
//      p-tiles in order.  Every product is an `mma.sync.m16n8k16` fed by
//      `ldmatrix`: C B^T once per block; per head and p-tile dy x^T, V = B
//      dS_out^T and W = C S_in^T (for dx and dcs), Gm^T dy, and the carried
//      parts of dB and dC, accumulated over all heads in registers; at the
//      end (sum over heads of M)^T C and (sum M) B.  bf16 inputs are exact
//      operands; f32 ones (f32 inputs, the states, Gm, sum M and the decay-
//      weighted x and dy) are split into bf16 hi and lo planes and
//      multiplied pairwise but lo x lo (about 2^-16 relative).  dcs (the
//      decay mask, M and the pair terms' row and column sums) is spread
//      over all eight warps, one warp then takes the 32-step scan.  dB and
//      dC are summed over the heads on chip, in head order: no per-head
//      partials and no third kernel.
// Every sum runs in a fixed order and every output element is written by
// one thread, with no atomics: two calls give the same bits.  What holds it
// back, as measured at that shape (`launch/scan_bwd_cuts.py`; 0.54 ms in
// all on an H100 at 700 W): the states kernel's stores of the scratch
// (0.13 of its 0.21 ms, the time its 402.7 MB take at the memory rate),
// and in the chunk kernel (0.32 ms) short dependent chains of ldmatrix
// and mma behind one barrier a p-tile, at two blocks (16 warps) an SM,
// which its 128 registers a thread and 101 KB of shared memory a block
// allow.  Limits: P % 16 == 0, N <= 256 (N % 16 == 0 for bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kPT = 16;     // state rows (head-dim entries) per block
constexpr int kMaxN = 256;  // largest state size
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32: scalar chunked scan
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kT = 32;      // steps per chunk: one warp's lanes

// Shared-memory floats one f32 block needs for state size N.
__host__ __device__ constexpr int f32_smem_floats(int N) {
  return 2 * kT * (N + 1)      // B and C rows of the chunk
       + kPT * (N + 1)         // state rows
       + kT * (kT + 1)         // decay-weighted scores
       + kT * kPT              // x of the chunk
       + 3 * kT;               // exp(cs_t), exp(cs_last - cs_t), cs_t
}

__global__ void __launch_bounds__(kF32Threads)
ssd_chunk_scan_f32_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ final_state, int S, int H, int P,
                          int G, int N) {
  extern __shared__ float smem[];
  const int NP = N + 1;               // odd stride: a column walk hits 32 banks
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

  for (int i = tid; i < kPT * N; i += kF32Threads) {
    const int pp = i / N, n = i % N;
    st_s[pp * NP + n] = h0 ? h0[state_base + i] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int len = min(kT, S - t0);
    __syncthreads();   // the last chunk's readers are done with the staging

    for (int i = tid; i < kT * N; i += kF32Threads) {
      const int t = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < len) {
        const size_t off = (((size_t)b * S + t0 + t) * G + g) * N + n;
        bv = Bm[off];
        cv = Cm[off];
      }
      b_s[t * NP + n] = bv;
      c_s[t * NP + n] = cv;
    }
    for (int i = tid; i < kT * kPT; i += kF32Threads) {
      const int t = i / kPT, pp = i % kPT;
      x_s[i] = t < len ? xdt[(((size_t)b * S + t0 + t) * H + h) * P + p0 + pp] : 0.f;
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
    for (int i = tid; i < kT * kT; i += kF32Threads) {
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
    for (int i = tid; i < kT * kPT; i += kF32Threads) {
      const int t = i / kPT, pp = i % kPT;
      if (t >= len) continue;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc = fmaf(g_s[t * (kT + 1) + j], x_s[j * kPT + pp], acc);
      const float* cr = c_s + t * NP;
      const float* sr = st_s + pp * NP;
      float carried = 0.f;
      for (int n = 0; n < N; ++n) carried = fmaf(cr[n], sr[n], carried);
      acc = fmaf(din_s[t], carried, acc);
      y[(((size_t)b * S + t0 + t) * H + h) * P + p0 + pp] = acc;
    }
    __syncthreads();

    // state: decay to the chunk's end, plus the chunk's inputs
    const float chunk_decay = din_s[kT - 1];
    for (int i = tid; i < kPT * N; i += kF32Threads) {
      const int pp = i / N, n = i % N;
      float acc = chunk_decay * st_s[pp * NP + n];
      for (int t = 0; t < len; ++t)
        acc = fmaf(dout_s[t] * x_s[t * kPT + pp], b_s[t * NP + n], acc);
      st_s[pp * NP + n] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < kPT * N; i += kF32Threads) {
    const int pp = i / N, n = i % N;
    final_state[state_base + i] = st_s[pp * NP + n];
  }
}

// ---------------------------------------------------------------------------
// bf16: chunk products on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 64;                // steps per chunk: four 16-row m-tiles
constexpr int kMT = kQ / 16;          // m-tiles of the chunk
constexpr int kPad = 8;               // bf16 padding per shared row (16 bytes)
constexpr int kXS = kPT + kPad;       // shared row stride of x
constexpr int kGUnits = kMT * (kMT + 1) / 2;  // score tiles (i, j <= i)
constexpr int kUnits = kGUnits + kMT;         // and one carried-state tile per m-tile
constexpr int kColBlocks = kMaxN / 16 / kWarps;  // 16-column state blocks per warp
// Three blocks an SM (at most 80 registers a thread): a serve prefill at
// b=4 gives 384 blocks, which then run in one wave on 132 SMs.
constexpr int kMinBlocks = 3;
static_assert(kThreads >= 2 * kQ, "x and dA copies use two threads a step");

// Bytes of one pipeline stage: B and C rows, x rows, dA.
__host__ __device__ constexpr size_t stage_bytes(int N) {
  return 2 * sizeof(bf16) * kQ * (N + kPad) + sizeof(bf16) * kQ * kXS + sizeof(float) * kQ;
}
// Pipeline stages: two, or one when the sequence is a single chunk.
__host__ __device__ constexpr int n_stages(int S) { return S > kQ ? 2 : 1; }
// Dynamic shared memory of one bf16 block: the stages, two bf16 copies of
// the state, the units' partial y tiles, each warp's cumulative sums and
// decays.
__host__ __device__ constexpr size_t bf16_smem_bytes(int N, int S) {
  return n_stages(S) * stage_bytes(N) + 2 * sizeof(bf16) * kPT * (N + kPad) +
         sizeof(float) * kUnits * 16 * kPT + 3 * sizeof(float) * kWarps * kQ;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without registers; zeros if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one m16n8k16 tile: a row-major [16 x 16], b col-major [16 x 8].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Both bf16 halves of r times their own scale, rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t r, float lo, float hi) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return pack_bf16(v.x * lo, v.y * hi);
}

// Fragment layout of m16n8 (accumulator) tiles: lane = 4 gq + q holds
// rows gq and gq + 8 at columns 2q and 2q + 1.  Work is split into units
// of equal size, two per warp: the ten score tiles G(i, j), j <= i, of the
// chunk's four 16-step m-tiles (C_i B_j^T over N, masked, times x_j) and
// the four carried-state tiles Y(i) (C_i bf16(S)^T over N, times
// exp(cs_t)), each leaving a [16 t x 16 p] f32 partial of y in shared
// memory; and the state's 16-column blocks, whose f32 accumulators stay in
// their owning warp's registers from chunk to chunk.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_chunk_scan_bf16_kernel(const bf16* __restrict__ xdt, const float* __restrict__ dA,
                           const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                           const float* __restrict__ h0, bf16* __restrict__ y,
                           float* __restrict__ final_state, int S, int H, int P, int G,
                           int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NS = N + kPad;                       // shared row stride of B, C, state
  const size_t sb = stage_bytes(N);
  bf16* st_s = reinterpret_cast<bf16*>(smem_raw + n_stages(S) * sb);  // [2][kPT][NS]
  float* part_s = reinterpret_cast<float*>(st_s + 2 * kPT * NS);      // [kUnits][16][kPT]
  float* cs_all = part_s + kUnits * 16 * kPT;    // [kWarps][3][kQ]

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  float* cs_s = cs_all + warp * 3 * kQ;          // this warp's cumulative sums,
  float* din_s = cs_s + kQ;                      // exp(cs_t),
  float* dout_s = din_s + kQ;                    // exp(cs_last - cs_t)
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;
  const int nchunks = (S + kQ - 1) / kQ;
  const int nk = N / 16;                         // k-steps over the state size

  auto stage_b = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * sb); };
  auto stage_c = [&](int s) { return stage_b(s) + kQ * NS; };
  auto stage_x = [&](int s) { return stage_b(s) + 2 * kQ * NS; };
  auto stage_da = [&](int s) {
    return reinterpret_cast<float*>(stage_b(s) + 2 * kQ * NS + kQ * kXS);
  };

  // Copy chunk c into stage s: B, C rows in 16-byte pieces, x rows in two
  // pieces, dA one float a step.  Steps past S copy zeros.
  auto issue = [&](int c, int s) {
    const int t0 = c * kQ;
    bf16* bs = stage_b(s);
    bf16* cs = stage_c(s);
    // piece i = t * pieces + k of the [kQ, N] tile, walked without a
    // division in the loop
    const int pieces = N / 8;
    const int dt = kThreads / pieces, dk = kThreads % pieces;
    for (int t = tid / pieces, k = tid % pieces; t < kQ;) {
      const bool v = t0 + t < S;
      const size_t off = (((size_t)b * S + (v ? t0 + t : 0)) * G + g) * N + 8 * k;
      cp_async16(bs + t * NS + 8 * k, Bm + off, v);
      cp_async16(cs + t * NS + 8 * k, Cm + off, v);
      t += dt;
      k += dk;
      if (k >= pieces) {
        k -= pieces;
        ++t;
      }
    }
    if (tid < 2 * kQ) {
      const int t = tid >> 1, k = (tid & 1) * 8;
      const bool v = t0 + t < S;
      const size_t off = (((size_t)b * S + (v ? t0 + t : 0)) * H + h) * P + p0 + k;
      cp_async16(stage_x(s) + t * kXS + k, xdt + off, v);
    }
    if (tid < kQ) {
      const bool v = t0 + tid < S;
      cp_async4(stage_da(s) + tid, dA + ((size_t)b * S + (v ? t0 + tid : 0)) * H + h, v);
    }
    cp_async_commit();
  };

  issue(0, 0);

  // This warp's 16-column blocks of the [16, N] state: warp, warp + 8.
  float st[kColBlocks][2][4];
#pragma unroll
  for (int i = 0; i < kColBlocks; ++i) {
    const int n0 = (warp + kWarps * i) * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(0.f, 0.f);
        const int row = gq + 8 * r, col = n0 + 8 * j + 2 * q;
        if (n0 < N) {
          if (h0) v = *reinterpret_cast<const float2*>(h0 + state_base + (size_t)row * N + col);
          *reinterpret_cast<uint32_t*>(st_s + row * NS + col) = pack_bf16(v.x, v.y);
        }
        st[i][j][2 * r] = v.x;
        st[i][j][2 * r + 1] = v.y;
      }
    }
  }

  // ldmatrix row addresses: A tiles stored [m][k] (rows 0-15, k halves by
  // lane / 16); B tiles stored [n][k] (n rows 0-7 | 8-15 by lane / 16, k
  // halves by bit 3); the transposed loads of tiles stored [k][n] use the
  // A pattern, and of A tiles stored [k][m] the B pattern.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1;
    if (c + 1 < nchunks) {
      issue(c + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk c and the state entering it are in shared memory

    const bf16* b_s = stage_b(s);
    const bf16* c_s = stage_c(s);
    const bf16* x_s = stage_x(s);
    const bf16* sprev = st_s + s * kPT * NS;     // bf16(state entering chunk c)
    bf16* snext = st_s + (s ^ 1) * kPT * NS;     // bf16(state leaving it)
    const int t0 = c * kQ;
    const int len = min(kQ, S - t0);

    // Cumulative sum of dA over the chunk and its decays, two steps a lane.
    {
      const float* das = stage_da(s);
      const float v0 = das[2 * lane], v1 = das[2 * lane + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(kFull, incl, 31);
      const float c0 = excl + v0, c1 = c0 + v1;
      cs_s[2 * lane] = c0;
      cs_s[2 * lane + 1] = c1;
      din_s[2 * lane] = __expf(c0);
      din_s[2 * lane + 1] = __expf(c1);
      dout_s[2 * lane] = __expf(last - c0);
      dout_s[2 * lane + 1] = __expf(last - c1);
      __syncwarp();
    }

    // Units u = warp and warp + 8 of the kUnits.
    for (int u = warp; u < kUnits; u += kWarps) {
      int mi, mj;                                  // m-tile, and key block for G
      if (u < kGUnits) {
        mi = 0;
        while ((mi + 1) * (mi + 2) / 2 <= u) ++mi;
        mj = u - mi * (mi + 1) / 2;
      } else {
        mi = u - kGUnits;
        mj = -1;
      }
      if (16 * mi >= len) continue;                // rows past S: y is not stored
      const bf16* bsrc = mj >= 0 ? b_s + 16 * mj * NS : sprev;
      // [16 x 16] = C_i (B_j or bf16(S))^T over N, in two accumulator sets
      // so the chains of dependent mma are half as long
      float acc[2][2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[e][f][v] = 0.f;
      const bf16* arow = c_s + (16 * mi + a_row) * NS + a_col;
      const bf16* brow = bsrc + b_row * NS + b_col;
#pragma unroll
      for (int kk = 0; kk < nk; kk += 2) {
        uint32_t a0[4], b0[4], a1[4], b1[4];
        const bool odd = kk + 1 < nk;
        ldsm_x4(a0, arow + kk * 16);
        ldsm_x4(b0, brow + kk * 16);
        if (odd) {
          ldsm_x4(a1, arow + kk * 16 + 16);
          ldsm_x4(b1, brow + kk * 16 + 16);
        }
        mma_bf16(acc[0][0], a0, b0[0], b0[1]);
        mma_bf16(acc[0][1], a0, b0[2], b0[3]);
        if (odd) {
          mma_bf16(acc[1][0], a1, b1[0], b1[1]);
          mma_bf16(acc[1][1], a1, b1[2], b1[3]);
        }
      }
      const int r0 = 16 * mi + gq, r1 = r0 + 8;    // chunk rows of this lane
      float out[2][4];
      if (mj >= 0) {
        // decay mask, bf16(G) as the A operand of G x_j
        const float cs_r0 = cs_s[r0], cs_r1 = cs_s[r1];
        uint32_t ga[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j0 = 16 * mj + 8 * half + 2 * q, j1 = j0 + 1;
          const float c0 = cs_s[j0], c1 = cs_s[j1];
          const float g00 = acc[0][half][0] + acc[1][half][0];
          const float g01 = acc[0][half][1] + acc[1][half][1];
          const float g10 = acc[0][half][2] + acc[1][half][2];
          const float g11 = acc[0][half][3] + acc[1][half][3];
          ga[2 * half] = pack_bf16(j0 <= r0 ? g00 * __expf(cs_r0 - c0) : 0.f,
                                   j1 <= r0 ? g01 * __expf(cs_r0 - c1) : 0.f);
          ga[2 * half + 1] = pack_bf16(j0 <= r1 ? g10 * __expf(cs_r1 - c0) : 0.f,
                                       j1 <= r1 ? g11 * __expf(cs_r1 - c1) : 0.f);
        }
        // x rows j of key block mj, stored [j][p]: a transposed load
        uint32_t xb[4];
        ldsm_x4_trans(xb, x_s + (16 * mj + a_row) * kXS + a_col);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) out[nt][v] = 0.f;
        mma_bf16(out[0], ga, xb[0], xb[1]);
        mma_bf16(out[1], ga, xb[2], xb[3]);
      } else {
        const float d0 = din_s[r0], d1 = din_s[r1];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          out[nt][0] = d0 * (acc[0][nt][0] + acc[1][nt][0]);
          out[nt][1] = d0 * (acc[0][nt][1] + acc[1][nt][1]);
          out[nt][2] = d1 * (acc[0][nt][2] + acc[1][nt][2]);
          out[nt][3] = d1 * (acc[0][nt][3] + acc[1][nt][3]);
        }
      }
      float* part = part_s + u * 16 * kPT;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        *reinterpret_cast<float2*>(part + gq * kPT + 8 * nt + 2 * q) =
            make_float2(out[nt][0], out[nt][1]);
        *reinterpret_cast<float2*>(part + (gq + 8) * kPT + 8 * nt + 2 * q) =
            make_float2(out[nt][2], out[nt][3]);
      }
    }

    // S = exp(cs_last) S + bf16(x exp(cs_last - cs_t))^T B for this warp's
    // column blocks; the bf16 copy goes to the other buffer.
    if (warp * 16 < N) {
      const float decay = din_s[kQ - 1];
#pragma unroll
      for (int i = 0; i < kColBlocks; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][j][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kMT; ++kk) {
        if (16 * kk >= len) break;                 // x is zero past S
        // A = x^T [p][t]: x stored [t][p], so a transposed load, rows t.
        uint32_t xa[4];
        ldsm_x4_trans(xa, x_s + (16 * kk + b_row) * kXS + b_col);
        const int tq = 16 * kk + 2 * q;
        const float w0 = dout_s[tq], w1 = dout_s[tq + 1];
        const float w2 = dout_s[tq + 8], w3 = dout_s[tq + 9];
        xa[0] = scale_bf16x2(xa[0], w0, w1);
        xa[1] = scale_bf16x2(xa[1], w0, w1);
        xa[2] = scale_bf16x2(xa[2], w2, w3);
        xa[3] = scale_bf16x2(xa[3], w2, w3);
#pragma unroll
        for (int i = 0; i < kColBlocks; ++i) {
          const int n0 = (warp + kWarps * i) * 16;
          if (n0 < N) {
            // B rows t stored [t][n]: a transposed load gives [n][t] fragments.
            uint32_t bb[4];
            ldsm_x4_trans(bb, b_s + (16 * kk + a_row) * NS + n0 + a_col);
            mma_bf16(st[i][0], xa, bb[0], bb[1]);
            mma_bf16(st[i][1], xa, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kColBlocks; ++i) {
        const int n0 = (warp + kWarps * i) * 16;
        if (n0 < N) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<uint32_t*>(snext + (gq + 8 * r) * NS + n0 + 8 * j + 2 * q) =
                  pack_bf16(st[i][j][2 * r], st[i][j][2 * r + 1]);
        }
      }
    }
    __syncthreads();   // every unit's partial is written; stage s is read

    // y[t][p] = sum_{j <= i} G(i, j) + Y(i) for t in m-tile i, four p a
    // thread, stored in bf16.
    {
      const int t = tid >> 2, pq = (tid & 3) * 4;
      const int mi = t >> 4, tl = t & 15;
      if (t < len) {
        float4 acc = *reinterpret_cast<const float4*>(part_s + ((kGUnits + mi) * 16 + tl) * kPT + pq);
        const int u0 = mi * (mi + 1) / 2;
        for (int j = 0; j <= mi; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(part_s + ((u0 + j) * 16 + tl) * kPT + pq);
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        uint2 packed;
        packed.x = pack_bf16(acc.x, acc.y);
        packed.y = pack_bf16(acc.z, acc.w);
        *reinterpret_cast<uint2*>(y + (((size_t)b * S + t0 + t) * H + h) * P + p0 + pq) = packed;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kColBlocks; ++i) {
    const int n0 = (warp + kWarps * i) * 16;
    if (n0 < N) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(final_state + state_base + (size_t)(gq + 8 * r) * N + n0 +
                                     8 * j + 2 * q) =
              make_float2(st[i][j][2 * r], st[i][j][2 * r + 1]);
    }
  }
}

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const float*, const T*, const T*, const float*, T*,
                                  float*, int, int, int, int, int),
                   size_t max_smem, size_t smem_bytes, int threads, const void* xdt,
                   const void* dA, const void* B, const void* C, const void* h0, void* y,
                   void* fin, int batch, int S, int H, int P, int G, int N, cudaStream_t st) {
  // Once per device and kernel (one kernel per T): allow the largest
  // dynamic shared memory any launch of it asks for, and take all of the
  // unified L1/shared storage as shared memory (two or more bf16 blocks an
  // SM at N = 128).  Devices past the 64th are set up at every launch.
  static std::atomic<uint64_t> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(P / kPT, H, batch);
  kernel<<<grid, threads, smem_bytes, st>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(dA), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(fin), S, H, P, G, N);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;             // backward chunk: one warp's lanes
constexpr int kBQS = kBQ + kPad;    // bf16 row stride of [*, kBQ] tiles
constexpr int kFQ = kBQ + 1;        // f32 row stride of [kBQ, kBQ] tiles
constexpr int kStWarps = 4;         // states kernel
constexpr int kStThreads = 32 * kStWarps;
constexpr int kChWarps = 8;         // chunk kernel
constexpr int kChThreads = 32 * kChWarps;
constexpr int kBwdStages = 3;       // copies in flight: two ahead of the one computed on
// Warps that split a state's 16-column blocks: the states kernel's four,
// and the chunk kernel's four pairs (one warp a 16-row m-tile).
constexpr int kColWarps = 4;

// bf16 planes a value of T is held in on the tensor cores: bf16 is exact
// in one; f32 is split into hi = bf16(v) and lo = bf16(v - hi).
template <typename T> struct Planes;
template <> struct Planes<bf16> { static constexpr int n = 1; };
template <> struct Planes<float> { static constexpr int n = 2; };

__device__ __forceinline__ void stf(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(bf16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }
// Two neighbours at an even index.
__device__ __forceinline__ void st2(float* p, size_t i, float a, float b) {
  p[i] = a;
  p[i + 1] = b;
}
__device__ __forceinline__ void st2(bf16* p, size_t i, float a, float b) {
  *reinterpret_cast<uint32_t*>(p + i) = pack_bf16(a, b);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}
// (a, b) as a bf16 pair hi and the pair of what hi leaves out, lo.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}
// Sum of an operand's planes, scaled by (s0, s1) per half and split again.
template <int NPL>
__device__ __forceinline__ void rescale_split(const uint32_t (&r)[NPL][4], const float (&s)[4][2],
                                              uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 v = unpack_bf16(r[0][e]);
    if (NPL == 2) {
      const float2 w = unpack_bf16(r[NPL - 1][e]);
      v.x += w.x;
      v.y += w.y;
    }
    split_bf16(v.x * s[e][0], v.y * s[e][1], hi[e], lo[e]);
  }
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b over the operands' planes, all pairs but lo x lo.
template <int NA, int NB>
__device__ __forceinline__ void mma_planes(float (&d)[4], const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < 2) mma_bf16(d, a[i], b[j][0], b[j][1]);
}

// Rows [0, rows) of a tile `cols` wide (a multiple of 8) into shared
// memory, row stride ds: row r from src + r * stride, zeros for rows
// r >= len and columns >= valid.  bf16 goes through 16-byte cp.async
// (valid % 8 == 0) into one plane; f32 through registers, split into the
// planes dst (hi) and dst + pstride (lo).
__device__ __forceinline__ void load_tile(bf16* dst, int, int ds, const bf16* src, size_t stride,
                                          int rows, int len, int cols, int valid, int tid,
                                          int nthreads) {
  const int pieces = cols / 8;
  const int dr = nthreads / pieces, dk = nthreads % pieces * 8;
  for (int r = tid / pieces, k = tid % pieces * 8; r < rows;) {
    const bool v = r < len && k < valid;
    cp_async16(dst + r * ds + k, src + (v ? r * stride + k : 0), v);
    r += dr;
    k += dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
}
__device__ __forceinline__ void load_tile(bf16* dst, int pstride, int ds, const float* src,
                                          size_t stride, int rows, int len, int cols, int valid,
                                          int tid, int nthreads) {
  const int pieces = cols / 8;
  for (int i = tid; i < rows * pieces; i += nthreads) {
    const int r = i / pieces, k = (i % pieces) * 8;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = k + 2 * e;
      const float a = r < len && c < valid ? src[r * stride + c] : 0.f;
      const float b = r < len && c + 1 < valid ? src[r * stride + c + 1] : 0.f;
      split_bf16(a, b, hi[e], lo[e]);
    }
    *reinterpret_cast<uint4*>(dst + r * ds + k) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + pstride + r * ds + k) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Inclusive cumulative sum of a chunk's dA across a warp's lanes.
__device__ __forceinline__ float warp_cumsum(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// A warp's [16 x 16] bf16 tile held as m16n8 accumulator pairs (w[j][r]:
// n8 tile j, row gq + 8 r, columns 2q and 2q + 1) stored as 16-byte
// pieces: the four lanes of a quad trade words so that lane q holds row
// gq + 8 (q >> 1), columns 8 (q & 1) .. + 7.  The store is marked
// streaming (evict first): the states are read once, by the next kernel.
__device__ __forceinline__ void store_tile16(bf16* dst, size_t row_stride,
                                             const uint32_t (&w)[2][2]) {
  const int lane = threadIdx.x & 31, q = lane & 3, gq = lane >> 2;
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = q ^ k;               // the lane this word goes to
    const uint32_t send = t == 0 ? w[0][0] : t == 1 ? w[1][0] : t == 2 ? w[0][1] : w[1][1];
    v[k] = __shfl_xor_sync(kFull, send, k);   // columns 2 (q ^ k) of the target's piece
  }
  auto pick = [&](int m) {             // the word of columns 2m: v[m ^ q]
    const int k = m ^ q;
    return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
  };
  const bf16* p = dst + (size_t)(gq + 8 * (q >> 1)) * row_stride + 8 * (q & 1);
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(pick(0)),
               "r"(pick(1)), "r"(pick(2)), "r"(pick(3))
               : "memory");
}

// Scratch: per (chunk, batch, head) a [2][P][NP] bf16 block, the hi and
// lo planes of a [P, NP] f32 state (NP = N rounded up to 16, zeros past
// N).  Chunk-major, so that the states kernel's blocks, which walk the
// chunks in step, write one contiguous region at a time.
__host__ __device__ __forceinline__ size_t state_slot(int c, int b, int h, int batch, int H, int P,
                                                      int NP) {
  return (((size_t)c * batch + b) * H + h) * 2 * (size_t)P * NP;
}

// Row stride of the states kernel's x (or dy) tile, 16 m-tiles columns wide.
__host__ __device__ constexpr int states_xs(int mtiles) { return 16 * mtiles + kPad; }

template <typename T, int kMTiles>
__host__ __device__ constexpr size_t bwd_states_stage_bytes(int NP) {
  return sizeof(bf16) * Planes<T>::n * kBQ * ((NP + kPad) + states_xs(kMTiles)) +
         sizeof(float) * kBQ;
}

// 1. The chunk-to-chunk pass.  Block (16 kMTiles-row p-tile, head, batch x
// walk): walk 0 carries the state forward, S_in[c+1] = e^{cs_last} S_in[c]
// + (x o e^{cs_last-cs_t})^T B, and stores each chunk's entering state;
// walk 1 carries the adjoint backward, dS_out[c-1] = e^{cs_last} dS_out[c]
// + (dy o e^{cs_t})^T C, stores each chunk's outgoing adjoint, and dh0.
// The increment is a [16 kMTiles x 32] . [32 x NP] product on the tensor
// cores: warp w keeps the 16-column blocks w, w + 4, ... of the kMTiles
// m-tiles of the f32 state in its mma accumulators; the decay-weighted x
// (or dy) is split into hi and lo bf16 planes.  B, C, x, dy and dA of the
// next two chunks are copied while a chunk computes.  Nothing is divided
// by a decay.
template <typename T, int kCB, int kMTiles>
__global__ void __launch_bounds__(kStThreads)
ssd_bwd_states_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ h0, const T* __restrict__ dy,
                      const float* __restrict__ d_final, bf16* __restrict__ states,
                      bf16* __restrict__ dstates, float* __restrict__ dh0, int S, int H, int P,
                      int G, int N, int NP) {
  constexpr int NPL = Planes<T>::n;
  constexpr int XS = states_xs(kMTiles);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NS = NP + kPad;
  const size_t sb = bwd_states_stage_bytes<T, kMTiles>(NP);
  auto stage_rows = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * sb); };
  auto stage_vec = [&](int s) { return stage_rows(s) + NPL * kBQ * NS; };
  auto stage_da = [&](int s) { return reinterpret_cast<float*>(stage_vec(s) + NPL * kBQ * XS); };

  const int p0 = blockIdx.x * 16 * kMTiles, h = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool fwd = (blockIdx.z & 1) == 0;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int nc = (S + kBQ - 1) / kBQ;
  const T* rows = fwd ? Bm : Cm;
  const T* vec = fwd ? xdt : dy;
  const float* init = fwd ? h0 : d_final;
  bf16* out = fwd ? states : dstates;
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;   // [b,h,P,N] f32 tiles

  auto issue = [&](int c, int s) {
    const int t0 = c * kBQ, len = min(kBQ, S - t0);
    load_tile(stage_rows(s), kBQ * NS, NS, rows + ((size_t)b * S + t0) * G * N + (size_t)g * N,
              (size_t)G * N, kBQ, len, NP, N, tid, kStThreads);
    load_tile(stage_vec(s), kBQ * XS, XS, vec + (((size_t)b * S + t0) * H + h) * P + p0,
              (size_t)H * P, kBQ, len, 16 * kMTiles, 16 * kMTiles, tid, kStThreads);
    if (tid < kBQ) {
      const bool v = tid < len;
      cp_async4(stage_da(s) + tid, dA + ((size_t)b * S + (v ? t0 + tid : 0)) * H + h, v);
    }
    cp_async_commit();
  };

  float st[kCB][kMTiles][2][4];   // [16-column block][m-tile][n8][frag]
#pragma unroll
  for (int i = 0; i < kCB; ++i) {
    const int n0 = (warp + kColWarps * i) * 16;
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * m + gq + 8 * (e >> 1), col = n0 + 8 * j + 2 * q + (e & 1);
          st[i][m][j][e] = init && col < N ? init[state_base + (size_t)row * N + col] : 0.f;
        }
  }

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  auto chunk_of = [&](int k) { return fwd ? k : nc - 1 - k; };
  issue(chunk_of(0), 0);
  if (nc > 1) issue(chunk_of(1), 1);
  for (int k = 0; k < nc; ++k) {
    const int c = chunk_of(k), s = k % kBwdStages;
    // the state entering chunk c (walk 0) or the adjoint leaving it (walk 1)
    const size_t slot = state_slot(c, b, h, gridDim.z >> 1, H, P, NP) + (size_t)p0 * NP;
#pragma unroll
    for (int i = 0; i < kCB; ++i) {
      const int n0 = (warp + kColWarps * i) * 16;
      if (n0 < NP)
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          uint32_t hi[2][2], lo[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              split_bf16(st[i][m][j][2 * r], st[i][m][j][2 * r + 1], hi[j][r], lo[j][r]);
          const size_t off = slot + (size_t)16 * m * NP + n0;
          store_tile16(out + off, NP, hi);
          store_tile16(out + off + (size_t)P * NP, NP, lo);
        }
    }
    if (k + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();   // chunk c is in stage s; every warp is done with stage (k + 2) % 3
    if (k + 2 < nc) issue(chunk_of(k + 2), (k + 2) % kBwdStages);

    // decays: e^{cs_last - cs_t} weights x (walk 0), e^{cs_t} weights dy (walk 1)
    const float cs = warp_cumsum(stage_da(s)[lane]);
    const float last = __shfl_sync(kFull, cs, kBQ - 1);
    const float wt = expf(fwd ? last - cs : cs);
    const float decay = expf(last);
    const bf16* rs = stage_rows(s);
    const bf16* vs = stage_vec(s);
#pragma unroll
    for (int i = 0; i < kCB; ++i)
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][m][j][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      // A = (vec o wt)^T [p][t]: vec stored [t][p], a transposed load
      const int tq = 16 * kk + 2 * q;
      const float w0 = __shfl_sync(kFull, wt, tq), w1 = __shfl_sync(kFull, wt, tq + 1);
      const float w2 = __shfl_sync(kFull, wt, tq + 8), w3 = __shfl_sync(kFull, wt, tq + 9);
      const float sc[4][2] = {{w0, w1}, {w0, w1}, {w2, w3}, {w2, w3}};
      uint32_t ahi[kMTiles][1][4], alo[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        uint32_t va[NPL][4];
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl)
          ldsm_x4_trans(va[pl], vs + pl * kBQ * XS + (16 * kk + b_row) * XS + 16 * m + b_col);
        rescale_split<NPL>(va, sc, ahi[m][0], alo[m]);
      }
#pragma unroll
      for (int i = 0; i < kCB; ++i) {
        const int n0 = (warp + kColWarps * i) * 16;
        if (n0 < NP) {
          // rows (B or C) stored [t][n]: a transposed load gives [n][t] fragments
          uint32_t rb[NPL][4];
#pragma unroll
          for (int pl = 0; pl < NPL; ++pl)
            ldsm_x4_trans(rb[pl], rs + pl * kBQ * NS + (16 * kk + a_row) * NS + n0 + a_col);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t bf[NPL][2];
#pragma unroll
            for (int pl = 0; pl < NPL; ++pl) {
              bf[pl][0] = rb[pl][2 * j];
              bf[pl][1] = rb[pl][2 * j + 1];
            }
#pragma unroll
            for (int m = 0; m < kMTiles; ++m) {
              mma_planes<1, NPL>(st[i][m][j], ahi[m], bf);
              mma_bf16(st[i][m][j], alo[m], bf[0][0], bf[0][1]);
            }
          }
        }
      }
    }
  }
  if (!fwd && dh0)
#pragma unroll
    for (int i = 0; i < kCB; ++i) {
      const int n0 = (warp + kColWarps * i) * 16;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * m + gq + 8 * (e >> 1), col = n0 + 8 * j + 2 * q + (e & 1);
            if (col < N) dh0[state_base + (size_t)row * N + col] = st[i][m][j][e];
          }
    }
}

// Shared memory of one chunk-kernel block, in order: B and C of the chunk
// [NPL][kBQ][NS]; two stages of {x, dy [NPL][kBQ][kXS], S_in and dS_out
// planes [2][kPT][NS], each warp's dA [kChWarps][kBQ] f32}; Gm^T (then
// sum M) hi/lo [2][kBQ][kBQS]; C B^T, dy x^T and sum M [kBQ][kFQ] f32; the
// per-head partial sums.
template <typename T>
__host__ __device__ constexpr size_t bwd_chunk_stage_bytes(int NP) {
  return sizeof(bf16) * (2 * Planes<T>::n * kBQ * kXS + 4 * kPT * (NP + kPad)) +
         sizeof(float) * kChWarps * kBQ;
}
template <typename T>
__host__ __device__ constexpr size_t bwd_chunk_smem_bytes(int NP) {
  return sizeof(bf16) * 2 * Planes<T>::n * kBQ * (NP + kPad) +
         kBwdStages * bwd_chunk_stage_bytes<T>(NP) +
         sizeof(bf16) * 2 * kBQ * kBQS + sizeof(float) * 3 * kBQ * kFQ +
         sizeof(float) * (kBQ + kChWarps * kBQ + 2 * kBQ + 2 * kBQ + kChWarps);
}

// 2. Per (chunk, group, batch), over the group's heads in order and each
// head's 16-row p-tiles: dx, ddA, and dB and dC summed over the heads.
// With Gm = e^{cs_t-cs_j} C_t.B_j and M = e^{cs_t-cs_j} dy_t.x_j (j <= t):
//   dx_j   = (Gm^T dy)_j + e^{cs_last-cs_j} V_j,      V = B dS_out^T
//   dB     = (sum_h M)^T C + sum_h (e^{cs_last-cs_j} x) dS_out
//   dC     = (sum_h M) B + sum_h (e^{cs_t} dy) S_in
//   dcs_k  = sum_j Gm_kj dyx_kj - sum_t Gm_tk dyx_tk + e^{cs_k} dy_k.W_k
//            - e^{cs_last-cs_k} x_k.V_k,              W = C S_in^T
// and at the chunk's last step sum_j e^{cs_last-cs_j} x_j.V_j +
// e^{cs_last} <dS_out, S_in>; ddA is the sum of dcs from the end.  Every
// product is an mma.  Per p-tile warps 0-3 add to the [32 x NP] dB
// accumulators and warps 4-7 to dC's, in registers (warp w: m-tile w & 1,
// 16-column blocks (w >> 1 & 1) + 2 k); warps 0-3 also each take an
// [16 x 8] tile of V with the matching tile of Gm^T dy (so dx) and of x.V,
// warps 4-7 a tile of W with dy.W and a pair of dy x^T tiles.  At a head's
// end all warps take the [32 x 32] decay mask, M, its head sum and the
// pair terms' row and column sums, and one warp the 32-step scan into ddA.
template <typename T, int kCB>
__global__ void __launch_bounds__(kChThreads, 2)
ssd_bwd_chunk_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const T* __restrict__ dy, const bf16* __restrict__ states,
                     const bf16* __restrict__ dstates, T* __restrict__ dxdt,
                     float* __restrict__ ddA, T* __restrict__ dB, T* __restrict__ dC, int S,
                     int H, int P, int G, int N, int NP) {
  constexpr int NPL = Planes<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NS = NP + kPad;
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);          // [NPL][kBQ][NS]
  bf16* c_s = b_s + NPL * kBQ * NS;                       // [NPL][kBQ][NS]
  unsigned char* stages = reinterpret_cast<unsigned char*>(c_s + NPL * kBQ * NS);
  const size_t sb = bwd_chunk_stage_bytes<T>(NP);
  bf16* gmt_s = reinterpret_cast<bf16*>(stages + kBwdStages * sb);  // [2][kBQ][kBQS]
  float* cb_s = reinterpret_cast<float*>(gmt_s + 2 * kBQ * kBQS);  // [kBQ][kFQ] C B^T
  float* dyx_s = cb_s + kBQ * kFQ;                        // [kBQ][kFQ] dy x^T
  float* summ_s = dyx_s + kBQ * kFQ;                      // [kBQ][kFQ] sum over heads of M
  float* rowp_s = summ_s + kBQ * kFQ;                     // [kBQ] pair terms' row sums
  float* colp_s = rowp_s + kBQ;                           // [kChWarps][kBQ] their column sums
  float* bvp_s = colp_s + kChWarps * kBQ;                 // [2][kBQ] x.V by column half
  float* cup_s = bvp_s + 2 * kBQ;                         // [2][kBQ] dy.W by column half
  float* dotp_s = cup_s + 2 * kBQ;                        // [kChWarps] <dS_out, S_in>
  auto stage_x = [&](int s) { return reinterpret_cast<bf16*>(stages + s * sb); };
  auto stage_y = [&](int s) { return stage_x(s) + NPL * kBQ * kXS; };
  auto stage_si = [&](int s) { return stage_y(s) + NPL * kBQ * kXS; };   // [2][kPT][NS]
  auto stage_so = [&](int s) { return stage_si(s) + 2 * kPT * NS; };     // [2][kPT][NS]
  auto stage_da = [&](int s) { return reinterpret_cast<float*>(stage_so(s) + 2 * kPT * NS); };

  const int c = blockIdx.x, gi = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int t0 = c * kBQ, len = min(kBQ, S - t0);
  const int hpg = H / G, npt = P / kPT, iters = hpg * npt;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

  // Iteration i: head gi * hpg + i / npt, p-tile i % npt.
  auto issue = [&](int i, int s) {
    const int h = gi * hpg + i / npt, pt = i % npt, p0 = pt * kPT;
    const size_t xoff = (((size_t)b * S + t0) * H + h) * P + p0;
    load_tile(stage_x(s), kBQ * kXS, kXS, xdt + xoff, (size_t)H * P, kBQ, len, kPT, kPT, tid,
              kChThreads);
    load_tile(stage_y(s), kBQ * kXS, kXS, dy + xoff, (size_t)H * P, kBQ, len, kPT, kPT, tid,
              kChThreads);
    const size_t slot = state_slot(c, b, h, gridDim.z, H, P, NP) + (size_t)p0 * NP;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      load_tile(stage_si(s) + pl * kPT * NS, 0, NS, states + slot + (size_t)pl * P * NP, NP, kPT,
                kPT, NP, NP, tid, kChThreads);
      load_tile(stage_so(s) + pl * kPT * NS, 0, NS, dstates + slot + (size_t)pl * P * NP, NP, kPT,
                kPT, NP, NP, tid, kChThreads);
    }
    if (pt == 0) {   // each lane copies the dA it will read itself
      const bool v = lane < len;
      cp_async4(stage_da(s) + warp * kBQ + lane,
                dA + ((size_t)b * S + (v ? t0 + lane : 0)) * H + h, v);
    }
    cp_async_commit();
  };

  const size_t bc_off = ((size_t)b * S + t0) * G * N + (size_t)gi * N;
  load_tile(b_s, kBQ * NS, NS, Bm + bc_off, (size_t)G * N, kBQ, len, NP, N, tid, kChThreads);
  load_tile(c_s, kBQ * NS, NS, Cm + bc_off, (size_t)G * N, kBQ, len, NP, N, tid, kChThreads);
  issue(0, 0);
  if (iters > 1) {
    issue(1, 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  // C B^T [t][j] over NP: warps 0-3, one [16 x 16] tile each
  if (warp < 4) {
    const int m = warp >> 1, nb = warp & 1;
    float acc[2][4] = {};
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t ca[NPL][4], bb[NPL][4];
#pragma unroll
      for (int pl = 0; pl < NPL; ++pl) {
        ldsm_x4(ca[pl], c_s + pl * kBQ * NS + (16 * m + a_row) * NS + 16 * kk + a_col);
        ldsm_x4(bb[pl], b_s + pl * kBQ * NS + (16 * nb + b_row) * NS + 16 * kk + b_col);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[NPL][2];
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl) {
          bf[pl][0] = bb[pl][2 * j];
          bf[pl][1] = bb[pl][2 * j + 1];
        }
        mma_planes<NPL, NPL>(acc[j], ca, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cb_s[(16 * m + gq + 8 * (e >> 1)) * kFQ + 16 * nb + 8 * j + 2 * q + (e & 1)] = acc[j][e];
  }
  // this thread's four elements of the [kBQ, kBQ] tiles: row pt_t, columns pt_j..+3
  const int pt_t = tid >> 3, pt_j = (tid & 7) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) summ_s[pt_t * kFQ + pt_j + e] = 0.f;
  __syncthreads();   // C B^T is complete

  // This warp's share of dB (wmat 0) or dC (wmat 1): m-tile wm, 16-column
  // blocks wc + 2 k; acc[block][n8][frag]
  const int wmat = warp >> 2, wm = warp & 1, wc = (warp >> 1) & 1, r_m = 16 * wm + gq;
  float acc[2 * kCB][2][4] = {};
  float cs = 0.f, din = 0.f, dout = 0.f, dlast = 0.f;     // lane t's decays of the head
  float red[2] = {}, dot = 0.f;                           // per-head partials
  float dyxa[2][4] = {};                                  // warps 4-7: dy x^T tiles
  const int um = (warp & 3) >> 1, un = warp & 1;          // this warp's [16 x 8] unit
  // the dot's stride over a p-tile's [kPT][NP] planes, in 8-column pieces
  const int drow = kChThreads / (NP / 8), dcol = kChThreads % (NP / 8) * 8;

  for (int i = 0; i < iters; ++i) {
    const int s = i % kBwdStages, pt = i % npt, h = gi * hpg + i / npt, p0 = pt * kPT;
    if (i + 1 < iters)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    if (pt == 0) {
      // head start: decays from this warp's own copy of dA, and Gm^T split
      cs = warp_cumsum(stage_da(s)[warp * kBQ + lane]);
      const float last = __shfl_sync(kFull, cs, kBQ - 1);
      din = expf(cs);
      dout = expf(last - cs);
      dlast = expf(last);
      const float cs_t = __shfl_sync(kFull, cs, pt_t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = pt_j + e;
        const float cs_j = __shfl_sync(kFull, cs, j);
        const float gm = j <= pt_t ? cb_s[pt_t * kFQ + j] * expf(cs_t - cs_j) : 0.f;
        const bf16 hi = __float2bfloat16_rn(gm);
        gmt_s[j * kBQS + pt_t] = hi;
        gmt_s[kBQ * kBQS + j * kBQS + pt_t] = __float2bfloat16_rn(gm - __bfloat162float(hi));
      }
      red[0] = red[1] = dot = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) dyxa[m][e] = 0.f;
    }
    __syncthreads();   // stage s and Gm^T are in place; stage (i + 2) % 3 is free
    if (i + 2 < iters) issue(i + 2, (i + 2) % kBwdStages);
    const bf16* xs = stage_x(s);
    const bf16* ys = stage_y(s);
    const bf16* si = stage_si(s);
    const bf16* so = stage_so(s);

    // dB += (dout o x) dS_out (warps 0-3), dC += (din o dy) S_in (warps
    // 4-7) over this p-tile, for this warp's m-tile and 16-column blocks
    {
      const float w0 = __shfl_sync(kFull, wmat ? din : dout, r_m);
      const float w1 = __shfl_sync(kFull, wmat ? din : dout, r_m + 8);
      const float sc[4][2] = {{w0, w0}, {w1, w1}, {w0, w0}, {w1, w1}};
      const bf16* va = wmat ? ys : xs;
      const bf16* sv = wmat ? si : so;
      uint32_t a[NPL][4], ah[1][4], al[4];
#pragma unroll
      for (int pl = 0; pl < NPL; ++pl)
        ldsm_x4(a[pl], va + pl * kBQ * kXS + (16 * wm + a_row) * kXS + a_col);
      rescale_split<NPL>(a, sc, ah[0], al);
#pragma unroll
      for (int k = 0; k < 2 * kCB; ++k) {
        const int n0 = (wc + 2 * k) * 16;
        if (n0 < NP) {
          uint32_t stb[2][4];   // dS_out or S_in [p][n]: [plane][frag]
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
            ldsm_x4_trans(stb[pl], sv + pl * kPT * NS + a_row * NS + n0 + a_col);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t bf[2][2] = {{stb[0][2 * j], stb[0][2 * j + 1]},
                                       {stb[1][2 * j], stb[1][2 * j + 1]}};
            mma_planes<1, 2>(acc[k][j], ah, bf);
            mma_bf16(acc[k][j], al, bf[0][0], bf[0][1]);
          }
        }
      }
    }

    // This warp's [16 x 8] unit: rows um (16 steps), columns un (8 of the p-tile).
    {
      const bf16* rows = warp < 4 ? b_s : c_s;      // V = B dS_out^T, W = C S_in^T
      const bf16* st = warp < 4 ? so : si;
      float uacc[2][4] = {};
      const bf16* ra0 = rows + (16 * um + a_row) * NS + a_col;
      const bf16* sb0 = st + (8 * un + (lane & 7)) * NS + ((lane >> 3) & 1) * 8;
      for (int kk = 0; kk < NP / 16; kk += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {     // two k-steps into two accumulators
          if (u == 0 || kk + 1 < NP / 16) {
            uint32_t ra[NPL][4], sbf[2][2];
#pragma unroll
            for (int pl = 0; pl < NPL; ++pl)
              ldsm_x4(ra[pl], ra0 + pl * kBQ * NS + 16 * (kk + u));
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) ldsm_x2(sbf[pl], sb0 + pl * kPT * NS + 16 * (kk + u));
            mma_planes<NPL, 2>(uacc[u], ra, sbf);
          }
        }
      }
      const int r0 = 16 * um + gq, col = 8 * un + 2 * q;
      const bf16* vin = warp < 4 ? xs : ys;        // x.V or dy.W
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = uacc[0][e] + uacc[1][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(vin + (r0 + 8 * r) * kXS + col));
        if (NPL == 2) {
          const float2 w = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(vin + kBQ * kXS + (r0 + 8 * r) * kXS + col));
          xv.x += w.x;
          xv.y += w.y;
        }
        red[r] = fmaf(xv.x, v[2 * r], fmaf(xv.y, v[2 * r + 1], red[r]));
      }
      if (warp < 4) {
        // dx = Gm^T dy + dout o V for this unit
        float dx[4] = {};
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk) {
          uint32_t ga[2][4], yb[NPL][2];
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
            ldsm_x4(ga[pl], gmt_s + pl * kBQ * kBQS + (16 * um + a_row) * kBQS + 16 * kk + a_col);
#pragma unroll
          for (int pl = 0; pl < NPL; ++pl)
            ldsm_x2_trans(yb[pl], ys + pl * kBQ * kXS + (16 * kk + (lane & 15)) * kXS + 8 * un);
          mma_planes<2, NPL>(dx, ga, yb);
        }
        const float o0 = __shfl_sync(kFull, dout, r0), o1 = __shfl_sync(kFull, dout, r0 + 8);
        const size_t base = (((size_t)b * S + t0 + r0) * H + h) * P + p0 + col;
        if (r0 < len) st2(dxdt, base, fmaf(o0, v[0], dx[0]), fmaf(o0, v[1], dx[1]));
        if (r0 + 8 < len)
          st2(dxdt, base + (size_t)8 * H * P, fmaf(o1, v[2], dx[2]), fmaf(o1, v[3], dx[3]));
      } else {
        // dy x^T [t][j] += over this p-tile: m-tile um, key columns 16 un .. +16
        uint32_t ya[NPL][4], xb[NPL][4];
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl) {
          ldsm_x4(ya[pl], ys + pl * kBQ * kXS + (16 * um + a_row) * kXS + a_col);
          ldsm_x4(xb[pl], xs + pl * kBQ * kXS + (16 * un + b_row) * kXS + b_col);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[NPL][2];
#pragma unroll
          for (int pl = 0; pl < NPL; ++pl) {
            bf[pl][0] = xb[pl][2 * j];
            bf[pl][1] = xb[pl][2 * j + 1];
          }
          mma_planes<NPL, NPL>(dyxa[j], ya, bf);
        }
      }
    }

    // <dS_out, S_in> over the p-tile, eight elements (16 bytes a plane) a step
    for (int e = tid, row = tid / (NP / 8), col = tid % (NP / 8) * 8; e < kPT * NP / 8;
         e += kChThreads) {
      const int o = row * NS + col;
      const uint4 a = *reinterpret_cast<const uint4*>(si + o);
      const uint4 a2 = *reinterpret_cast<const uint4*>(si + kPT * NS + o);
      const uint4 d = *reinterpret_cast<const uint4*>(so + o);
      const uint4 d2 = *reinterpret_cast<const uint4*>(so + kPT * NS + o);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, a2v[4] = {a2.x, a2.y, a2.z, a2.w};
      const uint32_t dv[4] = {d.x, d.y, d.z, d.w}, d2v[4] = {d2.x, d2.y, d2.z, d2.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 sa = unpack_bf16(av[k]), sl = unpack_bf16(a2v[k]);
        const float2 da = unpack_bf16(dv[k]), dl = unpack_bf16(d2v[k]);
        dot = fmaf(sa.x + sl.x, da.x + dl.x, fmaf(sa.y + sl.y, da.y + dl.y, dot));
      }
      row += drow;
      col += dcol;
      if (col >= NP) {
        col -= NP;
        ++row;
      }
    }

    if (pt == npt - 1) {
      // head end: publish the partials
      if (warp >= 4)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dyx_s[(16 * um + gq + 8 * (e >> 1)) * kFQ + 16 * un + 8 * j + 2 * q + (e & 1)] =
                dyxa[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red[r] += __shfl_xor_sync(kFull, red[r], 1);
        red[r] += __shfl_xor_sync(kFull, red[r], 2);
      }
      if (q == 0) {
        float* dst = (warp < 4 ? bvp_s : cup_s) + un * kBQ;
        dst[16 * um + gq] = red[0];
        dst[16 * um + gq + 8] = red[1];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
      if (lane == 0) dotp_s[warp] = dot;
      __syncthreads();
      // decay mask, M into its head sum, the pair terms' row and column sums
      {
        const float cs_t = __shfl_sync(kFull, cs, pt_t);
        float row = 0.f, colv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = pt_j + e;
          const float cs_j = __shfl_sync(kFull, cs, j);
          const float l = j <= pt_t ? expf(cs_t - cs_j) : 0.f;
          const float d = dyx_s[pt_t * kFQ + j];
          summ_s[pt_t * kFQ + j] = fmaf(l, d, summ_s[pt_t * kFQ + j]);
          const float pr = l * cb_s[pt_t * kFQ + j] * d;
          row += pr;
          colv[e] = pr;
        }
#pragma unroll
        for (int off = 1; off < 8; off *= 2) row += __shfl_xor_sync(kFull, row, off);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          colv[e] += __shfl_xor_sync(kFull, colv[e], 8);
          colv[e] += __shfl_xor_sync(kFull, colv[e], 16);
        }
        if ((tid & 7) == 0) rowp_s[pt_t] = row;
        if (lane < 8)
#pragma unroll
          for (int e = 0; e < 4; ++e) colp_s[warp * kBQ + pt_j + e] = colv[e];
      }
      __syncthreads();
      if (warp == 0) {
        const int k = lane;
        float col = 0.f, dsum = 0.f;
#pragma unroll
        for (int w = 0; w < kChWarps; ++w) {
          col += colp_s[w * kBQ + k];
          dsum += dotp_s[w];
        }
        const float v = dout * (bvp_s[k] + bvp_s[kBQ + k]);
        float vsum = v;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) vsum += __shfl_xor_sync(kFull, vsum, off);
        float dcs = rowp_s[k] - col + din * (cup_s[k] + cup_s[kBQ + k]) - v;
        if (k == kBQ - 1) dcs += vsum + dlast * dsum;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float down = __shfl_down_sync(kFull, dcs, off);
          if (k + off < 32) dcs += down;
        }
        if (k < len) ddA[((size_t)b * S + t0 + k) * H + h] = dcs;
      }
    }
  }

  // dB += (sum M)^T C, dC += (sum M) B, with sum M split into hi and lo
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = summ_s[pt_t * kFQ + pt_j + e];
    const bf16 hi = __float2bfloat16_rn(v);
    gmt_s[pt_t * kBQS + pt_j + e] = hi;
    gmt_s[kBQ * kBQS + pt_t * kBQS + pt_j + e] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
  __syncthreads();
  const bf16* rows = wmat ? b_s : c_s;        // dB = (sum M)^T C, dC = (sum M) B
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk) {
    uint32_t ma[2][4];
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const bf16* mp = gmt_s + pl * kBQ * kBQS;
      if (wmat)      // sum M [t][j] as it lies
        ldsm_x4(ma[pl], mp + (16 * wm + a_row) * kBQS + 16 * kk + a_col);
      else           // (sum M)^T [j][t]: stored [t][j], a transposed load
        ldsm_x4_trans(ma[pl], mp + (16 * kk + b_row) * kBQS + 16 * wm + b_col);
    }
#pragma unroll
    for (int k = 0; k < 2 * kCB; ++k) {
      const int n0 = (wc + 2 * k) * 16;
      if (n0 < NP) {
        uint32_t rb[NPL][4];
#pragma unroll
        for (int pl = 0; pl < NPL; ++pl)
          ldsm_x4_trans(rb[pl], rows + pl * kBQ * NS + (16 * kk + a_row) * NS + n0 + a_col);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bf[NPL][2];
#pragma unroll
          for (int pl = 0; pl < NPL; ++pl) {
            bf[pl][0] = rb[pl][2 * j];
            bf[pl][1] = rb[pl][2 * j + 1];
          }
          mma_planes<2, NPL>(acc[k][j], ma, bf);
        }
      }
    }
  }
  T* dst = wmat ? dC : dB;
#pragma unroll
  for (int k = 0; k < 2 * kCB; ++k) {
    const int n0 = (wc + 2 * k) * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_m + 8 * (e >> 1), col = n0 + 8 * j + 2 * q + (e & 1);
        if (row < len && col < N) stf(dst, bc_off + (size_t)row * G * N + col, acc[k][j][e]);
      }
  }
}

template <typename T, int kCB, int kMTiles>
cudaError_t launch_bwd(const void* xdt, const void* dA, const void* B, const void* C,
                       const void* h0, const void* dy, const void* d_final, void* dxdt, void* ddA,
                       void* dB, void* dC, void* dh0, void* states, void* dstates, int batch,
                       int S, int H, int P, int G, int N, int NP, cudaStream_t st) {
  const int nc = (S + kBQ - 1) / kBQ;
  const size_t smem1 = kBwdStages * bwd_states_stage_bytes<T, kMTiles>(NP);
  const size_t smem2 = bwd_chunk_smem_bytes<T>(NP);
  // All of the unified L1/shared storage as shared memory: the states
  // kernel's occupancy is set by it (six or more blocks an SM at N = 128).
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T, kCB, kMTiles>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T, kCB, kMTiles>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, kCB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, kCB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xdt);
  const float* da = static_cast<const float*>(dA);
  const T* bm = static_cast<const T*>(B);
  const T* cm = static_cast<const T*>(C);
  const T* g = static_cast<const T*>(dy);
  bf16* s_in = static_cast<bf16*>(states);
  bf16* s_out = static_cast<bf16*>(dstates);
  const dim3 grid1(P / (16 * kMTiles), H, 2 * batch);
  ssd_bwd_states_kernel<T, kCB, kMTiles><<<grid1, kStThreads, smem1, st>>>(
      x, da, bm, cm, static_cast<const float*>(h0), g, static_cast<const float*>(d_final), s_in,
      s_out, static_cast<float*>(dh0), S, H, P, G, N, NP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, kCB><<<dim3(nc, G, batch), kChThreads, smem2, st>>>(
      x, da, bm, cm, g, s_in, s_out, static_cast<T*>(dxdt), static_cast<float*>(ddA),
      static_cast<T*>(dB), static_cast<T*>(dC), S, H, P, G, N, NP);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_n(const void* xdt, const void* dA, const void* B, const void* C,
                         const void* h0, const void* dy, const void* d_final, void* dxdt,
                         void* ddA, void* dB, void* dC, void* dh0, void* states, void* dstates,
                         int batch, int S, int H, int P, int G, int N, cudaStream_t st) {
  const int NP = (N + 15) / 16 * 16;
  // kCB: 16-column blocks a states-kernel warp owns (of NP / 16 split
  // kColWarps ways; the chunk kernel's warps own twice as many); the
  // states kernel's m-tiles a block: four (p = 64, 64 state registers a
  // thread) where P and N allow
#define SSD_BWD_LAUNCH(CB, MT)                                                                  \
  launch_bwd<T, CB, MT>(xdt, dA, B, C, h0, dy, d_final, dxdt, ddA, dB, dC, dh0, states, dstates, \
                        batch, S, H, P, G, N, NP, st)
  if (NP <= 128) return P % 64 ? SSD_BWD_LAUNCH(2, 1) : SSD_BWD_LAUNCH(2, 4);
  return SSD_BWD_LAUNCH(4, 1);
#undef SSD_BWD_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xdt, B, C and y).  h0 may be null
// (zero initial state).  P must be a multiple of 16, N at most 256 (and a
// multiple of 16 for bfloat16), H a multiple of G; bfloat16 pointers
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* xdt, const void* dA, const void* B,
                               const void* C, const void* h0, void* y,
                               void* final_state, int dtype, int batch, int S,
                               int H, int P, int G, int N, void* stream) {
  if (S < 1 || P % kPT || N < 1 || N > kMaxN || G < 1 || H % G) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(&ssd_chunk_scan_f32_kernel, sizeof(float) * f32_smem_floats(kMaxN),
                  sizeof(float) * f32_smem_floats(N), kF32Threads, xdt, dA, B, C, h0, y,
                  final_state, batch, S, H, P, G, N, st);
  if (dtype == 1) {
    if (N % 16) return cudaErrorInvalidValue;
    return launch(&ssd_chunk_scan_bf16_kernel, bf16_smem_bytes(kMaxN, kQ + 1),
                  bf16_smem_bytes(N, S), kThreads, xdt, dA, B, C, h0, y, final_state, batch,
                  S, H, P, G, N, st);
  }
  return cudaErrorInvalidValue;
}

// The backward.  Inputs as the forward's, plus dy [b,s,h,p] in T and
// d_final [b,h,p,n] f32 (null: zero); h0 may be null.  Outputs: dxdt
// [b,s,h,p] and dB, dC [b,s,g,n] in T, ddA [b,s,h] f32, dh0 [b,h,p,n] f32
// (null: not wanted).  Scratch from the caller: states and dstates, each
// [b,h,ceil(s/32),2,p,np] bf16 with np = n rounded up to 16.  P % 16 ==
// 0, N <= 256 (and a multiple of 16 for bfloat16), H a multiple of G;
// bfloat16 pointers 16-byte aligned.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd_launch(const void* xdt, const void* dA, const void* B,
                                   const void* C, const void* h0, const void* dy,
                                   const void* d_final, void* dxdt, void* ddA, void* dB,
                                   void* dC, void* dh0, void* states, void* dstates, int dtype,
                                   int batch, int S, int H, int P, int G, int N, void* stream) {
  if (batch < 1 || S < 1 || P % kPT || N < 1 || N > kMaxN || G < 1 || H % G)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_n<float>(xdt, dA, B, C, h0, dy, d_final, dxdt, ddA, dB, dC, dh0, states,
                               dstates, batch, S, H, P, G, N, st);
  if (dtype == 1) {
    if (N % 16) return cudaErrorInvalidValue;
    return launch_bwd_n<bf16>(xdt, dA, B, C, h0, dy, d_final, dxdt, ddA, dB, dC, dh0, states,
                              dstates, batch, S, H, P, G, N, st);
  }
  return cudaErrorInvalidValue;
}
