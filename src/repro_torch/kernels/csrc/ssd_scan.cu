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
// Backward (three kernels, one template over T, f32 arithmetic throughout;
// `ssd_scan_bwd_launch`).  It differentiates the unrounded chunked form, so
// a bf16 forward's gradients are those of its f32 function.  With cs_t the
// cumulative sum of dA inside a chunk of kBQ = 32 steps, S_in the state
// entering the chunk and dS_out the adjoint of the state leaving it:
//   dS_in = e^{cs_last} dS_out + sum_t e^{cs_t} dy_t (x) C_t    (dh0 at c = 0)
//   dx_j  = sum_{t>=j} e^{cs_t-cs_j} (C_t.B_j) dy_t + e^{cs_last-cs_j} dS_out B_j
//   dB_j  = sum_{t>=j} e^{cs_t-cs_j} (dy_t.x_j) C_t + e^{cs_last-cs_j} dS_out^T x_j
//   dC_t  = sum_{j<=t} e^{cs_t-cs_j} (dy_t.x_j) B_j + e^{cs_t} S_in^T dy_t
// and dcs_t from the pair terms, the carried state and dS_out, summed from
// the end of the chunk into ddA.
//   1. `ssd_bwd_states_kernel`, one block per (16-row p-tile, head, batch):
//      walks the chunks forward and writes each chunk's entering state
//      S_in, then backward and writes each chunk's dS_out, and dh0.  Each
//      thread keeps its state columns in registers.  No state is ever
//      recovered by dividing by a decay (e^{-dA} overflows): the entering
//      states are recomputed here, so the forward is left as it is.
//      Scratch: 2 x b*h*ceil(s/32)*P*N f32 (at mamba2-130m's training
//      shape b=16, s=512: 2 x 201 MB).
//   2. `ssd_bwd_chunk_kernel`, one block per (chunk, head, batch), all
//      chunks in parallel: C B^T masked by the decay, then over 16-row
//      p-tiles of x, dy (stored [p][t]), S_in and dS_out the products
//      dy x^T, dx (stored in T), and dy S_in and x dS_out, accumulated in
//      registers four steps of a column a thread; then ddA (one warp: the
//      pair terms' row and column sums, the carried state's, dS_out's, and
//      a reverse scan) and the head's dB and dC, written as f32 partials
//      per head (2 x b*s*h*N f32: 2 x 201 MB at that shape).
//   3. `ssd_bwd_group_sum_kernel`: dB and dC of a group are the sums of
//      its heads' partials, in head order, stored in T.
// Every sum runs in a fixed order and every output element is written by
// one thread, with no atomics: two calls give the same bits.  What bounds
// the function: bytes, its inputs and outputs (85 MB at the training shape,
// 0.026 ms at 3.35 TB/s), above its ~16 GFLOP at the card's bf16 rate
// (0.017 ms).  The design as built is far from that: it does its products
// as scalar f32 on the CUDA cores (0.25 ms at their peak), recomputes the
// entering states, and moves ~1.3 GB of scratch (0.39 ms at the memory
// rate).  What holds it back beyond those: the states kernel's 32
// dependent chunk steps a block, each behind three barriers, and
// shared-memory loads in the chunk kernel's scalar products; tensor cores
// (3xTF32 for f32 accuracy) and on-chip reduction of the per-head partials
// are the next steps.  Limits: P % 16 == 0, N <= 256.

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
constexpr int kBwdThreads = 256;
constexpr int kTS = kBQ + 4;        // shared row stride of the [p][t] x / dy tiles
constexpr int kStCols = kMaxN / kF32Threads;  // state columns a states-kernel thread owns
constexpr int kURIters = kMaxN / 32;          // (4-step, column) pieces of U, R a thread owns

__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void stf(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(bf16* p, size_t i, float v) { p[i] = __float2bfloat16_rn(v); }

// Inclusive cumulative sum of dA over the chunk (zeros past S), by warp 0:
// cs_s[t], din_s[t] = e^{cs_t}, dout_s[t] = e^{cs_last - cs_t}.
__device__ __forceinline__ void chunk_decays(const float* dA, size_t base, int H, int len,
                                             float* cs_s, float* din_s, float* dout_s) {
  const int lane = threadIdx.x;
  float cs = lane < len ? dA[base + (size_t)lane * H] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(kFull, cs, off);
    if (lane >= off) cs += up;
  }
  const float last = __shfl_sync(kFull, cs, kBQ - 1);
  cs_s[lane] = cs;
  din_s[lane] = expf(cs);
  dout_s[lane] = expf(last - cs);
}

__host__ __device__ constexpr int bwd_states_smem_floats(int N) {
  return kBQ * N + kBQ * kPT + 3 * kBQ;
}

// 1. Entering states S_in and outgoing adjoints dS_out of every chunk, and
// dh0.  Thread tid owns state columns n = tid, tid + 128 of all 16 rows,
// in registers; per step it reads its B (or C) value once and the step's
// 16 decay-weighted x (or dy) values as four broadcast float4s.
template <typename T>
__global__ void __launch_bounds__(kF32Threads)
ssd_bwd_states_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ h0, const T* __restrict__ dy,
                      const float* __restrict__ d_final, float* __restrict__ states,
                      float* __restrict__ dstates, float* __restrict__ dh0, int S, int H,
                      int P, int G, int N) {
  extern __shared__ __align__(16) float bwd_smem[];
  float* row_s = bwd_smem;              // [kBQ][N] B (forward walk) or C (backward walk)
  float* v_s = row_s + kBQ * N;         // [kBQ][kPT] x e^{cs_last-cs_t} or dy e^{cs_t}
  float* cs_s = v_s + kBQ * kPT;
  float* din_s = cs_s + kBQ;
  float* dout_s = din_s + kBQ;

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int nc = (S + kBQ - 1) / kBQ;
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;
  // chunk c's [kPT, N] slice of the scratch [b, h, nc, P, N]
  auto slot = [&](int c) { return (((size_t)b * H + h) * nc + c) * P * N + (size_t)p0 * N; };
  float st[kStCols][kPT];

  for (int walk = 0; walk < 2; ++walk) {
    const bool fwd = walk == 0;
    const float* init = fwd ? h0 : d_final;
    const T* rows = fwd ? Bm : Cm;
    const T* vec = fwd ? xdt : dy;
    float* out = fwd ? states : dstates;
#pragma unroll
    for (int k = 0; k < kStCols; ++k) {
      const int n = tid + k * kF32Threads;
#pragma unroll
      for (int pp = 0; pp < kPT; ++pp)
        st[k][pp] = init && n < N ? init[state_base + (size_t)pp * N + n] : 0.f;
    }
    for (int k = 0; k < nc; ++k) {
      const int c = fwd ? k : nc - 1 - k;
      const int t0 = c * kBQ, len = min(kBQ, S - t0);
      __syncthreads();   // the last chunk's readers are done with the staging
#pragma unroll
      for (int q = 0; q < kStCols; ++q) {
        const int n = tid + q * kF32Threads;
        if (n < N)
#pragma unroll
          for (int pp = 0; pp < kPT; ++pp) out[slot(c) + (size_t)pp * N + n] = st[q][pp];
      }
      for (int i = tid; i < kBQ * N; i += kF32Threads) {
        const int t = i / N, n = i % N;
        row_s[i] = t < len ? ldf(rows, (((size_t)b * S + t0 + t) * G + g) * N + n) : 0.f;
      }
      for (int i = tid; i < kBQ * kPT; i += kF32Threads) {
        const int t = i / kPT, pp = i % kPT;
        v_s[i] = t < len ? ldf(vec, (((size_t)b * S + t0 + t) * H + h) * P + p0 + pp) : 0.f;
      }
      if (tid < 32) chunk_decays(dA, (size_t)b * S * H + (size_t)t0 * H + h, H, len, cs_s, din_s,
                                 dout_s);
      __syncthreads();
      // forward:  S = e^{cs_last} S + sum_t e^{cs_last - cs_t} x_t (x) B_t
      // backward: dS = e^{cs_last} dS + sum_t e^{cs_t} dy_t (x) C_t
      const float* w_s = fwd ? dout_s : din_s;
      for (int i = tid; i < kBQ * kPT; i += kF32Threads) v_s[i] *= w_s[i / kPT];
      __syncthreads();
      const float decay = din_s[kBQ - 1];
#pragma unroll
      for (int q = 0; q < kStCols; ++q)
#pragma unroll
        for (int pp = 0; pp < kPT; ++pp) st[q][pp] *= decay;
      for (int t = 0; t < len; ++t) {
        const float4* vr = reinterpret_cast<const float4*>(v_s + t * kPT);
        const float4 v0 = vr[0], v1 = vr[1], v2 = vr[2], v3 = vr[3];
        const float v[kPT] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                              v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
#pragma unroll
        for (int q = 0; q < kStCols; ++q) {
          const int n = tid + q * kF32Threads;
          if (n < N) {
            const float r = row_s[t * N + n];
#pragma unroll
            for (int pp = 0; pp < kPT; ++pp) st[q][pp] = fmaf(v[pp], r, st[q][pp]);
          }
        }
      }
    }
  }
  if (dh0)
#pragma unroll
    for (int q = 0; q < kStCols; ++q) {
      const int n = tid + q * kF32Threads;
      if (n < N)
#pragma unroll
        for (int pp = 0; pp < kPT; ++pp) dh0[state_base + (size_t)pp * N + n] = st[q][pp];
    }
}

// Row stride of the chunk kernel's [*, N] tiles: N rounded up to 4 (zeros
// in the pad) for float4 reads along n, plus 4, so that 8 rows read at
// once fall in distinct 4-bank groups.
__host__ __device__ constexpr int bwd_row_stride(int N) { return (N + 3) / 4 * 4 + 4; }

__host__ __device__ constexpr int bwd_chunk_smem_floats(int N) {
  return 4 * kBQ * bwd_row_stride(N)   // B, C, U = dy S_in, R = x dS_out
       + 2 * kPT * bwd_row_stride(N)   // S_in and dS_out tiles
       + 3 * kBQ * (kBQ + 1)           // masked C B^T, dy x^T, masked dy x^T
       + 2 * kPT * kTS                 // x and dy tiles, [p][t]
       + 3 * kBQ                       // cs, e^{cs_t}, e^{cs_last - cs_t}
       + kBwdThreads / 32;             // the <dS_out, S_in> reduction
}

// 2. Per (chunk, head, batch): dx, ddA, and the head's dB and dC partials.
// U and R accumulate over the p-tiles in registers, four steps of one
// column a piece, fed by float4 reads of the [p][t] tiles.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const T* __restrict__ dy, const float* __restrict__ states,
                     const float* __restrict__ dstates, T* __restrict__ dxdt,
                     float* __restrict__ ddA, float* __restrict__ dBp, float* __restrict__ dCp,
                     int S, int H, int P, int G, int N) {
  extern __shared__ __align__(16) float bwd_smem[];
  constexpr int QP = kBQ + 1;
  const int NS = bwd_row_stride(N);
  const int NR = NS - 4;                // N rounded up to 4
  const int N4 = NR / 4;
  float* b_s = bwd_smem;                // [kBQ][NS]
  float* c_s = b_s + kBQ * NS;          // [kBQ][NS]
  float* u_s = c_s + kBQ * NS;          // [kBQ][NS] U[t][n] = sum_p dy_t[p] S_in[p][n]
  float* r_s = u_s + kBQ * NS;          // [kBQ][NS] R[j][n] = sum_p x_j[p] dS_out[p][n]
  float* si_s = r_s + kBQ * NS;         // [kPT][NS] p-tile of S_in
  float* so_s = si_s + kPT * NS;        // [kPT][NS] p-tile of dS_out
  float* gm_s = so_s + kPT * NS;        // [kBQ][QP] e^{cs_t-cs_j} C_t.B_j, j <= t
  float* dyx_s = gm_s + kBQ * QP;       // [kBQ][QP] dy_t.x_j
  float* m_s = dyx_s + kBQ * QP;        // [kBQ][QP] e^{cs_t-cs_j} dy_t.x_j, j <= t
  float* xt_s = m_s + kBQ * QP;         // [kPT][kTS] p-tile of x, [p][t]
  float* dyt_s = xt_s + kPT * kTS;      // [kPT][kTS] p-tile of dy, [p][t]
  float* cs_s = dyt_s + kPT * kTS;
  float* din_s = cs_s + kBQ;
  float* dout_s = din_s + kBQ;
  float* red_s = dout_s + kBQ;          // [warps]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = gridDim.x;
  const int t0 = c * kBQ, len = min(kBQ, S - t0);
  const size_t slot = (((size_t)b * H + h) * nc + c) * P * N;

  for (int i = tid; i < kBQ * NR; i += kBwdThreads) {
    const int t = i / NR, n = i % NR;
    const bool v = t < len && n < N;
    const size_t off = (((size_t)b * S + t0 + t) * G + g) * N + n;
    b_s[t * NS + n] = v ? ldf(Bm, off) : 0.f;
    c_s[t * NS + n] = v ? ldf(Cm, off) : 0.f;
  }
  for (int i = tid; i < kBQ * kBQ; i += kBwdThreads) dyx_s[(i / kBQ) * QP + i % kBQ] = 0.f;
  if (warp == 0) chunk_decays(dA, (size_t)b * S * H + (size_t)t0 * H + h, H, len, cs_s, din_s,
                              dout_s);
  __syncthreads();

  for (int i = tid; i < kBQ * kBQ; i += kBwdThreads) {
    const int t = i / kBQ, j = i % kBQ;
    float acc = 0.f;
    if (j <= t) {
      const float4* cr = reinterpret_cast<const float4*>(c_s + t * NS);
      const float4* br = reinterpret_cast<const float4*>(b_s + j * NS);
      for (int k = 0; k < N4; ++k) {
        const float4 c4 = cr[k], b4 = br[k];
        acc = fmaf(c4.x, b4.x, fmaf(c4.y, b4.y, fmaf(c4.z, b4.z, fmaf(c4.w, b4.w, acc))));
      }
      acc *= expf(cs_s[t] - cs_s[j]);
    }
    gm_s[t * QP + j] = acc;
  }

  float ua[kURIters][4], ra[kURIters][4];
#pragma unroll
  for (int it = 0; it < kURIters; ++it)
#pragma unroll
    for (int e = 0; e < 4; ++e) ua[it][e] = ra[it][e] = 0.f;
  float dot = 0.f;                      // this thread's share of <dS_out, S_in>
  for (int p0 = 0; p0 < P; p0 += kPT) {
    __syncthreads();                    // gm_s is written; the last tile is read
    for (int i = tid; i < kBQ * kPT; i += kBwdThreads) {
      const int t = i / kPT, pp = i % kPT;
      const bool v = t < len;
      const size_t off = (((size_t)b * S + t0 + t) * H + h) * P + p0 + pp;
      xt_s[pp * kTS + t] = v ? ldf(xdt, off) : 0.f;
      dyt_s[pp * kTS + t] = v ? ldf(dy, off) : 0.f;
    }
    for (int i = tid; i < kPT * NR; i += kBwdThreads) {
      const int pp = i / NR, n = i % NR;
      const size_t off = slot + (size_t)(p0 + pp) * N + n;
      si_s[pp * NS + n] = n < N ? states[off] : 0.f;
      so_s[pp * NS + n] = n < N ? dstates[off] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBQ; i += kBwdThreads) {
      const int t = i / kBQ, j = i % kBQ;
      float acc = dyx_s[t * QP + j];
#pragma unroll
      for (int pp = 0; pp < kPT; ++pp) acc = fmaf(dyt_s[pp * kTS + t], xt_s[pp * kTS + j], acc);
      dyx_s[t * QP + j] = acc;
    }
#pragma unroll
    for (int it = 0; it < kURIters; ++it) {
      const int i = tid + it * kBwdThreads;
      if (i < (kBQ / 4) * N) {
        const int tq = i / N, n = i % N;
#pragma unroll 4
        for (int pp = 0; pp < kPT; ++pp) {
          const float4 d4 = *reinterpret_cast<const float4*>(dyt_s + pp * kTS + 4 * tq);
          const float4 x4 = *reinterpret_cast<const float4*>(xt_s + pp * kTS + 4 * tq);
          const float si = si_s[pp * NS + n], so = so_s[pp * NS + n];
          ua[it][0] = fmaf(d4.x, si, ua[it][0]);
          ua[it][1] = fmaf(d4.y, si, ua[it][1]);
          ua[it][2] = fmaf(d4.z, si, ua[it][2]);
          ua[it][3] = fmaf(d4.w, si, ua[it][3]);
          ra[it][0] = fmaf(x4.x, so, ra[it][0]);
          ra[it][1] = fmaf(x4.y, so, ra[it][1]);
          ra[it][2] = fmaf(x4.z, so, ra[it][2]);
          ra[it][3] = fmaf(x4.w, so, ra[it][3]);
        }
      }
    }
    for (int i = tid; i < kPT * N; i += kBwdThreads) {
      const int pp = i / N, n = i % N;
      dot = fmaf(so_s[pp * NS + n], si_s[pp * NS + n], dot);
    }
    for (int i = tid; i < kBQ * kPT; i += kBwdThreads) {
      const int j = i / kPT, pp = i % kPT;
      if (j >= len) continue;
      float acc = 0.f;
      for (int t = j; t < kBQ; ++t) acc = fmaf(gm_s[t * QP + j], dyt_s[pp * kTS + t], acc);
      const float4* so = reinterpret_cast<const float4*>(so_s + pp * NS);
      const float4* br = reinterpret_cast<const float4*>(b_s + j * NS);
      float carried = 0.f;
      for (int k = 0; k < N4; ++k) {
        const float4 s4 = so[k], b4 = br[k];
        carried = fmaf(s4.x, b4.x, fmaf(s4.y, b4.y, fmaf(s4.z, b4.z, fmaf(s4.w, b4.w, carried))));
      }
      stf(dxdt, (((size_t)b * S + t0 + j) * H + h) * P + p0 + pp, fmaf(dout_s[j], carried, acc));
    }
  }
#pragma unroll
  for (int it = 0; it < kURIters; ++it) {
    const int i = tid + it * kBwdThreads;
    if (i < (kBQ / 4) * N) {
      const int tq = i / N, n = i % N;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u_s[(4 * tq + e) * NS + n] = ua[it][e];
        r_s[(4 * tq + e) * NS + n] = ra[it][e];
      }
    }
  }
  // <dS_out, S_in>: warps' sums, then warp 0 over them in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
  if (lane == 0) red_s[warp] = dot;
  __syncthreads();                      // dy x^T, U, R and the sums are complete

  for (int i = tid; i < kBQ * kBQ; i += kBwdThreads) {
    const int t = i / kBQ, j = i % kBQ;
    m_s[t * QP + j] = j <= t ? expf(cs_s[t] - cs_s[j]) * dyx_s[t * QP + j] : 0.f;
  }
  if (warp == 0) {
    // dcs_k: pair terms w_tj = gm_tj dyx_tj add at t and subtract at j;
    // the carried state adds e^{cs_k} C_k.U_k; dS_out's input term
    // v_j = e^{cs_last-cs_j} B_j.R_j subtracts at j and adds at the end,
    // as does e^{cs_last} <dS_out, S_in>.
    const int k = lane;
    float row = 0.f, col = 0.f, cu = 0.f, bv = 0.f;
    for (int j = 0; j < kBQ; ++j) {
      row = fmaf(gm_s[k * QP + j], dyx_s[k * QP + j], row);
      col = fmaf(gm_s[j * QP + k], dyx_s[j * QP + k], col);
    }
    for (int n = 0; n < N; ++n) {
      cu = fmaf(c_s[k * NS + n], u_s[k * NS + n], cu);
      bv = fmaf(b_s[k * NS + n], r_s[k * NS + n], bv);
    }
    const float v = dout_s[k] * bv;
    float vsum = v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) vsum += __shfl_xor_sync(kFull, vsum, off);
    float total = 0.f;
    for (int w = 0; w < kBwdThreads / 32; ++w) total += red_s[w];
    float dcs = row - col + din_s[k] * cu - v;
    if (k == kBQ - 1) dcs += vsum + din_s[kBQ - 1] * total;
    // ddA_k = sum_{t >= k} dcs_t
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float down = __shfl_down_sync(kFull, dcs, off);
      if (k + off < 32) dcs += down;
    }
    if (k < len) ddA[((size_t)b * S + t0 + k) * H + h] = dcs;
  }
  __syncthreads();

  // dB_j = sum_{t>=j} m_tj C_t + e^{cs_last-cs_j} R_j;  dC_t = sum_{j<=t} m_tj B_j + e^{cs_t} U_t
  for (int i = tid; i < kBQ * N; i += kBwdThreads) {
    const int r = i / N, n = i % N;
    if (r >= len) continue;
    float db = dout_s[r] * r_s[r * NS + n], dc = din_s[r] * u_s[r * NS + n];
    for (int t = r; t < kBQ; ++t) db = fmaf(m_s[t * QP + r], c_s[t * NS + n], db);
    for (int j = 0; j <= r; ++j) dc = fmaf(m_s[r * QP + j], b_s[j * NS + n], dc);
    const size_t off = (((size_t)b * S + t0 + r) * H + h) * N + n;
    dBp[off] = db;
    dCp[off] = dc;
  }
}

// 3. dB and dC per group: the group's heads' partials summed in head order.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_group_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                         T* __restrict__ dB, T* __restrict__ dC, size_t total, int H, int G,
                         int N) {
  const size_t i = (size_t)blockIdx.x * kBwdThreads + threadIdx.x;
  if (i >= total) return;
  const int n = i % N;
  const size_t rest = i / N;
  const int g = rest % G;
  const size_t bs = rest / G;
  const int hpg = H / G;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < hpg; ++k) {
    const size_t off = (bs * H + (size_t)g * hpg + k) * N + n;
    sb += dBp[off];
    sc += dCp[off];
  }
  stf(dB, i, sb);
  stf(dC, i, sc);
}

template <typename T>
cudaError_t launch_bwd(const void* xdt, const void* dA, const void* B, const void* C,
                       const void* h0, const void* dy, const void* d_final, void* dxdt, void* ddA,
                       void* dB, void* dC, void* dh0, void* states, void* dstates, void* dBp,
                       void* dCp, int batch, int S, int H, int P, int G, int N, cudaStream_t st) {
  const int nc = (S + kBQ - 1) / kBQ;
  const size_t smem1 = sizeof(float) * bwd_states_smem_floats(N);
  const size_t smem2 = sizeof(float) * bwd_chunk_smem_floats(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xdt);
  const float* da = static_cast<const float*>(dA);
  const T* bm = static_cast<const T*>(B);
  const T* cm = static_cast<const T*>(C);
  const T* g = static_cast<const T*>(dy);
  ssd_bwd_states_kernel<T><<<dim3(P / kPT, H, batch), kF32Threads, smem1, st>>>(
      x, da, bm, cm, static_cast<const float*>(h0), g, static_cast<const float*>(d_final),
      static_cast<float*>(states), static_cast<float*>(dstates), static_cast<float*>(dh0), S, H,
      P, G, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T><<<dim3(nc, H, batch), kBwdThreads, smem2, st>>>(
      x, da, bm, cm, g, static_cast<const float*>(states), static_cast<const float*>(dstates),
      static_cast<T*>(dxdt), static_cast<float*>(ddA), static_cast<float*>(dBp),
      static_cast<float*>(dCp), S, H, P, G, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)batch * S * G * N;
  ssd_bwd_group_sum_kernel<T><<<(unsigned)((total + kBwdThreads - 1) / kBwdThreads), kBwdThreads,
                                0, st>>>(static_cast<const float*>(dBp),
                                         static_cast<const float*>(dCp), static_cast<T*>(dB),
                                         static_cast<T*>(dC), total, H, G, N);
  return cudaGetLastError();
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
// (null: not wanted).  Scratch from the caller, f32: states and dstates
// [b,h,ceil(s/32),p,n], dBp and dCp [b,s,h,n].  P % 16 == 0, N <= 256, H a
// multiple of G.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd_launch(const void* xdt, const void* dA, const void* B,
                                   const void* C, const void* h0, const void* dy,
                                   const void* d_final, void* dxdt, void* ddA, void* dB,
                                   void* dC, void* dh0, void* states, void* dstates, void* dBp,
                                   void* dCp, int dtype, int batch, int S, int H, int P, int G,
                                   int N, void* stream) {
  if (batch < 1 || S < 1 || P % kPT || N < 1 || N > kMaxN || G < 1 || H % G)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(xdt, dA, B, C, h0, dy, d_final, dxdt, ddA, dB, dC, dh0, states,
                             dstates, dBp, dCp, batch, S, H, P, G, N, st);
  if (dtype == 1)
    return launch_bwd<bf16>(xdt, dA, B, C, h0, dy, d_final, dxdt, ddA, dB, dC, dh0, states,
                            dstates, dBp, dCp, batch, S, H, P, G, N, st);
  return cudaErrorInvalidValue;
}
