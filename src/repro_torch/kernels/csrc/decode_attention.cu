// Flash-decode GQA attention for Hopper (sm_90a): kernel B1 of the port.
//
// Replaces the TPU kernel `repro/kernels/decode_attention.py`
// `flash_decode_gqa` (Pallas body `_kernel`), and covers what the model path
// `repro/models/attention.py` `decode_attention` needs beyond it: any S (the
// ragged edge is masked, no S % block restriction), logit softcap, fp8 e4m3
// caches (`cache_dtype="float8_e4m3fn"`, computed in q's type as the
// reference upcasts them) and the ring-buffer validity rule.  That rule,
// `idx <= pos || (ring && pos >= S-1)`, keeps the same keys as `idx <= pos`
// for every pos >= 0, so one kernel serves both caches: the valid keys are
// the prefix [0, min(pos+1, S)).  pos < 0 leaves no key valid, where the
// reference's softmax over all-masked scores is uniform over all S keys.
//
// One query token per sequence: q [B,Hq,D], k/v [B,S,Hkv,D] contiguous,
// pos an int32 on the device (read here, so the decode loop never syncs
// with the host).  The G = Hq/Hkv query heads of a KV head share its K/V.
// Softmax and accumulation run in f32; the output is written in q's type.
// Pairs taken: q bf16 with a bf16 or fp8 cache, q f32 with an f32 or fp8
// cache.
//
// What bounds it on the H100: bytes.  It reads K and V up to pos+1 (or S
// once the ring is full) plus q, and writes out: about 4*G/itemsize flops
// per byte, far below the ~295 flop/byte at which the tensor cores would
// be the limit, so the bound is bytes / 3.35 TB/s.  At the serve shapes
// those bytes are a few MB, so the launch, the latency of the first loads
// and the merge of S-splits are what a design can still cut.
//
// Design:
//  * One launch per call.  One block per (S-split, KV head, tile of query
//    heads, batch).  The host picks the grid's splits from S (enough blocks
//    for one wave over the SMs, >= 128 keys a split, and no more than the
//    merge of the partials repays); the block derives the splits actually
//    used from pos on the device (`split_plan`), so a short prefix runs on
//    few blocks and the others exit at once.  With one split the block
//    writes `out`.  Otherwise it writes its partial (m, l, acc) to a
//    workspace, fences, and takes a ticket on its (batch, KV head, head
//    tile) counter; the block that takes the last ticket merges the
//    partials (weights and sums in a fixed order, so the result does not
//    depend on which block finishes last), writes `out` and resets the
//    counter to 0.  The wrapper keeps the workspace per (device, stream).
//  * K/V tiles flow through a ring of up to four stages in shared memory,
//    filled with 16-byte `cp.async` (all stages issued before the first
//    tile is used), so an SM keeps up to ~200 KB in flight.  Rows past the
//    split's end are zero-filled (src-size 0): no garbage, and no fp8 NaN
//    bit pattern, enters a product.
//  * q bf16 (tensor cores): the block holds 16 query heads (one m16 tile,
//    padded with zeros when G < 16; G > 16 takes more head tiles in the
//    grid) and each of its 4 warps a 16-key slice of every 64-key tile.
//    S = Q K^T by `mma.sync.m16n8k16` bf16 -> f32 with Q and K through
//    `ldmatrix`; scale, softcap, mask and the online softmax on the f32
//    accumulator fragments; P rounded to bf16 and P V by a second `mma`
//    with V through `ldmatrix.trans`.  So K/V are read once per KV head.
//    fp8 tiles are widened to bf16 (exactly) in shared memory first.
//  * q f32: scalar f32 streams, as the 1e-4 tolerance needs.  8 query heads
//    a block; each K/V row of a 32-key tile is read from shared memory by
//    LPR lanes of a warp, fp8 widened to f32 on the way; each row group of
//    a warp is an online-softmax stream, merged by shuffles and across
//    warps through shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;
using fp8 = uint8_t;                 // e4m3fn bits

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinKeys = 128;        // fewest keys a split takes (see split_plan)
constexpr int kMaxSplits = 256;
constexpr int kMaxStages = 4;
constexpr size_t kSmemSpare = 4096;     // static shared memory and slack

// Shared memory a block may take: half an SM's 228 KB at D <= 128, so two
// blocks share an SM, and all of a block's 227 KB at D = 256.
constexpr size_t smem_limit(int D) { return D <= 128 ? 115200 : 232448; }

// Query heads a block holds, keys a ring stage holds, on each path.
constexpr int kMmaHeads = 16;
constexpr int kMmaKeys = 16 * kWarps;
constexpr int kF32Heads = 8;
constexpr int kF32Keys = 32;
constexpr int kPad = 8;              // bf16 padding of a shared row (ldmatrix banks)

// ---------------------------------------------------------------------------
// Helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; zeros if !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's copy groups are pending (n < 4).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
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

// Two e4m3 values (low byte first) -> f32, exactly (through f16).
__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t two) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3));
  return __half22float2(h);
}

// exp(m - M), with an empty stream (m = -inf) weighing 0.
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  uint2 v;
  v.x = pack_bf16(a, b);
  v.y = pack_bf16(c, d);
  *reinterpret_cast<uint2*>(p) = v;
}

// Valid keys [0, n_valid) are cut into n_used splits of `chunk` keys (a
// multiple of 16, the last one ragged), at most n_splits and each of at
// least kMinKeys keys where there are enough: below that a split's block
// reads too little to repay the merge.  tests/test_torch_decode_kernel_order.py
// emulates this cut.
__device__ __forceinline__ void split_plan(int n_valid, int n_splits, int& n_used,
                                           int& chunk) {
  const int n = max(1, min(n_splits, (n_valid + kMinKeys - 1) / kMinKeys));
  chunk = ((n_valid + n - 1) / n + 15) / 16 * 16;
  n_used = (n_valid + chunk - 1) / chunk;
}

struct Geometry {
  int b, h, gt, split, bhg, rows;   // rows: real query heads of this head tile
  int n_valid, n_used, kb, ke;      // this split's keys are [kb, ke)
  bool uniform;
};

// The block's place in the grid; keys are set by `set_keys` once pos is read.
template <int GB>
__device__ __forceinline__ Geometry geometry(int G) {
  Geometry g;
  const int n_gt = (G + GB - 1) / GB;
  g.split = blockIdx.x;
  g.h = blockIdx.y / n_gt;
  g.gt = blockIdx.y % n_gt;
  g.b = blockIdx.z;
  g.bhg = blockIdx.z * gridDim.y + blockIdx.y;
  g.rows = min(GB, G - g.gt * GB);
  return g;
}

__device__ __forceinline__ void set_keys(Geometry& g, int pos, int S, int n_splits) {
  g.uniform = pos < 0;
  g.n_valid = g.uniform ? S : min(pos + 1, S);
  int chunk;
  split_plan(g.n_valid, n_splits, g.n_used, chunk);
  g.kb = min(g.split * chunk, g.n_valid);
  g.ke = min(g.kb + chunk, g.n_valid);
}

// Copy keys [j0, j0 + KT) of this block's KV head into one ring stage:
// K rows then V rows, each row D elements of CT at `row_bytes` apart in
// shared memory.  Rows at or past the split's end are zero-filled (their
// source address is the split's first row, never past the cache).
template <int D, typename CT, int KT>
__device__ __forceinline__ void issue_tile(unsigned char* stage, int row_bytes,
                                           const CT* __restrict__ k,
                                           const CT* __restrict__ v, const Geometry& g,
                                           int S, int Hkv, int j0) {
  constexpr int CHUNKS = D * (int)sizeof(CT) / 16;   // 16-byte copies a row
  constexpr int EPC = 16 / (int)sizeof(CT);          // elements a copy
  for (int i = threadIdx.x; i < 2 * KT * CHUNKS; i += kThreads) {
    const int which = i / (KT * CHUNKS);
    const int r = (i / CHUNKS) % KT, c = i % CHUNKS;
    const int j = j0 + r;
    const bool valid = j < g.ke;
    const CT* src = (which ? v : k) +
                    (((size_t)g.b * S + (valid ? j : g.kb)) * Hkv + g.h) * D + c * EPC;
    cp_async16(stage + (size_t)(which * KT + r) * row_bytes + c * 16, src, valid);
  }
}

// The block's merged state is in shared memory: o_s [GB][D] (unnormalized),
// m_s and l_s [GB].  With one split, write out = o / l.  Otherwise write
// the partial, take a ticket, and if it is the last one merge every used
// split's partial in split order into out.  part holds acc
// [bhg][n_splits][GB][D] then (m, l) [bhg][n_splits][GB][2], f32.
template <int GB, int D, typename T>
__device__ void finish(const float* o_s, const float* m_s, const float* l_s, float* w_s,
                       float* L_s, int* last_s, T* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters,
                       float* __restrict__ lse, const Geometry& g, int G, int Hkv,
                       int n_splits) {
  constexpr int NCH = GB * D / 4;                      // float4 chunks of a partial
  constexpr int CPT = (NCH + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int n_ch = g.rows * D / 4;
  const size_t row0 = (size_t)g.b * Hkv * G + (size_t)g.h * G + g.gt * GB;
  T* outp = out + row0 * D;
  if (g.n_used == 1) {
    if (lse)
      for (int r = tid; r < g.rows; r += kThreads) lse[row0 + r] = m_s[r] + logf(l_s[r]);
    for (int c = tid; c < n_ch; c += kThreads) {
      const int r = c * 4 / D;
      const float inv = 1.f / l_s[r];
      const float4 o = *reinterpret_cast<const float4*>(o_s + c * 4);
      store4(outp + c * 4, o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    }
    return;
  }
  const size_t n_bhg = (size_t)gridDim.y * gridDim.z;
  float* acc_base = part + (size_t)g.bhg * n_splits * GB * D;
  float* ml_base = part + n_bhg * n_splits * GB * D + (size_t)g.bhg * n_splits * GB * 2;
  float* acc_own = acc_base + (size_t)g.split * GB * D;
  for (int c = tid; c < n_ch; c += kThreads)
    *reinterpret_cast<float4*>(acc_own + c * 4) = *reinterpret_cast<const float4*>(o_s + c * 4);
  for (int r = tid; r < g.rows; r += kThreads) {
    ml_base[((size_t)g.split * GB + r) * 2] = m_s[r];
    ml_base[((size_t)g.split * GB + r) * 2 + 1] = l_s[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + g.bhg, 1) == g.n_used - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // The last block: every split's (m, l) into shared memory in one round
  // trip, then each row's weights exp(m_s - M), a warp a row and a lane a
  // split, and L = sum of l_s w_s by a fixed shuffle tree.
  float2* ml_s = reinterpret_cast<float2*>(w_s);     // [n_used][GB]: (m, l), then (w, l)
  for (int i = tid; i < g.n_used * GB; i += kThreads)
    if (i % GB < g.rows) ml_s[i] = __ldcg(reinterpret_cast<const float2*>(ml_base) + i);
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < g.rows; r += kWarps) {
    float M = -INFINITY;
    for (int s = lane; s < g.n_used; s += 32) M = fmaxf(M, ml_s[s * GB + r].x);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
    float L = 0.f;
    for (int s = lane; s < g.n_used; s += 32) {
      const float w = rescale(ml_s[s * GB + r].x, M);
      ml_s[s * GB + r].x = w;
      L = fmaf(ml_s[s * GB + r].y, w, L);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) L += __shfl_xor_sync(kFull, L, off);
    if (lane == 0) L_s[r] = L;
    if (lse && lane == 0) lse[row0 + r] = M + logf(L);
  }
  __syncthreads();
  // The partials of SB splits are all requested before any is summed, so
  // SB * CPT 16-byte loads a thread are in flight at once.
  constexpr int SB = 4;
  float4 acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < g.n_used; s0 += SB) {
    float4 x[SB][CPT];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const float4* src = reinterpret_cast<const float4*>(acc_base + (size_t)(s0 + j) * GB * D);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * kThreads;
        x[j][i] = c < n_ch && s0 + j < g.n_used ? __ldcg(src + c)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      if (s0 + j >= g.n_used) break;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * kThreads;
        if (c < n_ch) {
          const float w = ml_s[(s0 + j) * GB + c * 4 / D].x;
          acc[i].x = fmaf(w, x[j][i].x, acc[i].x);
          acc[i].y = fmaf(w, x[j][i].y, acc[i].y);
          acc[i].z = fmaf(w, x[j][i].z, acc[i].z);
          acc[i].w = fmaf(w, x[j][i].w, acc[i].w);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * kThreads;
    if (c < n_ch) {
      const float inv = 1.f / L_s[c * 4 / D];
      store4(outp + c * 4, acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
    }
  }
  if (tid == 0) counters[g.bhg] = 0;
}

// ---------------------------------------------------------------------------
// q bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D, typename CT>
struct MmaLayout {
  static constexpr bool kFp8 = sizeof(CT) == 1;
  static constexpr int LD = D + kPad;                            // bf16 row stride
  static constexpr size_t q_bytes = sizeof(bf16) * kMmaHeads * LD;
  static constexpr size_t tile_bytes = 2 * sizeof(bf16) * kMmaKeys * LD;   // K and V, bf16
  static constexpr int raw_row = kFp8 ? D : (int)sizeof(bf16) * LD;        // a row in the ring
  static constexpr size_t stage_bytes = (size_t)2 * kMmaKeys * raw_row;
  // fp8: one bf16 tile the stages are widened into.
  static constexpr size_t fixed = q_bytes + (kFp8 ? tile_bytes : 0);
  static constexpr int max_stages() {
    return (int)((smem_limit(D) - kSmemSpare - fixed) / stage_bytes) < kMaxStages
               ? (int)((smem_limit(D) - kSmemSpare - fixed) / stage_bytes)
               : kMaxStages;
  }
  // After the loop: each warp's o [16][D] f32, then the splits' (m, l).
  static constexpr size_t epilogue_bytes =
      sizeof(float) * (kWarps * kMmaHeads * D + 2 * kMaxSplits * kMmaHeads);
  static size_t smem_bytes(int stages) {
    const size_t ring = stages * stage_bytes + (kFp8 ? tile_bytes : 0);
    return q_bytes + (ring > epilogue_bytes ? ring : epilogue_bytes);
  }
};

// Fragment layout of m16n8 tiles: lane = 4 gq + q holds rows gq and gq + 8
// at columns 2q and 2q + 1.  Warp w takes keys [16w, 16w + 16) of every
// 64-key tile: S tile [16 heads x 16 keys] in two n8 accumulators, its own
// online-softmax state (m, l for rows gq and gq + 8) and o [16 x D] in
// D/8 n8 accumulators.
template <int D, typename CT>
__global__ void __launch_bounds__(kThreads)
flash_decode_bf16_kernel(const bf16* __restrict__ q, const CT* __restrict__ k,
                         const CT* __restrict__ v, const int* __restrict__ pos_ptr,
                         bf16* __restrict__ out, float* __restrict__ part,
                         int* __restrict__ counters, float* __restrict__ lse, int S,
                         int Hkv, int G, int n_splits,
                         int n_stages, float scale, float softcap) {
  using L = MmaLayout<D, CT>;
  constexpr int LD = L::LD;
  constexpr int KT = kMmaKeys;
  constexpr int NT = D / 8;           // n8 tiles of o
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ms[kWarps][kMmaHeads], ls[kWarps][kMmaHeads];
  __shared__ float m_fin[kMmaHeads], l_fin[kMmaHeads], L_fin[kMmaHeads];
  __shared__ int last;

  constexpr int QCH = kMmaHeads * D / 8;             // 16-byte pieces of the q tile
  constexpr int QPT = (QCH + kThreads - 1) / kThreads;
  Geometry g = geometry<kMmaHeads>(G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, qd = lane % 4;

  bf16* q_s = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::q_bytes;
  bf16* wide = reinterpret_cast<bf16*>(ring + (size_t)n_stages * L::stage_bytes);

  // pos and the q rows (zero rows past G) are in flight together.
  const int pos = *pos_ptr;
  uint4 qv[QPT];
  {
    const bf16* qp = q + ((size_t)g.b * Hkv * G + (size_t)g.h * G + g.gt * kMmaHeads) * D;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int c = tid + i * kThreads, r = c / (D / 8);
      qv[i] = c < QCH && r < g.rows
                  ? *reinterpret_cast<const uint4*>(qp + (size_t)r * D + c % (D / 8) * 8)
                  : make_uint4(0, 0, 0, 0);
    }
  }
  set_keys(g, pos, S, n_splits);
  if (g.split >= g.n_used) return;
  const int n_tiles = (g.ke - g.kb + KT - 1) / KT;
  for (int t = 0; t < n_stages; ++t) {
    if (t < n_tiles)
      issue_tile<D, CT, KT>(ring + t * L::stage_bytes, L::raw_row, k, v, g, S, Hkv,
                            g.kb + t * KT);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int c = tid + i * kThreads;
    if (c < QCH)
      *reinterpret_cast<uint4*>(q_s + c / (D / 8) * LD + c % (D / 8) * 8) = qv[i];
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    unsigned char* stage = ring + (t % n_stages) * L::stage_bytes;
    cp_async_wait(n_stages - 1);
    __syncthreads();
    const bf16* kt;
    if constexpr (L::kFp8) {
      // Widen the stage's fp8 K and V rows to bf16, 16 values a thread at a
      // time (rows past the split's end arrived as zeros).
      for (int i = tid; i < 2 * KT * D / 16; i += kThreads) {
        const int r = i / (D / 16), c = i % (D / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>(stage + (size_t)r * D + c * 16);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t packed[8];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 lo = fp8x2_to_float2((uint16_t)(words[w] & 0xffff));
          const float2 hi = fp8x2_to_float2((uint16_t)(words[w] >> 16));
          packed[2 * w] = pack_bf16(lo.x, lo.y);
          packed[2 * w + 1] = pack_bf16(hi.x, hi.y);
        }
        uint4* dst = reinterpret_cast<uint4*>(wide + (size_t)r * LD + c * 16);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncthreads();
      kt = wide;
    } else {
      kt = reinterpret_cast<const bf16*>(stage);
    }
    const bf16* vt = kt + KT * LD;
    const int j0 = g.kb + t * KT + warp * 16;     // this warp's first key
    if (j0 < g.ke) {
      // Even and odd 16-dim steps accumulate apart: two chains of D/32 mma
      // a key tile instead of one of D/16.
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float s_odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* qa = q_s + (lane & 15) * LD + (lane >> 4) * 8;
      const bf16* kb_ = kt + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        uint32_t a[4], bk[4], a2[4], bk2[4];
        ldsm_x4(a, qa + ks * 16);
        ldsm_x4(bk, kb_ + ks * 16);
        ldsm_x4(a2, qa + ks * 16 + 16);
        ldsm_x4(bk2, kb_ + ks * 16 + 16);
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
        mma_bf16(s_odd[0], a2, bk2[0], bk2[1]);
        mma_bf16(s_odd[1], a2, bk2[2], bk2[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s_odd[n][e];
      // scale, softcap, mask; then the online softmax of rows gq, gq + 8
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          if (g.uniform) x = 0.f;
          if (j0 + 8 * n + 2 * qd + (e & 1) >= g.ke) x = -INFINITY;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);   // finite: the slice has a valid key
        alpha[r] = rescale(m[r], m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m[e >> 1]);
          rs[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P (bf16) as the A operand over this slice's 16 keys
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const bf16* vb = vt + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vb + n2 * 16);
        mma_bf16(o[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(o[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();
    if (t + n_stages < n_tiles)
      issue_tile<D, CT, KT>(stage, L::raw_row, k, v, g, S, Hkv, g.kb + (t + n_stages) * KT);
    cp_async_commit();
  }
  cp_async_wait(0);

  // Merge the warps: rows' sums over the quad, each warp's o rescaled to the
  // block's max into shared memory (the ring is free now), summed in warp
  // order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if (qd == 0) {
    ms[warp][gq] = m[0];
    ms[warp][gq + 8] = m[1];
    ls[warp][gq] = l[0];
    ls[warp][gq + 8] = l[1];
  }
  __syncthreads();
  float* ow = reinterpret_cast<float*>(ring);           // [kWarps][16][D]
  float* w_s = ow + kWarps * kMmaHeads * D;              // [kMaxSplits][16][2]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    if (row >= g.rows) continue;        // padding heads: never written out
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ms[w][row]);
    const float sc = rescale(m[r], M);
    float* dst = ow + ((size_t)warp * kMmaHeads + row) * D + 2 * qd;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * r] * sc, o[n][2 * r + 1] * sc);
  }
  if (tid < kMmaHeads) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ms[w][tid]);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) Lsum += ls[w][tid] * rescale(ms[w][tid], M);
    m_fin[tid] = M;
    l_fin[tid] = Lsum;
  }
  __syncthreads();
  for (int i = tid; i < g.rows * D / 4; i += kThreads) {
    float4 a = reinterpret_cast<const float4*>(ow)[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 b = reinterpret_cast<const float4*>(ow + (size_t)w * kMmaHeads * D)[i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    reinterpret_cast<float4*>(ow)[i] = a;
  }
  __syncthreads();
  finish<kMmaHeads, D>(ow, m_fin, l_fin, w_s, L_fin, &last, out, part, counters, lse, g, G,
                       Hkv, n_splits);
}

// ---------------------------------------------------------------------------
// q f32: scalar streams
// ---------------------------------------------------------------------------

// Four elements of a cache row in shared memory, widened to f32.
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load4(const fp8* p, float* o) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  const float2 lo = fp8x2_to_float2((uint16_t)(x & 0xffff));
  const float2 hi = fp8x2_to_float2((uint16_t)(x >> 16));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}

template <int D, typename CT>
struct F32Layout {
  static constexpr size_t q_bytes = sizeof(float) * kF32Heads * D;
  static constexpr int raw_row = D * (int)sizeof(CT);
  static constexpr size_t stage_bytes = (size_t)2 * kF32Keys * raw_row;
  static constexpr int max_stages() {
    return (int)((smem_limit(D) - kSmemSpare - q_bytes) / stage_bytes) < kMaxStages
               ? (int)((smem_limit(D) - kSmemSpare - q_bytes) / stage_bytes)
               : kMaxStages;
  }
  // After the loop: each warp's acc [GB][D], the merged o [GB][D], the
  // splits' (m, l).
  static constexpr size_t epilogue_bytes =
      sizeof(float) * ((kWarps + 1) * kF32Heads * D + 2 * kMaxSplits * kF32Heads);
  static size_t smem_bytes(int stages) {
    const size_t ring = stages * stage_bytes;
    return q_bytes + (ring > epilogue_bytes ? ring : epilogue_bytes);
  }
};

template <int D, typename CT>
__global__ void __launch_bounds__(kThreads)
flash_decode_f32_kernel(const float* __restrict__ q, const CT* __restrict__ k,
                        const CT* __restrict__ v, const int* __restrict__ pos_ptr,
                        float* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counters, float* __restrict__ lse, int S,
                        int Hkv, int G, int n_splits,
                        int n_stages, float scale, float softcap) {
  using L = F32Layout<D, CT>;
  constexpr int GB = kF32Heads;
  constexpr int KT = kF32Keys;
  constexpr int VEC = 4;
  constexpr int LPR = D / VEC < 32 ? D / VEC : 32;   // lanes per K/V row
  constexpr int PIECES = D / (VEC * LPR);            // 4-element loads a lane a row
  constexpr int E = PIECES * VEC;                    // dims a lane holds
  static_assert(D % (VEC * LPR) == 0 && LPR >= 8 && 32 % LPR == 0, "head dim");
  constexpr int RPW = 32 / LPR;                      // rows a warp reads at once
  constexpr int NSR = kWarps * RPW;                  // streams a block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float w_m[kWarps][GB], w_l[kWarps][GB];
  __shared__ float m_fin[GB], l_fin[GB], L_fin[GB];
  __shared__ int last;

  constexpr int QPT = (GB * D / 4 + kThreads - 1) / kThreads;   // float4s of q a thread
  Geometry g = geometry<GB>(G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + L::q_bytes;
  const int pos = *pos_ptr;              // in flight with the q rows
  float4 qv[QPT];
  {
    const float* qp = q + ((size_t)g.b * Hkv * G + (size_t)g.h * G + g.gt * GB) * D;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int c = tid + i * kThreads;
      qv[i] = c < GB * D / 4 && c * 4 / D < g.rows
                  ? *reinterpret_cast<const float4*>(qp + c * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  set_keys(g, pos, S, n_splits);
  if (g.split >= g.n_used) return;
  const int n_tiles = (g.ke - g.kb + KT - 1) / KT;
  for (int t = 0; t < n_stages; ++t) {
    if (t < n_tiles)
      issue_tile<D, CT, KT>(ring + t * L::stage_bytes, L::raw_row, k, v, g, S, Hkv,
                            g.kb + t * KT);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int c = tid + i * kThreads;
    if (c < GB * D / 4) reinterpret_cast<float4*>(q_s)[c] = qv[i];
  }

  // Element e of a lane is dim dim_of(e) of the row.
  auto dim_of = [&](int e) { return (e / VEC) * VEC * LPR + sub * VEC + e % VEC; };
  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    unsigned char* stage = ring + (t % n_stages) * L::stage_bytes;
    cp_async_wait(n_stages - 1);
    __syncthreads();
    const CT* kt = reinterpret_cast<const CT*>(stage);
    const CT* vt = kt + KT * D;
    // Warp-uniform trip count, so every lane reaches the shuffles; rows
    // past ke (zeros) never count.
    for (int r0 = warp * RPW; r0 < KT && g.kb + t * KT + r0 < g.ke; r0 += NSR) {
      const int r = r0 + grp;
      const bool live = g.kb + t * KT + r < g.ke;
      float kv[E], vv[E];
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
        load4(kt + r * D + pc * VEC * LPR + sub * VEC, kv + pc * VEC);
        load4(vt + r * D + pc * VEC * LPR + sub * VEC, vv + pc * VEC);
      }
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        if (h >= g.rows) break;             // padding heads of the last head tile
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(q_s[h * D + dim_of(e)], kv[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off /= 2) s += __shfl_xor_sync(kFull, s, off);
        s *= scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        if (g.uniform) s = 0.f;
        if (live) {
          const float m_new = fmaxf(m[h], s);
          const float alpha = rescale(m[h], m_new);
          const float p = expf(s - m_new);
          l[h] = l[h] * alpha + p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = fmaf(p, vv[e], acc[h][e] * alpha);
          m[h] = m_new;
        }
      }
    }
    __syncthreads();
    if (t + n_stages < n_tiles)
      issue_tile<D, CT, KT>(stage, L::raw_row, k, v, g, S, Hkv, g.kb + (t + n_stages) * KT);
    cp_async_commit();
  }
  cp_async_wait(0);

  // Merge the RPW row-group streams of a warp (lanes at the same `sub`
  // hold the same dims, LPR lanes apart), then the warps.
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      const float mo = __shfl_xor_sync(kFull, m[h], off);
      const float lo = __shfl_xor_sync(kFull, l[h], off);
      const float M = fmaxf(m[h], mo);
      const float a = rescale(m[h], M), ao = rescale(mo, M);
      l[h] = l[h] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float acc_o = __shfl_xor_sync(kFull, acc[h][e], off);
        acc[h][e] = acc[h][e] * a + acc_o * ao;
      }
      m[h] = M;
    }
  }
  float* w_acc = reinterpret_cast<float*>(ring);        // [kWarps][GB][D]
  float* o_s = w_acc + kWarps * GB * D;                 // [GB][D]
  float* w_s = o_s + GB * D;                            // [kMaxSplits][GB][2]
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      if (sub == 0) {
        w_m[warp][h] = m[h];
        w_l[warp][h] = l[h];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) w_acc[(warp * GB + h) * D + dim_of(e)] = acc[h][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < GB * D; i += kThreads) {
    const int h = i / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w][h]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = rescale(w_m[w][h], M);
      Lsum += w_l[w][h] * a;
      A += w_acc[w * GB * D + i] * a;
    }
    o_s[i] = A;
    if (i % D == 0) {
      m_fin[h] = M;
      l_fin[h] = Lsum;
    }
  }
  __syncthreads();
  finish<GB, D>(o_s, m_fin, l_fin, w_s, L_fin, &last, out, part, counters, lse, g, G, Hkv,
                n_splits);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Once per device and kernel: allow the largest dynamic shared memory any
// launch of it asks for.  Devices past the 64th are set up at every launch.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t max_smem, std::atomic<uint64_t>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (configured.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)max_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured.fetch_or(bit, std::memory_order_release);
  return err;
}

// Ring stages: enough for the longest split (keys_max), within the budget.
inline int stages_for(int keys_max, int keys_per_tile, int max_stages) {
  const int tiles = (keys_max + keys_per_tile - 1) / keys_per_tile;
  return tiles < 1 ? 1 : (tiles < max_stages ? tiles : max_stages);
}

// Keys the longest split can hold: split_plan's chunk over n_valid <= S.
inline int longest_split(int S, int n_splits) {
  const int chunk = ((S + n_splits - 1) / n_splits + 15) / 16 * 16;
  return chunk > kMinKeys + 15 ? chunk : kMinKeys + 15;
}

template <int D, typename CT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* pos,
                        void* out, void* part, void* counters, void* lse, int B, int Hq,
                        int Hkv, int S, int n_splits, float scale, float softcap,
                        cudaStream_t st) {
  using L = MmaLayout<D, CT>;
  static_assert(L::max_stages() >= 1, "a ring stage must fit");
  static std::atomic<uint64_t> configured{0};
  auto kernel = &flash_decode_bf16_kernel<D, CT>;
  cudaError_t err = configure(kernel, L::smem_bytes(L::max_stages()), configured);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const int stages = stages_for(longest_split(S, n_splits), kMmaKeys, L::max_stages());
  const dim3 grid(n_splits, Hkv * ((G + kMmaHeads - 1) / kMmaHeads), B);
  kernel<<<grid, kThreads, L::smem_bytes(stages), st>>>(
      static_cast<const bf16*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const int*>(pos), static_cast<bf16*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<float*>(lse), S, Hkv, G, n_splits, stages,
      scale, softcap);
  return cudaGetLastError();
}

template <int D, typename CT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* pos,
                       void* out, void* part, void* counters, void* lse, int B, int Hq,
                       int Hkv, int S, int n_splits, float scale, float softcap,
                       cudaStream_t st) {
  using L = F32Layout<D, CT>;
  static_assert(L::max_stages() >= 1, "a ring stage must fit");
  static std::atomic<uint64_t> configured{0};
  auto kernel = &flash_decode_f32_kernel<D, CT>;
  cudaError_t err = configure(kernel, L::smem_bytes(L::max_stages()), configured);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  const int stages = stages_for(longest_split(S, n_splits), kF32Keys, L::max_stages());
  const dim3 grid(n_splits, Hkv * ((G + kF32Heads - 1) / kF32Heads), B);
  kernel<<<grid, kThreads, L::smem_bytes(stages), st>>>(
      static_cast<const float*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<float*>(lse), S, Hkv, G, n_splits, stages,
      scale, softcap);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, const void*, void*,
                                 void*, void*, void*, int, int, int, int, int, float, float,
                                 cudaStream_t);

template <int D>
Launcher pick(int q_dtype, int cache_fp8) {
  if (q_dtype == 0) return cache_fp8 ? &launch_f32<D, fp8> : &launch_f32<D, float>;
  return cache_fp8 ? &launch_bf16<D, fp8> : &launch_bf16<D, bf16>;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and out).  cache_fp8: 0 = k/v in
// q's type, 1 = float8_e4m3fn.  n_splits: splits of S in the grid (see
// split_plan).  part: a workspace of
// B*Hkv*ceil(G/heads)*n_splits*heads*(D+2) floats (heads = 8 for float32,
// 16 for bfloat16); counters: B*Hkv*ceil(G/heads) int32, zero before the
// first launch and left zero by every launch.  lse: null, or B*Hq floats
// that receive each query row's log-sum-exp of its scaled (softcapped)
// scores over the valid keys (what a caller merging sequence shards
// needs).  Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* part,
                                       void* counters, void* lse, int q_dtype, int cache_fp8,
                                       int B, int Hq, int Hkv, int S, int D, int n_splits,
                                       float scale, float softcap, void* stream) {
  if (q_dtype < 0 || q_dtype > 1 || n_splits < 1 || n_splits > kMaxSplits || S < 1 ||
      Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  Launcher fn = nullptr;
  switch (D) {
    case 32: fn = pick<32>(q_dtype, cache_fp8); break;
    case 64: fn = pick<64>(q_dtype, cache_fp8); break;
    case 128: fn = pick<128>(q_dtype, cache_fp8); break;
    case 256: fn = pick<256>(q_dtype, cache_fp8); break;
    default: return cudaErrorInvalidValue;
  }
  return fn(q, k, v, pos, out, part, counters, lse, B, Hq, Hkv, S, n_splits, scale, softcap,
            static_cast<cudaStream_t>(stream));
}
