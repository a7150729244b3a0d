// Analytic pass-cost surface for Hopper (sm_90a): kernel B2 of the port.
//
// Replaces the TPU kernel `repro/kernels/cost_batch.py` `pass_costs_pallas`
// (Pallas body `kernel`, which evaluates `pass_surface`): per query, the
// FLOPs and HBM bytes of one forward pass of a model that processes
// new_tokens positions per sequence against context attended positions
// at a batch size, term for term as `repro/energy/costs.py`
// `pass_costs_batch` defines them.
//
//   flops = 2 N_active tokens + attention (window-clamped; hybrid: local
//           window; encdec: decoder layers + cross-attention; MLA head dim)
//           | ssm per-token term, + MoE router
//   bytes = weights (MoE: non-routed + min(E, tokens top_k) experts)
//           + activations + KV writes [+ decode: clamped cache read, SSM
//           state traffic]
//
// The model's structure is fixed per launch: the host resolves every
// constant from the ModelConfig, as the reference does at trace time, into
// one plain struct passed by value, and the family branches are uniform
// across the launch.  Two instances from one template: float, the TPU
// kernel's numerics (the host's constants rounded to float, the reference's
// weak-typed Python numbers), and double, the precision the decode
// integral of `simulate_batch` needs.  Every product and sum is a separate
// correctly rounded operation in the reference's order (the _rn
// intrinsics, which the compiler never fuses into an FMA), so each
// instance gives the plain PyTorch version's values bit for bit.
//
// What bounds it on the H100: bytes.  About 30 operations a query against
// 8 to 24 bytes (float) or 16 to 48 (double): each array operand read once
// and two outputs written once.  At m = 1,000,000 with three per-query
// inputs the bound is 6.0 us (float) and 11.9 us (double) at 3.35 TB/s; on
// simulate_batch's own calls, one array input (the prefill's new tokens and
// context are one tensor, the decode probes' new tokens are a uniform 1,
// the batch is a uniform value), 7.2 us in double.  So the design moves
// only those bytes, in the widest accesses, with enough of them in flight:
//
// - Vector access.  Thread t of block b owns the 16-byte vectors
//   b * kThreads * V + j * kThreads + t, j < V, of every array operand
//   (float4 or double2: four or two neighbouring queries), so a warp's
//   load is 512 contiguous bytes.  It issues all its loads
//   (ld.global.nc.L1::no_allocate: read-only path, no L1 allocation) before
//   its first arithmetic operation and writes both outputs with streaming
//   stores (__stcs).  V is 4 with at most one array operand (simulate_batch's
//   calls) and 2 with two or three.
// - The grid covers m once, ceil(vectors / (kThreads V)) blocks, with no
//   grid-stride loop: at m = 10^6, 489 blocks for simulate_batch's calls
//   (34 and 40 registers: 6 blocks an SM, one wave on 132 SMs), 489
//   (float) and 977 (double, 46 registers: 5 an SM, two waves) for
//   per-query inputs.  kThreads = 256 and V = 4 or 2 were chosen by timing
//   builds at kThreads in {128, 256, 512} and V in {1, 2, 4} on the H100:
//   V = 4 was fastest for the decode probe's one array, and no shape moved
//   the per-query rows beyond their spread.  The profiler's kernel
//   durations are ~0.004 ms under the timed launches (one launch between
//   CUDA events, L2 flushed): at this size that fixed cost is over half
//   the float bound (PERF.md, B2).
// - Operand modes, fixed per launch and compiled as template arguments:
//   new_tokens, context and batch are each an m-element array or a uniform
//   value, which each thread reads once from its device pointer (the host
//   never reads it); context may instead alias new_tokens and is then not
//   read at all.  The products of the constants with the batch come first
//   in the reference's order, so with a uniform batch they are one set of
//   products a thread; every value is unchanged.
// - Alignment.  The outputs are fresh allocations, 16-byte aligned.  An
//   array input off a 16-byte boundary (a slice such as t[1:]) is read
//   element by element inside the same vector loop, and the last m mod 4
//   or 2 queries (the tail) are computed one at a time by the first
//   threads of block 0.  No copy, no second launch.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by `CostBatchParams` in kernels/cost_batch.py
// (doubles, then int32s); the wrapper checks the sizes agree at load.
struct CostBatchParams {
  double k_dense;          // 2 * active params
  double attn_layers;      // attention layers of the context term
  double heads;
  double head_dim;         // MLA: nope + rope dims
  double clamp;            // context clamp when has_clamp (window; hybrid: local window)
  double xattn_layers;     // encdec cross-attention: decoder layers
  double n_frames;
  double ssm_layers;
  double ssm_flops;        // ssm per-token flops a layer: 2 H P N 4
  double router_layers;    // MoE layers
  double router_flops;     // 2 d E + 32 E
  double weight_bytes;     // all weights; MoE: the non-routed ones
  double n_experts;
  double top_k;
  double expert_bytes;     // MoE layers x one expert's params
  double elem_bytes;       // bytes of a parameter
  double act_bytes;        // n_layers d_model 12 b
  double kv_bytes;         // KV bytes a token
  double ssm_state_bytes;  // 2 x the SSM state bytes (decode)
  int32_t ssm;             // 1: ssm term, no attention term
  int32_t has_clamp;
  int32_t has_xattn;
  int32_t moe;
  int32_t include_weights;
  int32_t decode;
};

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;      // 16-byte vectors a thread and array, with two or three arrays
constexpr int kVecsOne = 4;   // with at most one

// Operand modes (the wrapper's ARRAY, UNIFORM, ALIAS).
constexpr int kArray = 0;     // m elements
constexpr int kUniform = 1;   // one value for every query
constexpr int kAlias = 2;     // context only: the new_tokens tensor itself

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mn(double a, double b) { return fmin(a, b); }

// A 16-byte vector of the instance's type: kN queries.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int kN = 4;
  __device__ __forceinline__ static type load(const type* p) {
    type v;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  }
  __device__ __forceinline__ static void unpack(const type& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ __forceinline__ static type pack(const float* o) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int kN = 2;
  __device__ __forceinline__ static type load(const type* p) {
    type v;
    asm("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];"
        : "=d"(v.x), "=d"(v.y) : "l"(p));
    return v;
  }
  __device__ __forceinline__ static void unpack(const type& v, double* o) {
    o[0] = v.x; o[1] = v.y;
  }
  __device__ __forceinline__ static type pack(const double* o) {
    return make_double2(o[0], o[1]);
  }
};

// The constants in the instance's type, rounded once on the host.
template <typename T>
struct Consts {
  T k_dense, attn_layers, heads, head_dim, clamp, xattn_layers, n_frames,
      ssm_layers, ssm_flops, router_layers, router_flops, weight_bytes,
      n_experts, top_k, expert_bytes, elem_bytes, act_bytes, kv_bytes,
      ssm_state_bytes;
  int ssm, has_clamp, has_xattn, moe, include_weights, decode;

  explicit Consts(const CostBatchParams& p)
      : k_dense(T(p.k_dense)), attn_layers(T(p.attn_layers)), heads(T(p.heads)),
        head_dim(T(p.head_dim)), clamp(T(p.clamp)), xattn_layers(T(p.xattn_layers)),
        n_frames(T(p.n_frames)), ssm_layers(T(p.ssm_layers)), ssm_flops(T(p.ssm_flops)),
        router_layers(T(p.router_layers)), router_flops(T(p.router_flops)),
        weight_bytes(T(p.weight_bytes)), n_experts(T(p.n_experts)), top_k(T(p.top_k)),
        expert_bytes(T(p.expert_bytes)), elem_bytes(T(p.elem_bytes)),
        act_bytes(T(p.act_bytes)), kv_bytes(T(p.kv_bytes)),
        ssm_state_bytes(T(p.ssm_state_bytes)), ssm(p.ssm), has_clamp(p.has_clamp),
        has_xattn(p.has_xattn), moe(p.moe), include_weights(p.include_weights),
        decode(p.decode) {}
};

// The products of the constants with one batch value that lead the
// reference's products, in its order: once a thread for a uniform batch.
template <typename T>
struct BatchTerms {
  T bt, ssm, attn, xattn, router, state;

  __device__ __forceinline__ BatchTerms(const Consts<T>& c, T b) : bt(b) {
    ssm = router = state = attn = xattn = T(0);
    if (c.ssm) {
      ssm = mul(c.ssm_layers, b);
      if (c.decode) state = mul(b, c.ssm_state_bytes);
    } else {
      attn = mul(mul(mul(mul(c.attn_layers, b), T(4)), c.heads), c.head_dim);
      if (c.has_xattn) xattn = mul(mul(mul(mul(c.xattn_layers, b), T(4)), c.heads), c.head_dim);
    }
    if (c.moe) router = mul(c.router_layers, b);
  }
};

// One query: pass_surface_plain's flops and bytes, product for product.
template <typename T>
__device__ __forceinline__ void query(const Consts<T>& c, const BatchTerms<T>& b, T nt, T ctx,
                                      T& flops_out, T& bytes_out) {
  const T tokens = mul(b.bt, nt);
  const T cc = c.has_clamp ? mn(ctx, c.clamp) : ctx;

  T flops = mul(c.k_dense, tokens);
  if (c.ssm) {
    flops = add(flops, mul(mul(b.ssm, nt), c.ssm_flops));
  } else {
    flops = add(flops, mul(mul(b.attn, nt), cc));
    if (c.has_xattn) flops = add(flops, mul(mul(b.xattn, nt), c.n_frames));
  }
  if (c.moe) flops = add(flops, mul(mul(b.router, nt), c.router_flops));

  T bytes = T(0);
  if (c.include_weights) {
    if (c.moe) {
      const T hit = mn(c.n_experts, mul(tokens, c.top_k));
      bytes = add(bytes, mul(add(c.weight_bytes, mul(hit, c.expert_bytes)), c.elem_bytes));
    } else {
      bytes = add(bytes, c.weight_bytes);
    }
  }
  bytes = add(bytes, mul(tokens, c.act_bytes));
  bytes = add(bytes, mul(tokens, c.kv_bytes));
  if (c.decode) {
    T extra = mul(mul(b.bt, cc), c.kv_bytes);
    if (c.ssm) extra = add(extra, b.state);
    bytes = add(bytes, extra);
  }
  flops_out = flops;
  bytes_out = bytes;
}

struct Operands {
  const void* nt;
  const void* ctx;
  const void* bt;
  void* flops;
  void* bytes;
  long long m;
  long long nvec;      // whole 16-byte vectors of the outputs
  int scalar;          // bit 0, 1, 2: new_tokens, context, batch read element by element
};

// Vector v (of kN queries) of an array operand into o.
template <typename T>
__device__ __forceinline__ void load_array(const T* p, long long v, bool by_element, T* o) {
  using V = Vec<T>;
  if (by_element) {
#pragma unroll
    for (int k = 0; k < V::kN; ++k) o[k] = __ldg(p + v * V::kN + k);
  } else {
    V::unpack(V::load(reinterpret_cast<const typename V::type*>(p) + v), o);
  }
}

// Query i alone, element by element (the tail).
template <typename T, int NT, int CTX, int BT>
__device__ __forceinline__ void one_query(const Operands& a, const Consts<T>& c, long long i,
                                          T nt_u, T ctx_u, T bt_u) {
  const T nt = NT == kUniform ? nt_u : __ldg(static_cast<const T*>(a.nt) + i);
  const T ctx = CTX == kUniform ? ctx_u
                : CTX == kAlias ? nt : __ldg(static_cast<const T*>(a.ctx) + i);
  const BatchTerms<T> b(c, BT == kUniform ? bt_u : __ldg(static_cast<const T*>(a.bt) + i));
  query(c, b, nt, ctx, static_cast<T*>(a.flops)[i], static_cast<T*>(a.bytes)[i]);
}

// 16-byte vectors of each array operand a thread.
template <int NT, int CTX, int BT>
__host__ __device__ constexpr int vecs() {
  return (NT == kArray) + (CTX == kArray) + (BT == kArray) <= 1 ? kVecsOne : kVecs;
}

template <typename T, int NT, int CTX, int BT>
__global__ void __launch_bounds__(kThreads)
cost_batch_kernel(const Operands a, const Consts<T> c) {
  using V = Vec<T>;
  constexpr int N = V::kN;
  constexpr int kV = vecs<NT, CTX, BT>();
  const T* nt_p = static_cast<const T*>(a.nt);
  const T* ctx_p = static_cast<const T*>(a.ctx);
  const T* bt_p = static_cast<const T*>(a.bt);
  T* flops_p = static_cast<T*>(a.flops);
  T* bytes_p = static_cast<T*>(a.bytes);

  // uniform operands: one read a thread
  const T nt_u = NT == kUniform ? __ldg(nt_p) : T(0);
  const T ctx_u = CTX == kUniform ? __ldg(ctx_p) : T(0);
  const T bt_u = BT == kUniform ? __ldg(bt_p) : T(0);

  // the tail, one query a thread, in block 0
  if (blockIdx.x == 0 && a.nvec * N + threadIdx.x < a.m)
    one_query<T, NT, CTX, BT>(a, c, a.nvec * N + threadIdx.x, nt_u, ctx_u, bt_u);

  // the body: every load of the thread first, then the arithmetic
  const long long v0 = (long long)blockIdx.x * kThreads * kV + threadIdx.x;
  T nt[kV][N], ctx[kV][N], bt[kV][N];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const long long v = v0 + (long long)j * kThreads;
    if (v < a.nvec) {
      if (NT == kArray) load_array(nt_p, v, a.scalar & 1, nt[j]);
      if (CTX == kArray) load_array(ctx_p, v, a.scalar & 2, ctx[j]);
      if (BT == kArray) load_array(bt_p, v, a.scalar & 4, bt[j]);
    }
  }
  const BatchTerms<T> bu(c, bt_u);   // a uniform batch's products, once
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const long long v = v0 + (long long)j * kThreads;
    if (v < a.nvec) {
      T f[N], b[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const T x = NT == kUniform ? nt_u : nt[j][k];
        const T y = CTX == kUniform ? ctx_u : CTX == kAlias ? x : ctx[j][k];
        if (BT == kUniform) {
          query(c, bu, x, y, f[k], b[k]);
        } else {
          query(c, BatchTerms<T>(c, bt[j][k]), x, y, f[k], b[k]);
        }
      }
      __stcs(reinterpret_cast<typename V::type*>(flops_p) + v, V::pack(f));
      __stcs(reinterpret_cast<typename V::type*>(bytes_p) + v, V::pack(b));
    }
  }
}

template <typename T, int NT, int CTX, int BT>
int launch(const Operands& a, const CostBatchParams& p, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * vecs<NT, CTX, BT>();
  const long long blocks = a.nvec > 0 ? (a.nvec + per_block - 1) / per_block : 1;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cost_batch_kernel<T, NT, CTX, BT><<<(unsigned)blocks, kThreads, 0, stream>>>(a, Consts<T>(p));
  return cudaGetLastError();
}

template <typename T, int NT, int CTX>
int pick_batch(int bt_mode, const Operands& a, const CostBatchParams& p, cudaStream_t s) {
  if (bt_mode == kArray) return launch<T, NT, CTX, kArray>(a, p, s);
  if (bt_mode == kUniform) return launch<T, NT, CTX, kUniform>(a, p, s);
  return cudaErrorInvalidValue;
}

template <typename T, int NT>
int pick_context(int ctx_mode, int bt_mode, const Operands& a, const CostBatchParams& p,
                 cudaStream_t s) {
  if (ctx_mode == kArray) return pick_batch<T, NT, kArray>(bt_mode, a, p, s);
  if (ctx_mode == kUniform) return pick_batch<T, NT, kUniform>(bt_mode, a, p, s);
  if (ctx_mode == kAlias) return pick_batch<T, NT, kAlias>(bt_mode, a, p, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_modes(int nt_mode, int ctx_mode, int bt_mode, Operands a, const CostBatchParams& p,
                 cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(a.flops) % 16 || reinterpret_cast<uintptr_t>(a.bytes) % 16)
    return cudaErrorMisalignedAddress;
  a.nvec = a.m / Vec<T>::kN;
  a.scalar = 0;
  const void* ptrs[3] = {a.nt, a.ctx, a.bt};
  const int modes[3] = {nt_mode, ctx_mode, bt_mode};
  for (int k = 0; k < 3; ++k) {
    if (reinterpret_cast<uintptr_t>(ptrs[k]) % sizeof(T)) return cudaErrorMisalignedAddress;
    if (modes[k] == kArray && reinterpret_cast<uintptr_t>(ptrs[k]) % 16) a.scalar |= 1 << k;
  }
  if (nt_mode == kArray) return pick_context<T, kArray>(ctx_mode, bt_mode, a, p, s);
  if (nt_mode == kUniform) return pick_context<T, kUniform>(ctx_mode, bt_mode, a, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int cost_batch_params_size() { return (int)sizeof(CostBatchParams); }

// new_tokens, context, batch: each m contiguous elements (mode 0), one
// element for every query (mode 1), or, for context only, new_tokens
// itself (mode 2: the context pointer is not read).  flops, bytes: m
// contiguous elements on a 16-byte boundary.  All float
// (dtype 0) or all double (dtype 1), on one device.  Returns a cudaError_t.
extern "C" int cost_batch_launch(int dtype, const void* new_tokens, const void* context,
                                 const void* batch, void* flops, void* bytes, long long m,
                                 CostBatchParams params, int nt_mode, int ctx_mode,
                                 int bt_mode, void* stream) {
  if (m < 1 || (ctx_mode == kAlias && nt_mode != kArray)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Operands a{new_tokens, context, batch, flops, bytes, m, 0, 0};
  if (dtype == 0) return launch_modes<float>(nt_mode, ctx_mode, bt_mode, a, params, st);
  if (dtype == 1) return launch_modes<double>(nt_mode, ctx_mode, bt_mode, a, params, st);
  return cudaErrorInvalidValue;
}
