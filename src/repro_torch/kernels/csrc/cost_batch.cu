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
// What bounds it on the H100: bytes.  Three inputs read and two outputs
// written once, 20 bytes a query in float and 40 in double, against about
// 30 operations a query: at m = 1,000,000 the bound is 6.0 us (float) and
// 11.9 us (double) at 3.35 TB/s.  Design (correct and simple first): one
// thread per query, a grid-stride loop over blocks of 256 threads, at most
// 8 blocks an SM; neighbouring threads read neighbouring queries, so every
// load and store is coalesced.  Vector loads are later work.

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
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mn(double a, double b) { return fmin(a, b); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cost_batch_kernel(const T* __restrict__ new_tokens, const T* __restrict__ context,
                  const T* __restrict__ batch, T* __restrict__ flops_out,
                  T* __restrict__ bytes_out, long long m, const Consts<T> c) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m; i += stride) {
    const T nt = new_tokens[i];
    const T ctx = context[i];
    const T bt = batch[i];
    const T tokens = mul(bt, nt);
    const T cc = c.has_clamp ? mn(ctx, c.clamp) : ctx;

    T flops = mul(c.k_dense, tokens);
    if (c.ssm) {
      flops = add(flops, mul(mul(mul(c.ssm_layers, bt), nt), c.ssm_flops));
    } else {
      T t = mul(mul(mul(mul(mul(mul(c.attn_layers, bt), T(4)), c.heads), c.head_dim), nt), cc);
      flops = add(flops, t);
      if (c.has_xattn) {
        t = mul(mul(mul(mul(mul(mul(c.xattn_layers, bt), T(4)), c.heads), c.head_dim), nt),
                c.n_frames);
        flops = add(flops, t);
      }
    }
    if (c.moe) flops = add(flops, mul(mul(mul(c.router_layers, bt), nt), c.router_flops));

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
      T extra = mul(mul(bt, cc), c.kv_bytes);
      if (c.ssm) extra = add(extra, mul(bt, c.ssm_state_bytes));
      bytes = add(bytes, extra);
    }
    flops_out[i] = flops;
    bytes_out[i] = bytes;
  }
}

template <typename T>
int launch(const void* nt, const void* ctx, const void* bt, void* flops, void* bytes,
           long long m, const CostBatchParams& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = (m + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  cost_batch_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(nt), static_cast<const T*>(ctx), static_cast<const T*>(bt),
      static_cast<T*>(flops), static_cast<T*>(bytes), m, Consts<T>(p));
  return cudaGetLastError();
}

}  // namespace

extern "C" int cost_batch_params_size() { return (int)sizeof(CostBatchParams); }

// new_tokens, context, batch, flops, bytes: m contiguous elements each, all
// float (dtype 0) or all double (dtype 1), on one device.  Returns a
// cudaError_t.
extern "C" int cost_batch_launch(int dtype, const void* new_tokens, const void* context,
                                 const void* batch, void* flops, void* bytes, long long m,
                                 CostBatchParams params, void* stream) {
  if (m < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(new_tokens, context, batch, flops, bytes, m, params, st);
  if (dtype == 1)
    return launch<double>(new_tokens, context, batch, flops, bytes, m, params, st);
  return cudaErrorInvalidValue;
}
