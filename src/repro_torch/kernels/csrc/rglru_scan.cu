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
// 3*B*S*W*4 bytes / 3.35 TB/s.
//
// Design (correct and simple first): one thread per (batch, channel)
// walks S in order, carrying h in a register.  Neighbouring threads hold
// neighbouring channels, so every load and store of a step is coalesced
// across the warp.  The walk is a chain of dependent multiply-adds, so
// each thread loads kUnroll steps of a and b ahead of using them, which
// keeps that many loads in flight per thread.  Blocks of 64 threads give
// B*W/64 blocks: 128 at recurrentgemma-9b's W=4096, B=2, about one per SM.
// A segmented scan across S (per-segment composition, then a carry
// fix-up) would fill the card at small B*W; it is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int bb = blockIdx.y;
  if (w >= W) return;
  float state = h0 ? h0[(size_t)bb * W + w] : 0.f;
  const size_t base = (size_t)bb * S * W + w;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a[base + (size_t)(t + u) * W];
      bv[u] = b[base + (size_t)(t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = fmaf(av[u], state, bv[u]);
      h[base + (size_t)(t + u) * W] = state;
    }
  }
  for (; t < S; ++t) {
    state = fmaf(a[base + (size_t)t * W], state, b[base + (size_t)t * W]);
    h[base + (size_t)t * W] = state;
  }
  h_last[(size_t)bb * W + w] = state;
}

}  // namespace

// a, b, h [B,S,W] and h0, h_last [B,W], all f32 and contiguous; h0 may be
// null (zero initial state).  Returns a cudaError_t.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, void* h_last, int B, int S, int W,
                                 void* stream) {
  if (B < 1 || S < 1 || W < 1) return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W);
  return cudaGetLastError();
}
