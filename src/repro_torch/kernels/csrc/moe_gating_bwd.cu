// MoE gating backward for Hopper (sm_90a): the gradient of the logits
// through moe_gating.cu's k gates (the expert ids carry none).  Per row,
// with p = softmax(logits) recomputed in float32, the chosen probabilities
// p_t = p[id_t] and their sum S (in pass order, as the forward adds them):
//
//   gates_t = p_t / max(S, 1e-9)
//   dp_t = (dg_t − Σ_u dg_u·gates_u) / S   where S >= 1e-9, else dg_t / 1e-9
//   dlogits = p∘(dp − Σ_t dp_t·p_t),        dp zero off the chosen experts
//
// (at S >= 1e-9, not > : the max passes the gradient at a tie, as
// autograd's clamp_min does).  The TPU kernel
// src/repro/kernels/moe_gating.py (moe_gating_pallas) has no backward; the
// port's MoE layer calls the forward kernel, so training on the card needs
// this one.
//
// What bounds it on the H100: bytes (the logits read and their gradient
// written, ~6 flops a logit), and at the model's sizes the launch.  One
// warp owns one row as in the forward: lane l holds experts l, l + 32, ...
// in registers; the row's probabilities also go to the warp's slice of
// shared memory so that lane t < k reads p[id_t] directly, and dp is
// scattered there the same way.  The reductions are warp shuffles.  No
// atomics: the gradient is the same from run to run.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxE = 256;
constexpr int kEPL = kMaxE / 32;  // experts a lane, at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_gating_bwd_kernel(const T* __restrict__ logits,   // (rows, E)
                          const int* __restrict__ ids,    // (rows, k)
                          const float* __restrict__ dg,   // (rows, k)
                          T* __restrict__ dlogits,        // (rows, E)
                          int rows, int E, int k) {
  __shared__ float p_s[kWarps][kMaxE];
  __shared__ float dp_s[kWarps][kMaxE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = logits + static_cast<size_t>(row) * E;

  float p[kEPL];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kEPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? to_float(xr[e]) : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kEPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int j = 0; j < kEPL; ++j) {
    const int e = lane + 32 * j;
    p[j] /= sum;
    if (e < E) {
      p_s[warp][e] = p[j];
      dp_s[warp][e] = 0.f;
    }
  }
  __syncwarp();

  // Lane t < k: pass t's id, its probability and its gate's gradient.
  const size_t o = static_cast<size_t>(row) * k + lane;
  const bool chosen = lane < k;
  const int id = chosen ? ids[o] : 0;
  const float pt = chosen ? p_s[warp][id] : 0.f;
  const float dgt = chosen ? dg[o] : 0.f;
  float S = 0.f;  // in pass order, as the forward sums the gates
  for (int t = 0; t < k; ++t) S += __shfl_sync(kFull, pt, t);
  const bool clamped = !(S >= 1e-9f);
  const float gate = pt / fmaxf(S, 1e-9f);
  const float dgg = warp_sum(dgt * gate);
  const float dpt = clamped ? dgt / 1e-9f : (dgt - dgg) / S;
  const float c = warp_sum(dpt * pt);
  if (chosen) dp_s[warp][id] = dpt;
  __syncwarp();

  T* out = dlogits + static_cast<size_t>(row) * E;
#pragma unroll
  for (int j = 0; j < kEPL; ++j) {
    const int e = lane + 32 * j;
    if (e < E) out[e] = from_float<T>(p[j] * (dp_s[warp][e] - c));
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int* ids, const float* dg, void* dlogits, int rows,
                   int E, int k, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  moe_gating_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), ids, dg, static_cast<T*>(dlogits), rows, E, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// logits, dlogits: (rows, E), contiguous, of the storage type `dtype`; ids:
// (rows, k) int32, distinct within a row, as the forward returns them; dg:
// (rows, k) float32, the gates' gradient.  1 <= k <= min(E, 32), E <= 256.
// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).
extern "C" int moe_gating_bwd_launch(const void* logits, const int* ids, const float* dg,
                                     void* dlogits, int dtype, int rows, int E, int k,
                                     void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || E <= 0 || E > kMaxE || k <= 0 || k > E || k > 32) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return launch<float>(logits, ids, dg, dlogits, rows, E, k, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(logits, ids, dg, dlogits, rows, E, k, s);
  return cudaErrorInvalidValue;
}
