// MoE gating backward for Hopper (sm_90a): the gradient of the logits
// through moe_gating.cu's k gates (the expert ids carry none).  Per row,
// with p = softmax(logits) recomputed in float32, the chosen probabilities
// p_t = p[id_t] and their sum S (in pass order, as the forward adds them):
//
//   gates_t = p_t / max(S, 1e-9)
//   dp_t = (dg_t − Σ_u dg_u·gates_u) / S   where S >= 1e-9, else dg_t / 1e-9
//   dlogits = p∘(dp − Σ_t dp_t·p_t),        dp zero off the chosen experts
//
// where Σ_t dp_t·p_t is 0 unless S is clamped (below).
//
// (at S >= 1e-9, not > : the max passes the gradient at a tie, as
// autograd's clamp_min does).  The TPU kernel
// src/repro/kernels/moe_gating.py (moe_gating_pallas) has no backward; the
// port's MoE layer calls the forward kernel, so training on the card needs
// this one.
//
// What bounds it on the H100: bytes in principle (the logits read and
// their gradient written, ~6 flops a logit: 0.64 us at Arctic's (2048,
// 128), k 2), in fact the launch and one chain of dependent steps per row,
// as in the forward.  The design takes the forward's (moe_gating.cu): one
// warp owns one row, and where E % 4 == 0 and the rows are aligned lane l
// holds experts 4l .. 4l+3 of each 128 (one 16-byte float4 load or store,
// 8 bytes of bf16); other E take the scalar layout, lane l holding l,
// l + 32, ....  The chain is kept short:
// - lane t < k loads pass t's id and gate gradient in the same round trip
//   as the row's logits;
// - the logit maximum is one `redux.sync`, the softmax sum a shuffle
//   butterfly;
// - lane t fetches p[id_t] from the lane that holds it, one shuffle a slot
//   of the layout, all independent; the gate sum and the one weighted sum
//   the gradient needs add the k passes in pass order, 2k independent
//   shuffles; the softmax divides by one reciprocal;
// - dp_t reaches its expert's lane by 2k independent shuffles.
// No shared memory, no barrier and no atomics: the gradient is the same
// from run to run.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;  // rows a block, as in the forward
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// VEC values from `src` to `dst` (aligned to VEC elements) in the storage type.
template <int VEC>
__device__ __forceinline__ void store_chunk(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
    dst[0] = src[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* src) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(src[0], src[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(src[2], src[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&a);
    v.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(dst) = v;
  } else {
    dst[0] = from_float<__nv_bfloat16>(src[0]);
  }
}

// VEC: adjacent logits a lane loads at once (4 or 1); CHUNKS: loads a lane
// makes.  Slot j of lane l holds expert 32·VEC·(j / VEC) + VEC·l + j % VEC,
// as in the forward.  E <= 32·VEC·CHUNKS.
template <typename T, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
    moe_gating_bwd_kernel(const T* __restrict__ logits,   // (rows, E)
                          const int* __restrict__ ids,    // (rows, k)
                          const float* __restrict__ dg,   // (rows, k)
                          T* __restrict__ dlogits,        // (rows, E)
                          int rows, int E, int k) {
  constexpr int EPL = VEC * CHUNKS;
  constexpr int SPAN = 32 * VEC;  // experts of one chunk across the warp
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = logits + static_cast<size_t>(row) * E;

  // Lane t < k: pass t's id and its gate's gradient, in flight with the logits.
  const bool chosen = lane < k;
  const size_t o = static_cast<size_t>(row) * k + lane;
  const int my_id = chosen ? ids[o] : 0;
  const float my_dg = chosen ? dg[o] : 0.f;
  int expert[EPL];
  float p[EPL];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = SPAN * c + VEC * lane;
#pragma unroll
    for (int v = 0; v < VEC; ++v) expert[VEC * c + v] = e0 + v;
    // E % VEC == 0, so a chunk lies wholly inside the row or wholly past it.
    if (e0 < E) {
      load_chunk<VEC>(xr + e0, p + VEC * c);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) p[VEC * c + v] = -INFINITY;
    }
  }

  float lane_max = p[0];
#pragma unroll
  for (int j = 1; j < EPL; ++j) lane_max = fmaxf(lane_max, p[j]);
  const float mx = key_value(__reduce_max_sync(kFull, order_key(lane_max)));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    p[j] = expert[j] < E ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  const float inv = 1.f / warp_sum(sum);
#pragma unroll
  for (int j = 0; j < EPL; ++j) p[j] *= inv;

  // p[id] of this lane's pass: its owner lane offers each slot in turn.
  const int owner = (my_id % SPAN) / VEC;
  const int my_slot = (my_id / SPAN) * VEC + my_id % VEC;
  float pt = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const float x = __shfl_sync(kFull, p[j], owner);
    if (j == my_slot) pt = x;
  }
  if (!chosen) pt = 0.f;
  // S and A = Σ_t dg_t·p_t, both in pass order (2k independent shuffles).
  // Then dgg = A / S, and Σ_t dp_t·p_t = (A − dgg·S) / S is 0 where S is
  // not clamped (the renormalised gates sum to 1 whatever the logits), and
  // A / 1e-9 where it is.
  float S = 0.f, A = 0.f;
  const float dgp = my_dg * pt;
  for (int t = 0; t < k; ++t) {
    S += __shfl_sync(kFull, pt, t);
    A += __shfl_sync(kFull, dgp, t);
  }
  const bool clamped = !(S >= 1e-9f);
  const float dpt = clamped ? my_dg / 1e-9f : (my_dg - A / S) / S;
  const float cross = clamped ? A / 1e-9f : 0.f;

  // dp of this lane's experts: each pass's dp_t at its id.
  float dp[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) dp[j] = 0.f;
  for (int t = 0; t < k; ++t) {
    const int id = __shfl_sync(kFull, my_id, t);
    const float d = __shfl_sync(kFull, dpt, t);
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (expert[j] == id) dp[j] = d;
    }
  }

  T* out = dlogits + static_cast<size_t>(row) * E;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = SPAN * c + VEC * lane;
    if (e0 < E) {
      float g[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) g[v] = p[VEC * c + v] * (dp[VEC * c + v] - cross);
      store_chunk<VEC>(out + e0, g);
    }
  }
}

template <typename T, int VEC, int CHUNKS>
cudaError_t launch(const void* logits, const int* ids, const float* dg, void* dlogits, int rows,
                   int E, int k, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  moe_gating_bwd_kernel<T, VEC, CHUNKS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), ids, dg, static_cast<T*>(dlogits), rows, E, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_e(const void* logits, const int* ids, const float* dg, void* dlogits,
                       int rows, int E, int k, cudaStream_t stream) {
  // Vector loads and stores need every row's start aligned to VEC
  // elements: E % 4 == 0 and both first rows aligned.
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(dlogits) % (4 * sizeof(T)) == 0;
  if (vec && E <= 128) return launch<T, 4, 1>(logits, ids, dg, dlogits, rows, E, k, stream);
  if (vec && E <= 256) return launch<T, 4, 2>(logits, ids, dg, dlogits, rows, E, k, stream);
  if (E <= 32) return launch<T, 1, 1>(logits, ids, dg, dlogits, rows, E, k, stream);
  if (E <= 64) return launch<T, 1, 2>(logits, ids, dg, dlogits, rows, E, k, stream);
  if (E <= 128) return launch<T, 1, 4>(logits, ids, dg, dlogits, rows, E, k, stream);
  if (E <= 256) return launch<T, 1, 8>(logits, ids, dg, dlogits, rows, E, k, stream);
  return cudaErrorInvalidValue;
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
  if (rows <= 0 || E <= 0 || E > 256 || k <= 0 || k > E || k > 32) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_e<float>(logits, ids, dg, dlogits, rows, E, k, s);
  if (dtype == kBFloat16) return dispatch_e<__nv_bfloat16>(logits, ids, dg, dlogits, rows, E, k, s);
  return cudaErrorInvalidValue;
}
