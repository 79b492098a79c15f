// MoE top-k gating for Hopper (sm_90a): softmax over the E experts of each
// row in float32, then the top k by k passes of argmax (a tie goes to the
// lowest index), with the k gates renormalised over their sum.
//
// Replaces the TPU kernel src/repro/kernels/moe_gating.py, function
// moe_gating_pallas (body `_kernel`).  That kernel took tiles of 256 rows
// into VMEM and needed T % block_rows == 0.  Here one warp owns one row and
// holds its logits in registers, so any T is served and nothing is padded.
// The arithmetic is the Pallas body's, step by step, because the expert ids
// must equal the reference's: the probabilities are divided out before any
// selection (expf, not the fast __expf), a pass picks the largest
// probability and, among equal ones, the lowest index, sets the chosen
// entry to -1 and adds its value to the gate sum in pass order, and the
// gates are divided by max(sum, 1e-9).  Lane t keeps pass t's gate and id
// and writes them, so k may be up to 32.
//
// What bounds it on the H100: bytes, in principle (each logit is read once
// and the (T, k) gates and ids are written once, ~5 flops per logit): at
// the serving path's (2048, 128) k 2 that is 1.08 MB, 0.32 us at 3.35
// TB/s.  In fact, measured (PERF.md, scripts/gating_variants.py): the
// launch, and one chain of dependent steps per row.  One block (T = 8)
// runs 1.76 us against 2.21 us at T = 2048; a kernel that does nothing
// runs 0.83 us, one that makes only these loads and stores 1.11 us, so
// the chain is the ~0.65 us above that, and at T = 2048 a scheduler holds
// only ~4 warps to hide it behind.  What the design does about it:
// - the chain is short.  Every selection is two `redux.sync` (sm_80 and
//   later) on an integer key that orders floats as their values do: the
//   maximum of the keys, then the minimum of the index over the lanes that
//   hold it.  The logit maximum is one `redux.sync` of the same key (exact:
//   the maximum is one of the inputs).  Only the sum is a shuffle
//   butterfly (there is no float `redux`).  Ties resolve by the index
//   reduction, not by where the experts lie, so the layout is free;
// - where E % 4 == 0 and the rows are aligned, lane l holds experts
//   4l .. 4l+3 of each 128 (one 16-byte float4 load, or 8 bytes of bf16, a
//   chunk); other E take the scalar layout, lane l holding l, l + 32, ...;
// - kWarps = 4 rows a block spreads the small batches of the serve path
//   (T = 32 .. 256) over twice the SMs that 8 did; of 2, 4 and 8 it had
//   the least own duration summed over T = 32, 256 and 2048 (PERF.md).
// No shared memory and no barrier.  The chain is now 5 shuffles and
// 1 + 2k `redux.sync` (the shuffle-argmax design before it: 10 + 10k
// shuffles), 0.19 us less at one block; what is left is the launch, the
// memory round trip, expf and the IEEE divisions the reference's
// arithmetic asks for.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

#ifndef MOE_GATING_WARPS
#define MOE_GATING_WARPS 4  // rows per block; -D overrides it only to measure others
#endif

namespace repro_torch {
namespace {

constexpr int kWarps = MOE_GATING_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// An int32 that orders floats as their values do (-inf < -1 < -0 < +0 <
// the smallest subnormal < 1 < +inf), and its inverse.  A non-negative
// float's bits already order as signed ints; a negative one's magnitude
// bits are flipped so that a larger magnitude gives a smaller key.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// VEC adjacent logits from `src` (aligned to VEC elements) into `dst`.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    dst[0] = *src;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  if constexpr (VEC == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    dst[0] = a.x, dst[1] = a.y, dst[2] = b.x, dst[3] = b.y;
  } else {
    dst[0] = to_float(*src);
  }
}

// VEC: adjacent logits a lane loads at once (4 or 1); CHUNKS: loads a lane
// makes.  Slot j of lane l holds expert 32·VEC·(j / VEC) + VEC·l + j % VEC,
// so a lane's slots run in increasing expert order.  E <= 32·VEC·CHUNKS.
template <typename T, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
    moe_gating_kernel(const T* __restrict__ logits,  // (rows, E)
                      float* __restrict__ gates,     // (rows, k)
                      int* __restrict__ ids,         // (rows, k)
                      int rows, int E, int k) {
  constexpr int EPL = VEC * CHUNKS;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = logits + static_cast<size_t>(row) * E;

  int expert[EPL];
  float p[EPL];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e0 = 32 * VEC * c + VEC * lane;
#pragma unroll
    for (int v = 0; v < VEC; ++v) expert[VEC * c + v] = e0 + v;
    // E % VEC == 0, so a chunk lies wholly inside the row or wholly past it.
    if (e0 < E) {
      load_vec<VEC>(xr + e0, p + VEC * c);
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    // Slots past E take -inf: below the -1 of a chosen entry, never picked.
    p[j] = expert[j] < E ? p[j] / sum : -INFINITY;
  }

  float gsum = 0.f, my_gate = 0.f;
  int my_id = 0;
  for (int t = 0; t < k; ++t) {
    // This lane's best: its slots are in increasing expert order, so a
    // strict > keeps the lowest index of a tie.
    float bv = p[0];
    int bi = expert[0];
#pragma unroll
    for (int j = 1; j < EPL; ++j) {
      if (p[j] > bv) {
        bv = p[j];
        bi = expert[j];
      }
    }
    const int top = __reduce_max_sync(kFull, order_key(bv));
    const int id = __reduce_min_sync(kFull, order_key(bv) == top ? bi : 0x7fffffff);
    const float val = key_value(top);
    gsum += val;
    if (lane == t) {
      my_gate = val;
      my_id = id;
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (expert[j] == id) p[j] = -1.f;
    }
  }
  if (lane < k) {
    const size_t o = static_cast<size_t>(row) * k + lane;
    gates[o] = my_gate / fmaxf(gsum, 1e-9f);
    ids[o] = my_id;
  }
}

template <typename T, int VEC, int CHUNKS>
cudaError_t launch(const void* logits, float* gates, int* ids, int rows, int E, int k,
                   cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  moe_gating_kernel<T, VEC, CHUNKS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), gates, ids, rows, E, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_e(const void* logits, float* gates, int* ids, int rows, int E, int k,
                       cudaStream_t stream) {
  // Vector loads need every row's start aligned to VEC elements: E % 4 == 0
  // and the first row aligned.
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % (4 * sizeof(T)) == 0;
  if (vec && E <= 128) return launch<T, 4, 1>(logits, gates, ids, rows, E, k, stream);
  if (vec && E <= 256) return launch<T, 4, 2>(logits, gates, ids, rows, E, k, stream);
  if (E <= 32) return launch<T, 1, 1>(logits, gates, ids, rows, E, k, stream);
  if (E <= 64) return launch<T, 1, 2>(logits, gates, ids, rows, E, k, stream);
  if (E <= 128) return launch<T, 1, 4>(logits, gates, ids, rows, E, k, stream);
  if (E <= 256) return launch<T, 1, 8>(logits, gates, ids, rows, E, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// logits: (rows, E), contiguous, of the storage type `dtype`; gates: (rows,
// k) float32; ids: (rows, k) int32.  1 <= k <= min(E, 32) and E <= 256.
// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).
extern "C" int moe_gating_launch(const void* logits, float* gates, int* ids, int dtype, int rows,
                                 int E, int k, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || E <= 0 || k <= 0 || k > E || k > 32) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return dispatch_e<float>(logits, gates, ids, rows, E, k, s);
  if (dtype == kBFloat16) return dispatch_e<__nv_bfloat16>(logits, gates, ids, rows, E, k, s);
  return cudaErrorInvalidValue;
}
