// MoE top-k gating for Hopper (sm_90a): softmax over the E experts of each
// row in float32, then the top k by k passes of argmax (a tie goes to the
// lowest index), with the k gates renormalised over their sum.
//
// Replaces the TPU kernel src/repro/kernels/moe_gating.py, function
// moe_gating_pallas (body `_kernel`).  That kernel took tiles of 256 rows
// into VMEM and needed T % block_rows == 0.  Here one warp owns one row and
// each lane holds ceil(E/32) logits in registers (lane l holds experts l,
// l + 32, ...), so any T is served and nothing is padded.  The arithmetic is
// the Pallas body's, step by step, because the expert ids must equal the
// reference's: the probabilities are divided out before any selection
// (expf, not the fast __expf), a pass picks the largest (value, -index)
// pair with a warp shuffle reduction, sets the chosen entry to -1 and adds
// its value to the gate sum in pass order, and the gates are divided by
// max(sum, 1e-9).  Lane t keeps pass t's gate and id and writes them, so k
// may be up to 32.
//
// What bounds it on the H100: bytes, in principle (each logit is read once
// and the (T, k) gates and ids are written once, ~10 flops per logit); at
// the serving path's (2048, 128) that is 1.1 MB, a third of a microsecond
// at 3.35 TB/s, so in practice the launch itself.  What the design does
// about it: one pass over the logits with coalesced loads, everything else
// in registers and shuffles, no shared memory and no barrier.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;

// EPL: logits per lane (E <= 32·EPL).
template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads)
    moe_gating_kernel(const T* __restrict__ logits,  // (rows, E)
                      float* __restrict__ gates,     // (rows, k)
                      int* __restrict__ ids,         // (rows, k)
                      int rows, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = logits + static_cast<size_t>(row) * E;

  float p[EPL];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? to_float(xr[e]) : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    p[j] = lane + 32 * j < E ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    // Slots past E take -inf: below the -1 of a chosen entry, never picked.
    p[j] = lane + 32 * j < E ? p[j] / sum : -INFINITY;
  }

  float gsum = 0.f, my_gate = 0.f;
  int my_id = 0;
  for (int t = 0; t < k; ++t) {
    // This lane's best: its entries are in increasing index order, so a
    // strict > keeps the lowest index of a tie.
    float bv = p[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < EPL; ++j) {
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    gsum += bv;
    if (lane == t) {
      my_gate = bv;
      my_id = bi;
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (lane + 32 * j == bi) p[j] = -1.f;
    }
  }
  if (lane < k) {
    const size_t o = static_cast<size_t>(row) * k + lane;
    gates[o] = my_gate / fmaxf(gsum, 1e-9f);
    ids[o] = my_id;
  }
}

template <typename T, int EPL>
cudaError_t launch(const void* logits, float* gates, int* ids, int rows, int E, int k,
                   cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  moe_gating_kernel<T, EPL><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(logits), gates,
                                                             ids, rows, E, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_e(const void* logits, float* gates, int* ids, int rows, int E, int k,
                       cudaStream_t stream) {
  if (E <= 32) return launch<T, 1>(logits, gates, ids, rows, E, k, stream);
  if (E <= 64) return launch<T, 2>(logits, gates, ids, rows, E, k, stream);
  if (E <= 128) return launch<T, 4>(logits, gates, ids, rows, E, k, stream);
  if (E <= 256) return launch<T, 8>(logits, gates, ids, rows, E, k, stream);
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
