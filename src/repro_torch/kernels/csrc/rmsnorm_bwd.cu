// RMSNorm backward for Hopper (sm_90a): the gradients of rmsnorm.cu's
// y = x·r·scale, r = rsqrt(mean(x²) + eps), per row of x:
//
//   dx = r·(dy·scale − x̂·mean(dy·scale·x̂)),  x̂ = x·r
//   dscale = Σ_rows dy·x̂
//
// The TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm_pallas) has no
// backward; the port's model calls the forward kernel, so training on the
// card needs this one.
//
// What bounds it on the H100: bytes (x and dy read, dx written, a few flops
// an element).  The first launch gives each block a strided share of the
// rows: per row one pass sums x² and dy·scale·x in float32 (one block
// reduction of both), a second pass writes dx and adds dy·x̂ into the
// block's float32 partial of dscale, which lives in shared memory (each
// column owned by one thread, no barrier) and is written out once.  The
// second launch adds the blocks' partials column by column.  No atomics:
// dscale is the same from run to run.  The row's second read is served by
// L1/L2, as in the forward.

#include <algorithm>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two a SM: the partials stay small

__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    s.x += warp_sums[w].x;
    s.y += warp_sums[w].y;
  }
  __syncthreads();  // warp_sums is free for the next row
  return s;
}

// Blocks take rows blockIdx.x, blockIdx.x + gridDim.x, ...; thread t owns
// columns t, t + kThreads, ... of the row and of the block's dscale partial.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial,  // (gridDim.x, d)
                       int rows, int d, float eps) {
  extern __shared__ float dscale_s[];  // [d]
  for (int c = threadIdx.x; c < d; c += kThreads) dscale_s[c] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, dot = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float a = to_float(x[base + c]);
      ss = fmaf(a, a, ss);
      dot = fmaf(to_float(dy[base + c]) * scale[c], a, dot);
    }
    const float2 s = block_sum2(ss, dot);
    const float r = rsqrtf(s.x / static_cast<float>(d) + eps);
    // mean(dy·scale·x̂) = r·mean(dy·scale·x)
    const float m = r * s.y / static_cast<float>(d);
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xh = to_float(x[base + c]) * r;
      const float g = to_float(dy[base + c]);
      dx[base + c] = from_float<T>(r * (g * scale[c] - xh * m));
      dscale_s[c] = fmaf(g, xh, dscale_s[c]);
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads)
    partial[static_cast<size_t>(blockIdx.x) * d + c] = dscale_s[c];
}

// dscale[c] = Σ_b partial[b][c], in block order.
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                              int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * d + c];
  dscale[c] = s;
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const void* dy, void* dx, float* partial,
                   float* dscale, int rows, int d, int blocks, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = allow_shared_bytes(rmsnorm_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
      rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dscale, blocks, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// The number of blocks (and rows of the partial buffer) a launch over
// `rows` rows uses: the caller allocates a (blocks, d) float32 partial.
extern "C" int rmsnorm_bwd_blocks(int rows) {
  return std::max(1, std::min(rows, repro_torch::kMaxBlocks));
}

// x, dy, dx: (rows, d), contiguous, of the storage type `dtype`; scale,
// dscale: (d,) float32; partial: (rmsnorm_bwd_blocks(rows), d) float32
// scratch.  d * 4 bytes must fit a block's shared memory (d <= 56832).
// Launches two kernels on `stream` and returns the first launch error (0
// when both were accepted).
extern "C" int rmsnorm_bwd_launch(const void* x, const float* scale, const void* dy, void* dx,
                                  float* partial, float* dscale, int dtype, int rows, int d,
                                  float eps, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const int blocks = rmsnorm_bwd_blocks(rows);
  if (dtype == kFloat32)
    return launch<float>(x, scale, dy, dx, partial, dscale, rows, d, blocks, eps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, scale, dy, dx, partial, dscale, rows, d, blocks, eps, s);
  return cudaErrorInvalidValue;
}
