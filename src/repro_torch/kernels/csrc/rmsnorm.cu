// RMSNorm for Hopper (sm_90a): y = x·rsqrt(mean(x²) + eps)·scale per row,
// summed in float32, written in x's storage type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py, function
// rmsnorm_pallas (body `_kernel`).  That kernel took tiles of 256 rows into
// VMEM and needed T % block_rows == 0.  Here one block owns one row, so any
// T is served and nothing is padded.  A block has one thread per 4 elements
// of the row (per element without 4-wide loads), rounded up to whole warps
// and capped at 256 threads, which then stride over a wider row.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once and takes ~4 flops, far below the ~20 float32 flops per byte at
// which the card stops waiting on memory.  What the design does about it:
// rows are read with 16-byte loads (8-byte loads for bfloat16) where d is a
// multiple of 4 and the pointers are aligned, and with scalar loads
// otherwise; the sum of squares is reduced with warp shuffles and then
// across warps in shared memory, and the row is read a second time for the
// output.  The second read is served by L1/L2 (a 7168-wide float32 row is
// 28 KB), so device memory sees each element about once.  Left for later:
// keep the row in registers between the two passes, and several rows per
// block for small d.

#include <algorithm>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 256;

struct alignas(16) Vec4 {
  float v[4];
};

__device__ __forceinline__ Vec4 load_vec(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {{a.x, a.y, a.z, a.w}};
}
__device__ __forceinline__ Vec4 load_vec(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return {{lo.x, lo.y, hi.x, hi.y}};
}
__device__ __forceinline__ void store_vec(float* p, const Vec4& y) {
  *reinterpret_cast<float4*>(p) = make_float4(y.v[0], y.v[1], y.v[2], y.v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const Vec4& y) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y.v[0], y.v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y.v[2], y.v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Sum of `x` over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    float s = lane < n_warps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

// One block per row; VEC = 4 reads and writes four elements at a time.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x,          // (rows, d)
                   const float* __restrict__ scale,  // (d,)
                   T* __restrict__ out,              // (rows, d)
                   int d, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* orow = out + base;
  float ss = 0.f;
  if (VEC) {
    for (int i = threadIdx.x * 4; i < d; i += blockDim.x * 4) {
      const Vec4 a = load_vec(xr + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) ss = fmaf(a.v[e], a.v[e], ss);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float a = to_float(xr[i]);
      ss = fmaf(a, a, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
  if (VEC) {
    for (int i = threadIdx.x * 4; i < d; i += blockDim.x * 4) {
      const Vec4 a = load_vec(xr + i);
      const float4 s = *reinterpret_cast<const float4*>(scale + i);
      const Vec4 y = {{a.v[0] * r * s.x, a.v[1] * r * s.y, a.v[2] * r * s.z, a.v[3] * r * s.w}};
      store_vec(orow + i, y);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      orow[i] = from_float<T>(to_float(xr[i]) * r * scale[i]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* out, int rows, int d, int vec,
                   float eps, cudaStream_t stream) {
  // Enough warps that each thread holds a vector (or element) of the row,
  // at most kMaxThreads.
  const int per_thread = vec ? 4 : 1;
  const int want = (d + per_thread - 1) / per_thread;
  const int threads = std::min(kMaxThreads, std::max(32, (want + 31) / 32 * 32));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    rmsnorm_kernel<T, true><<<rows, threads, 0, stream>>>(xt, scale, ot, d, eps);
  else
    rmsnorm_kernel<T, false><<<rows, threads, 0, stream>>>(xt, scale, ot, d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x: (rows, d), contiguous, of the storage type `dtype`; scale: (d,)
// float32; out: (rows, d) like x.  vec = 1 asks for 4-wide loads: d must be a
// multiple of 4 and x, scale and out aligned to 4 elements (the wrapper
// decides).  Launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).
extern "C" int rmsnorm_launch(const void* x, const float* scale, void* out, int dtype, int rows,
                              int d, int vec, float eps, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || (vec && d % 4 != 0)) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return launch<float>(x, scale, out, rows, d, vec, eps, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, scale, out, rows, d, vec, eps, s);
  return cudaErrorInvalidValue;
}
