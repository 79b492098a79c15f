// Helpers shared by the port's CUDA kernels: float32 <-> storage-type
// conversion (float32 and bfloat16), written with the conversion intrinsics
// so that the sources also build under PyTorch's no-implicit-conversion flags.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Storage types a kernel takes; the numbers are the `dtype` argument of the
// C entry points.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A score that no key may take: the fill value of masked positions, as in
// the reference kernels (finite, so that exp(m_prev - m_new) never sees inf - inf).
constexpr float kNegInf = -1e30f;

// An int32 that orders floats as their values do (-inf < -1 < -0 < +0 <
// the smallest subnormal < 1 < +inf), and its inverse: a warp's float
// maximum is one `redux.sync` of the keys (sm_80 and later).  A
// non-negative float's bits already order as signed ints; a negative one's
// magnitude bits are flipped so that a larger magnitude gives a smaller key.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// VEC adjacent values from `src` (aligned to VEC elements) into `dst` as
// float32: one 16-byte load of float32, 8 bytes of bf16, or one element.
template <int VEC>
__device__ __forceinline__ void load_chunk(const float* src, float* dst) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    dst[0] = *src;
  }
}
template <int VEC>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* src, float* dst) {
  if constexpr (VEC == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    dst[0] = a.x, dst[1] = a.y, dst[2] = b.x, dst[3] = b.y;
  } else {
    dst[0] = to_float(*src);
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_shared_bytes(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
