// Primitives shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): 16-byte cp.async copies into shared
// memory, the split-TF32 products that run float32 on the tensor cores, and
// the bfloat16 product, each a single mma.sync of sm_80 and later.  The
// split itself (split_tf32, split4) is also the float32 GEMM's (gemm.cu).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro_torch {

// ------------------------------------------------------------ copies
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
// One 4-byte word, zero-filled where `in` is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows) of a (S, HD) slab with row stride `stride`
// into shared rows of length `ld`; rows at or past S are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long stride, int row0,
                                          int rows, int S, int tid, int nthreads) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements per cp.async
  constexpr int kChunksPerRow = HD / kChunk;
  for (int i = tid; i < rows * kChunksPerRow; i += nthreads) {
    const int r = i / kChunksPerRow;
    const int c = (i - r * kChunksPerRow) * kChunk;
    const bool in = row0 + r < S;
    cp_async16(dst + r * ld + c, in ? src + (row0 + r) * stride + c : src, in);
  }
}

// ------------------------------------------------------------ products
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties away
// from zero, 10 mantissa bits kept.  On sm_90 that instruction expands to a
// sequence that also screens NaN and infinity, several instructions a value;
// the operands here are finite, and adding half a TF32 unit to the bits and
// clearing the 13 low ones gives the same result in two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = big + small, both TF32; big·big + big·small + small·big is x·y to ~2^-22.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}
// The split of four float32 values at `src` (16 bytes) into big (written to
// `big`) and small (to `small`); the three may alias.
__device__ __forceinline__ void split4(const uint8_t* src, uint8_t* big, uint8_t* small) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  uint4 b, s;
  split_tf32(x.x, b.x, s.x);
  split_tf32(x.y, b.y, s.y);
  split_tf32(x.z, b.z, s.z);
  split_tf32(x.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(small) = s;
}

// d += a·b, m16n8k8, TF32 inputs, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A float32 fragment split once into its TF32 parts, reused by every
// product it enters.
template <int N>
struct SplitFrag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ explicit SplitFrag(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
  }
};

// The same split by truncation (the flash backward's): big = x with its 13
// low bits cleared and small = x - big, whose own low bits are left.  The
// tensor cores read the 19 high bits of a TF32 operand, so each value costs
// two instructions where split_tf32 costs five; the parts dropped are below
// 2^-20 of x, as small·small is.  CUTLASS's FastF32 truncates its big part
// too (NumericConverter<tfloat32_t, float, round_toward_zero>).
template <int N>
struct TruncSplitFrag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ explicit TruncSplitFrag(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      big[i] = __float_as_uint(x[i]) & 0xFFFFE000u;
      small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
    }
  }
};

// The three passes of a split-TF32 product: d += a·b to float32 accuracy,
// with either split (F: SplitFrag or TruncSplitFrag).
template <template <int> class F>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const F<4>& a, const F<2>& b) {
  mma_tf32(d, a.small[0], a.small[1], a.small[2], a.small[3], b.big[0], b.big[1]);
  mma_tf32(d, a.big[0], a.big[1], a.big[2], a.big[3], b.small[0], b.small[1]);
  mma_tf32(d, a.big[0], a.big[1], a.big[2], a.big[3], b.big[0], b.big[1]);
}

// The same three passes into three accumulators, summed by the caller: the
// three mma of a pass do not wait on each other, where one accumulator
// would chain them.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&mixed)[4], float (&other)[4],
                                           const SplitFrag<4>& a, const SplitFrag<2>& b) {
  mma_tf32(other, a.small[0], a.small[1], a.small[2], a.small[3], b.big[0], b.big[1]);
  mma_tf32(mixed, a.big[0], a.big[1], a.big[2], a.big[3], b.small[0], b.small[1]);
  mma_tf32(big, a.big[0], a.big[1], a.big[2], a.big[3], b.big[0], b.big[1]);
}

// d += a·b, m16n8k16, bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace repro_torch
