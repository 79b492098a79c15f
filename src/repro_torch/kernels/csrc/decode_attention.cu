// Decode attention for Hopper (sm_90a): one query token per row against a
// KV cache, grouped-query heads sharing their KV head's cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention_pallas (body `_kernel`).  That kernel carried the
// online-softmax state (m, l, acc) from one cache block to the next along a
// sequential grid axis.  Blocks on Hopper run in no order, so here one block
// owns a (batch row, KV head) pair, its eight warps walk the cache in
// interleaved 32-key tiles, each with its own online-softmax state, and the
// eight partial states are merged in shared memory at the end.
//
// What bounds it on the H100: bytes.  Each cache element is read once and
// feeds 2·g flops (g = query heads per KV head; g = 1 for orloj_gpt), far
// below the ~20 float32 flops per byte at which the card stops waiting on
// memory.  What the design does about it: every K/V element is read from
// device memory exactly once, with 16-byte loads for K and whole 128-byte
// rows per warp for V; no barrier sits inside the walk, so the eight warps'
// loads overlap; one lane owns one key, so a tile's scores take one pass
// and two warp reductions; and the walk stops at valid_len[b], so cache
// slots that were never written are never read.  The ragged tail of S is
// masked in the kernel, so any cache length is served.  Left for later:
// cp.async/TMA prefetch of the next tile, and a split of S across blocks
// (flash-decoding) for batches whose B·KV blocks cannot fill 132 SMs.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// G query heads of the group are handled per pass over the cache (G divides
// the group size; the host picks 4, 2 or 1).
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q,        // (B, H, HD)
                            const T* __restrict__ k_cache,  // (B, KV, S, HD)
                            const T* __restrict__ v_cache,  // (B, KV, S, HD)
                            const int* __restrict__ valid_len,  // (B,)
                            T* __restrict__ out,            // (B, H, HD)
                            int H, int KV, int S, float sm_scale) {
  constexpr int DPL = HD / 32;  // output dims each lane owns: lane*DPL ...
  __shared__ float q_s[G][HD];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][HD];

  const int g = H / KV;
  const int c = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // batch row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = min(max(valid_len[b], 0), S);
  const size_t kv_base = (static_cast<size_t>(b) * KV + c) * static_cast<size_t>(S) * HD;
  const T* kb = k_cache + kv_base;
  const T* vb = v_cache + kv_base;

  for (int j0 = 0; j0 < g; j0 += G) {
    const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(c) * g + j0) * HD;
    __syncthreads();  // the previous pass is done with q_s and acc_s
    for (int i = threadIdx.x; i < G * HD; i += kThreads) q_s[i / HD][i % HD] = to_float(q[q_base + i]);
    __syncthreads();

    float m[G], l[G], acc[G][DPL];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[j][e] = 0.f;
    }

    for (int t0 = warp * 32; t0 < n; t0 += kWarps * 32) {
      const int nt = min(32, n - t0);
      // This lane's key: its scores against every query head of the pass.
      float s[G];
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = 0.f;
      if (lane < nt) {
        const T* kr = kb + static_cast<size_t>(t0 + lane) * HD;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 kx = load4(kr + d);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            s[j] = fmaf(q_s[j][d], kx.x, s[j]);
            s[j] = fmaf(q_s[j][d + 1], kx.y, s[j]);
            s[j] = fmaf(q_s[j][d + 2], kx.z, s[j]);
            s[j] = fmaf(q_s[j][d + 3], kx.w, s[j]);
          }
        }
      }
      float p[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float sj = lane < nt ? s[j] * sm_scale : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(sj));
        p[j] = lane < nt ? expf(sj - m_new) : 0.f;
        const float alpha = expf(m[j] - m_new);
        l[j] = alpha * l[j] + warp_sum(p[j]);
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[j][e] *= alpha;
      }
      // acc += p·V: key u's probabilities come from lane u; the warp reads
      // V row u whole, each lane its DPL dims.
      for (int u = 0; u < nt; ++u) {
        const T* vr = vb + static_cast<size_t>(t0 + u) * HD + lane * DPL;
        float vx[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vx[e] = to_float(vr[e]);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float pu = __shfl_sync(0xffffffffu, p[j], u);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[j][e] = fmaf(pu, vx[e], acc[j][e]);
        }
      }
    }

    // Merge the warps' partial states.  A warp that saw no key has m = -1e30
    // and l = acc = 0, so it adds nothing; valid_len == 0 leaves every row 0.
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (lane == 0) {
        m_s[warp][j] = m[j];
        l_s[warp][j] = l[j];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc_s[warp][j][lane * DPL + e] = acc[j][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * HD; i += kThreads) {
      const int j = i / HD;
      const int d = i % HD;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][j]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_s[w][j] - mx);
        num = fmaf(f, acc_s[w][j][d], num);
        den = fmaf(f, l_s[w][j], den);
      }
      out[q_base + i] = from_float<T>(num / fmaxf(den, 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid_len, void* out,
                   int B, int H, int KV, int S, cudaStream_t stream) {
  const dim3 grid(KV, B);
  const int g = H / KV;
  const float scale = 1.f / std::sqrt(static_cast<float>(HD));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (g % 4 == 0)
    decode_attention_kernel<T, HD, 4><<<grid, kThreads, 0, stream>>>(qt, kt, vt, valid_len, ot, H,
                                                                      KV, S, scale);
  else if (g % 2 == 0)
    decode_attention_kernel<T, HD, 2><<<grid, kThreads, 0, stream>>>(qt, kt, vt, valid_len, ot, H,
                                                                      KV, S, scale);
  else
    decode_attention_kernel<T, HD, 1><<<grid, kThreads, 0, stream>>>(qt, kt, vt, valid_len, ot, H,
                                                                      KV, S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* valid_len,
                        void* out, int B, int H, int KV, int S, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, valid_len, out, B, H, KV, S, stream);
    case 64:
      return launch<T, 64>(q, k, v, valid_len, out, B, H, KV, S, stream);
    case 128:
      return launch<T, 128>(q, k, v, valid_len, out, B, H, KV, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, hd); k_cache, v_cache: (B, KV, S, hd), all contiguous, of the
// storage type `dtype`; valid_len: (B,) int32; out: (B, H, hd).  hd must be
// 32, 64 or 128.  Launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const int* valid_len, void* out, int dtype, int B, int H,
                                       int KV, int S, int hd, void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k_cache, v_cache, valid_len, out, B, H, KV, S, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, valid_len, out, B, H, KV, S, s);
  return cudaErrorInvalidValue;
}
