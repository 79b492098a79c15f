// Flash attention backward for Hopper (sm_90a): the gradients of q, k and v
// of flash_attention.cu's forward, from the forward's output O, its per-row
// log-sum-exp L and the output's gradient dO.
//
// The TPU kernel src/repro/kernels/flash_attention.py (flash_attention_pallas)
// has no backward: the JAX trainer differentiates einsums.  The port's
// model calls the forward kernel, so training on the card needs this one.
// It follows FlashAttention-2's structure, with the forward's masks:
//
//   P = exp(T - L),  T = cap·tanh(s·x / cap) (or s·x), x = q·k, s = hd^-1/2
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dT = P∘(dP − D),  D = rowsum(dO∘O)
//   dX = dT·dT/dx (s, or s·(1 − tanh²) with a softcap),  dQ = dX·K,  dK = dXᵀ·Q
//
// in two launches: one over query tiles, which also writes D for the second,
// writes dQ; one over key tiles of a KV head writes dK and dV, summing over
// the query heads of its GQA group and every query tile inside the block.
// No atomics: each gradient element is written once, by one thread, so the
// gradients are the same from run to run.  The masks (keys at or past
// lengths[b], causal, sliding window, the ragged tail of S) are tested per
// (query, key) pair exactly as the forward tests them; tiles that no pair of
// a block can reach are skipped as the forward skips them.  A row with no
// valid key (L = -inf) gives P = 0 and zero gradients.
//
// What bounds it on the H100: operations (five products of hd per pair:
// the recomputed q·k, dO·v, and the three gradient products).  This first
// version runs them on the SIMT cores in float32, a tile of 32 queries by
// 32 keys a step, each thread holding 8 score entries and a quarter of
// a row's hd-wide accumulators in registers, reading its operands from
// shared memory as 16-byte vectors.  bfloat16 inputs are widened to float32
// in shared memory; P is rounded to bf16 before dV as the forward rounds it
// before P·V.  Left for later: the products on the tensor cores (mma.sync or
// wgmma, as the forward), and more blocks for a small B·KV in the dK/dV
// launch (a GQA group is one block's loop).

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 32;  // query rows a tile
constexpr int kBK = 32;  // keys a tile
constexpr int kThreads = 128;
constexpr int kPs = kBK + 1;  // row length of the score tiles in shared memory
template <int HD>
constexpr int kLd = HD + 4;  // row length of the operand tiles: 16-byte rows, no conflicts

struct Shape {
  const int* lengths;  // (B,) or null: every row has S keys
  int B, H, KV, S, causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows [row0, row0 + kRows) of a contiguous (S, HD) slab, widened to float32
// into shared rows of length kLd<HD>; rows at or past S are zeros.
template <typename T, int HD, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S) {
  constexpr int kVecs = HD / 4;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    const float4 x = row0 + r < S ? load4(src + static_cast<size_t>(row0 + r) * HD + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * kLd<HD> + c) = x;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ int valid_keys(const Shape& sh, int b) {
  return sh.lengths != nullptr ? min(sh.S, max(sh.lengths[b], 0)) : sh.S;
}

// The forward's mask for one (query, key) pair.
__device__ __forceinline__ bool visible(const Shape& sh, int n_keys, int row, int key) {
  bool ok = row < sh.S && key < n_keys;
  if (sh.causal) ok = ok && key <= row;
  if (sh.window > 0) ok = ok && key > row - sh.window;
  return ok;
}

// P and dX of one pair from its two dot products x = q·k and dp = dO·v.
__device__ __forceinline__ void pair_grads(const Shape& sh, bool ok, float x, float dp, float lse,
                                           float D, float& p, float& dx) {
  float t, dtdx;
  if (sh.softcap > 0.f) {
    const float th = tanhf(x * sh.scale / sh.softcap);
    t = th * sh.softcap;
    dtdx = sh.scale * (1.f - th * th);
  } else {
    t = x * sh.scale;
    dtdx = sh.scale;
  }
  p = ok && lse != -INFINITY ? expf(t - lse) : 0.f;
  dx = p * (dp - D) * dtdx;
}

// ------------------------------------------------------------------ dQ
// One block per (head, batch row, query tile of kBQ rows).  Writes D for
// its rows, then walks the key tiles its rows can see.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ D_out, T* __restrict__ dq, Shape sh) {
  constexpr int LD = kLd<HD>;
  constexpr int NV = HD / 16;  // 4-wide vectors of a thread's accumulator row
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;                  // [kBQ][LD]
  float* k_s = do_s + kBQ * LD;                  // [kBK][LD]
  float* v_s = k_s + kBK * LD;                   // [kBK][LD]
  float* ds_s = v_s + kBK * LD;                  // [kBQ][kPs]
  float* lse_s = ds_s + kBQ * kPs;               // [kBQ]
  float* d_s = lse_s + kBQ;                      // [kBQ]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = blockIdx.z * kBQ;
  const int kvh = h / (sh.H / sh.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qrow = (static_cast<size_t>(b) * sh.H + h) * sh.S;
  const size_t krow = (static_cast<size_t>(b) * sh.KV + kvh) * sh.S;

  load_tile<T, HD, kBQ>(q_s, q + qrow * HD, q0, sh.S);
  load_tile<T, HD, kBQ>(do_s, dout + qrow * HD, q0, sh.S);
  __syncthreads();
  // D = rowsum(dO∘O), a warp a row.
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.S) {
      const T* orow = o + (qrow + row) * HD;
      for (int c = lane; c < HD; c += 32) acc = fmaf(do_s[r * LD + c], to_float(orow[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = row < sh.S ? lse[qrow + row] : -INFINITY;
      if (row < sh.S) D_out[qrow + row] = acc;
    }
  }

  // The keys these rows can see, as the forward's query tile bounds them.
  const int n_keys = valid_keys(sh, b);
  int k_end = n_keys;
  if (sh.causal) k_end = min(k_end, min(q0 + kBQ, sh.S));
  const int k_begin = sh.window > 0 ? max(0, q0 - sh.window + 1) / kBK * kBK : 0;

  // Scores: row i = tid / 4 against keys jr = tid % 4 + 4r.  Accumulators:
  // row i, dims 16m + 4·(tid % 4) .. +3.
  const int i = tid >> 2, jq = tid & 3;
  float acc[NV][4];
#pragma unroll
  for (int m = 0; m < NV; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and D, lse are written)
    load_tile<T, HD, kBK>(k_s, k + krow * HD, k0, sh.S);
    load_tile<T, HD, kBK>(v_s, v + krow * HD, k0, sh.S);
    __syncthreads();
    float x[8], dp[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = dp[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 qa = load4(q_s + i * LD + c);
      const float4 da = load4(do_s + i * LD + c);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = jq + 4 * r;
        x[r] = dot4(qa, load4(k_s + j * LD + c), x[r]);
        dp[r] = dot4(da, load4(v_s + j * LD + c), dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = jq + 4 * r;
      float p, dx;
      pair_grads(sh, visible(sh, n_keys, q0 + i, k0 + j), x[r], dp[r], lse_s[i], d_s[i], p, dx);
      ds_s[i * kPs + j] = dx;
    }
    __syncthreads();
    // dQ += dX·K.
    for (int j = 0; j < kBK; ++j) {
      const float w = ds_s[i * kPs + j];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const float4 kv = load4(k_s + j * LD + 16 * m + 4 * jq);
        acc[m][0] = fmaf(w, kv.x, acc[m][0]);
        acc[m][1] = fmaf(w, kv.y, acc[m][1]);
        acc[m][2] = fmaf(w, kv.z, acc[m][2]);
        acc[m][3] = fmaf(w, kv.w, acc[m][3]);
      }
    }
  }
  if (q0 + i < sh.S) {
    T* out = dq + (qrow + q0 + i) * HD + 4 * jq;
#pragma unroll
    for (int m = 0; m < NV; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[16 * m + e] = from_float<T>(acc[m][e]);
  }
}

// ---------------------------------------------------------------- dK, dV
// One block per (KV head, batch row, key tile of kBK keys).  Walks the query
// heads of the group and, for each, the query tiles that can see its keys.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ D,
                          T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int LD = kLd<HD>;
  constexpr int NV = HD / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBK][LD]
  float* v_s = k_s + kBK * LD;                   // [kBK][LD]
  float* q_s = v_s + kBK * LD;                   // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;                  // [kBQ][LD]
  float* p_s = do_s + kBQ * LD;                  // [kBQ][kPs]
  float* ds_s = p_s + kBQ * kPs;                 // [kBQ][kPs]
  float* lse_s = ds_s + kBQ * kPs;               // [kBQ]
  float* d_s = lse_s + kBQ;                      // [kBQ]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int group = sh.H / sh.KV;
  const int tid = threadIdx.x;
  const size_t krow = (static_cast<size_t>(b) * sh.KV + kvh) * sh.S;
  // Scores: key j = tid / 4 against rows ir = tid % 4 + 4r.  Accumulators:
  // key j, dims 16m + 4·(tid % 4) .. +3.
  const int j = tid >> 2, iq = tid & 3;
  float dk_acc[NV][4], dv_acc[NV][4];
#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[m][e] = dv_acc[m][e] = 0.f;

  const int n_keys = valid_keys(sh, b);
  if (k0 < n_keys) {  // else no pair reaches these keys: zero gradients
    load_tile<T, HD, kBK>(k_s, k + krow * HD, k0, sh.S);
    load_tile<T, HD, kBK>(v_s, v + krow * HD, k0, sh.S);
    // The query tiles that can see a key of this tile.
    const int i_begin = sh.causal ? k0 / kBQ * kBQ : 0;
    const int i_end = sh.window > 0 ? min(sh.S, k0 + kBK - 1 + sh.window) : sh.S;
    for (int hh = kvh * group; hh < (kvh + 1) * group; ++hh) {
      const size_t qrow = (static_cast<size_t>(b) * sh.H + hh) * sh.S;
      for (int q0 = i_begin; q0 < i_end; q0 += kBQ) {
        __syncthreads();  // the previous tile is consumed
        load_tile<T, HD, kBQ>(q_s, q + qrow * HD, q0, sh.S);
        load_tile<T, HD, kBQ>(do_s, dout + qrow * HD, q0, sh.S);
        if (tid < kBQ) {
          const bool in = q0 + tid < sh.S;
          lse_s[tid] = in ? lse[qrow + q0 + tid] : -INFINITY;
          d_s[tid] = in ? D[qrow + q0 + tid] : 0.f;
        }
        __syncthreads();
        float x[8], dp[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) x[r] = dp[r] = 0.f;
#pragma unroll 4
        for (int c = 0; c < HD; c += 4) {
          const float4 ka = load4(k_s + j * LD + c);
          const float4 va = load4(v_s + j * LD + c);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int i = iq + 4 * r;
            x[r] = dot4(load4(q_s + i * LD + c), ka, x[r]);
            dp[r] = dot4(load4(do_s + i * LD + c), va, dp[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = iq + 4 * r;
          float p, dx;
          pair_grads(sh, visible(sh, n_keys, q0 + i, k0 + j), x[r], dp[r], lse_s[i], d_s[i], p, dx);
          // dV takes P as the forward's P·V took it: rounded to bf16 for bf16 inputs.
          if constexpr (kBF16) p = __bfloat162float(__float2bfloat16(p));
          p_s[i * kPs + j] = p;
          ds_s[i * kPs + j] = dx;
        }
        __syncthreads();
        // dV += Pᵀ·dO, dK += dXᵀ·Q.
        for (int i = 0; i < kBQ; ++i) {
          const float p = p_s[i * kPs + j], w = ds_s[i * kPs + j];
#pragma unroll
          for (int m = 0; m < NV; ++m) {
            const float4 g = load4(do_s + i * LD + 16 * m + 4 * iq);
            const float4 qa = load4(q_s + i * LD + 16 * m + 4 * iq);
            dv_acc[m][0] = fmaf(p, g.x, dv_acc[m][0]);
            dv_acc[m][1] = fmaf(p, g.y, dv_acc[m][1]);
            dv_acc[m][2] = fmaf(p, g.z, dv_acc[m][2]);
            dv_acc[m][3] = fmaf(p, g.w, dv_acc[m][3]);
            dk_acc[m][0] = fmaf(w, qa.x, dk_acc[m][0]);
            dk_acc[m][1] = fmaf(w, qa.y, dk_acc[m][1]);
            dk_acc[m][2] = fmaf(w, qa.z, dk_acc[m][2]);
            dk_acc[m][3] = fmaf(w, qa.w, dk_acc[m][3]);
          }
        }
      }
    }
  }
  if (k0 + j < sh.S) {
    const size_t off = (krow + k0 + j) * HD + 4 * iq;
#pragma unroll
    for (int m = 0; m < NV; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[off + 16 * m + e] = from_float<T>(dk_acc[m][e]);
        dv[off + 16 * m + e] = from_float<T>(dv_acc[m][e]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  Shape sh;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  constexpr int LD = kLd<HD>;
  const size_t dq_smem = (static_cast<size_t>(2 * kBQ + 2 * kBK) * LD + kBQ * kPs + 2 * kBQ) * 4;
  const size_t dkdv_smem =
      (static_cast<size_t>(2 * kBQ + 2 * kBK) * LD + 2 * kBQ * kPs + 2 * kBQ) * 4;
  cudaError_t err = allow_shared_bytes(flash_bwd_dq_kernel<T, HD>, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_shared_bytes(flash_bwd_dkdv_kernel<T, HD>, dkdv_smem);
  if (err != cudaSuccess) return err;
  const Shape& sh = a.sh;
  const dim3 dq_grid(sh.H, sh.B, (sh.S + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, HD><<<dq_grid, kThreads, dq_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.D,
      static_cast<T*>(a.dq), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid(sh.KV, sh.B, (sh.S + kBK - 1) / kBK);
  flash_bwd_dkdv_kernel<T, HD><<<dkdv_grid, kThreads, dkdv_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.D, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16:
      return launch<T, 16>(a);
    case 32:
      return launch<T, 32>(a);
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    case 192:
      return launch<T, 192>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q, o, dout, dq: (B, H, S, hd); k, v, dk, dv: (B, KV, S, hd); all contiguous,
// of the storage type `dtype`, every pointer on a 16-byte boundary.  lse:
// (B, H, S) float32, the forward's; D: (B, H, S) float32 scratch, written by
// the first launch and read by the second; lengths: (B,) int32 or null.
// hd must be 16, 32, 64, 128 or 192; causal, window and softcap as the
// forward took them.  Launches two kernels on `stream` and returns the first
// launch error (0 when both were accepted).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          const int* lengths, float* D, void* dq, void* dk,
                                          void* dv, int dtype, int B, int H, int KV, int S,
                                          int hd, int causal, int window, float softcap,
                                          void* stream) {
  using namespace repro_torch;
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  const Shape sh{lengths, B, H, KV, S, causal, window,
                 1.f / std::sqrt(static_cast<float>(hd)), softcap};
  const Args a{q, k, v, o, dout, lse, D, dq, dk, dv, sh, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_hd<float>(hd, a);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16>(hd, a);
  return cudaErrorInvalidValue;
}
