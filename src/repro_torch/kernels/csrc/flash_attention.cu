// Flash attention (prefill) for Hopper (sm_90a): causal or full attention
// per (batch row, query head) with grouped-query KV heads, a per-row
// `lengths` mask and an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py, function
// flash_attention_pallas (body `_kernel`).  That kernel carried the
// online-softmax state (m, l, acc) across key blocks along the innermost,
// sequential grid axis.  Blocks on Hopper run in no order, so here one
// block owns a (batch row, head, query tile) and loops over the key tiles
// itself; the state lives in the registers of the matrix-multiply
// accumulator fragments.  The wrapper of the TPU kernel padded S up to the
// tile on the host; here the ragged tail of S is masked in the kernel and
// nothing is padded.
//
// What bounds it on the H100: operations, at the serving path's shapes
// (S <= 256, hd 64 or 128: ~S/2 multiply-adds per loaded element).  Float32
// on the SIMT cores tops out at 67 TFLOP/s, so both products run on the
// tensor cores with mma.sync m16n8k8 in TF32 (495 TFLOP/s dense).  One TF32
// pass keeps 10 mantissa bits and misses the float32 tolerance (~1e-3 at
// these shapes), so each float32 operand x is split into big = tf32(x) and
// small = tf32(x - big), rounded to nearest with ties away from zero, and
// each product is big·big + big·small + small·big, accumulated in float32:
// three tensor-core passes that match float32 (only small·small, ~2^-22
// relative, is dropped).  That is the route PyTorch's memory-efficient
// attention takes for float32 (CUTLASS's OpMultiplyAddFastF32).  The
// splitting, not the products, is then most of the instructions a tile
// issues, so it is done by two integer operations a value (see to_tf32),
// each fragment is split once for all the products it enters, and the
// three passes of Q·Kᵀ go to three accumulators so that they do not wait
// on each other.  bfloat16 inputs take one pass of mma.sync m16n8k16 in
// bf16 with float32 accumulation, and the probabilities are rounded to
// bf16 before P·V, as the Pallas body does.
//
// The design around the products: each warp owns 16 query rows, a block
// 2 or 4 warps (32 query rows and 32-key tiles for S <= 32, the smallest
// bucket; else 64 rows, and 16-key tiles at hd 128 or 64-key ones below);
// K/V tiles go into a two-stage shared-memory ring with 16-byte cp.async,
// so the next tile lands while this one is computed on; the rows of Q, K
// and V in shared memory are padded so that every fragment load is free of
// bank conflicts (K and Q are read in 8-byte pairs: the head dimension
// inside an 8-wide k-step is permuted the same way in both operands; the
// keys inside a k-step of P·V are permuted so that the score fragment is
// already the A fragment of P, with no shuffles); the softmax runs online
// in float32 on the accumulator fragments, four lanes to a row (two
// shuffles per statistic); key tiles that the causal, window and length
// masks remove are never loaded, and within a tile a warp skips the 8-key
// column blocks that lie past its last row; blocks are launched heaviest
// query tile first.  Left for later: packing a GQA group's query heads into
// one block's rows (each K/V tile is read once per query head, from L2),
// wgmma with TMA, and a persistent schedule.
//
// A logit softcap (tanh(s / cap) · cap on the scaled scores, before the
// masks) is a template flag, so that the instantiations without it are the
// code they were.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kStages = 2;  // K/V tiles in flight

struct Strides {
  long long b, h, s;  // the head dimension is contiguous
};

// ------------------------------------------------------------ primitives
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// The three passes of a split-TF32 product: d += a·b to float32 accuracy.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const SplitFrag<4>& a,
                                           const SplitFrag<2>& b) {
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

// ------------------------------------------------------------ tiling
// Shared-memory row lengths (in elements), chosen for conflict-free
// fragment loads: Q and K are read as 8-byte pairs by rows g = 0..7 and
// pair index t = 0..3 (row stride = 8 words mod 32); V as single elements
// of rows 2t and 2t+1 (float32: row stride = 4 words mod 32) or 16-bit
// halves (bf16: 4 words mod 32).  Every row stays a multiple of 16 bytes.
template <typename T, int HD, int BK>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBlockK = BK;  // keys per tile
  static constexpr int kQS = kF32 ? HD + 8 : HD + 16;
  static constexpr int kKS = kF32 ? HD + 8 : HD + 16;
  static constexpr int kVS = kF32 ? HD + 4 : HD + 8;
  static constexpr int kNT = kBlockK / 8;  // 8-key column blocks of a score tile
  static constexpr int kNO = HD / 8;       // 8-wide column blocks of the output

  static constexpr size_t shared_bytes(int warps) {
    return (static_cast<size_t>(16 * warps) * kQS +
            static_cast<size_t>(kStages) * kBlockK * (kKS + kVS)) *
           sizeof(T);
  }
};

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

template <typename T, int HD, int WARPS, int BK, bool SOFTCAP>
__global__ void __launch_bounds__(32 * WARPS)
    flash_attention_kernel(const T* __restrict__ q,  // (B, H, S, HD)
                           const T* __restrict__ k,  // (B, KV, S, HD)
                           const T* __restrict__ v,  // (B, KV, S, HD)
                           const int* __restrict__ lengths,  // (B,) or null: all S
                           T* __restrict__ out,              // (B, H, S, HD), contiguous
                           int H, int KV, int S, Strides sq, Strides sk, Strides sv, int causal,
                           int window, float sm_scale, float softcap) {
  using L = Tile<T, HD, BK>;
  constexpr int BQ = 16 * WARPS;
  constexpr int NT = L::kNT;
  constexpr int NO = L::kNO;
  constexpr int kThreads = 32 * WARPS;
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);  // [BQ][kQS]
  T* k_s = q_s + BQ * L::kQS;            // [kStages][BK][kKS]
  T* v_s = k_s + kStages * BK * L::kKS;  // [kStages][BK][kVS]

  // Heaviest query tiles first: z runs slowest in the block order.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int wq0 = q0 + warp * 16;
  const int qpos[2] = {wq0 + g, wq0 + g + 8};

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  // Keys this tile of queries can see at all, and this warp's last key.
  int k_end = S;
  if (lengths != nullptr) k_end = min(k_end, max(lengths[b], 0));
  if (causal) k_end = min(k_end, min(q0 + BQ, S));
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  int warp_end = causal ? min(k_end, wq0 + 16) : k_end;
  if (wq0 >= S) warp_end = 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_rows<T, HD>(q_s, L::kQS, qb, sq.s, q0, BQ, S, tid, kThreads);
  if (n_tiles > 0) {
    load_rows<T, HD>(k_s, L::kKS, kb, sk.s, k_begin, BK, S, tid, kThreads);
    load_rows<T, HD>(v_s, L::kVS, vb, sv.s, k_begin, BK, S, tid, kThreads);
  }
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  // Scores in log2 units: exp2 of the scaled difference is exp of the score's.
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = sm_scale * kLog2e;
  const auto to_log2 = [&](float x) {
    if constexpr (SOFTCAP) {
      return tanhf(x * sm_scale / softcap) * (softcap * kLog2e);
    } else {
      return x * scale2;
    }
  };
  const T* qw = q_s + warp * 16 * L::kQS;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) % kStages;
      load_rows<T, HD>(k_s + st * BK * L::kKS, L::kKS, kb, sk.s, k0 + BK, BK, S, tid, kThreads);
      load_rows<T, HD>(v_s + st * BK * L::kVS, L::kVS, vb, sv.s, k0 + BK, BK, S, tid, kThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) landed for every thread

    // 8-key column blocks of this tile that this warp's rows can see.
    const int nt_lim = min(NT, max(0, (warp_end - k0 + 7) / 8));
    if (nt_lim > 0) {
      const T* ks = k_s + (it % kStages) * BK * L::kKS;
      const T* vs = v_s + (it % kStages) * BK * L::kVS;

      // ---- S = Q·Kᵀ on the tensor cores.
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if constexpr (L::kF32) {
        float s_mixed[NT][4], s_other[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_mixed[n][e] = s_other[n][e] = 0.f;
        // k-step of 8 head dims; fragment column t holds dim 2t and column
        // t + 4 dim 2t + 1 of the step, in Q and in K alike.
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          const float2 qa = *reinterpret_cast<const float2*>(qw + g * L::kQS + kk * 8 + 2 * t);
          const float2 qc = *reinterpret_cast<const float2*>(qw + (g + 8) * L::kQS + kk * 8 + 2 * t);
          const SplitFrag<4> a({qa.x, qc.x, qa.y, qc.y});
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < nt_lim) {
              const float2 kx =
                  *reinterpret_cast<const float2*>(ks + (n * 8 + g) * L::kKS + kk * 8 + 2 * t);
              mma_3xtf32(s[n], s_mixed[n], s_other[n], a, SplitFrag<2>({kx.x, kx.y}));
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += s_mixed[n][e] + s_other[n][e];
      } else {
        // k-step of 16 head dims; the register pair of columns (2t, 2t+1)
        // holds dims 4t, 4t+1 and the pair (2t+8, 2t+9) dims 4t+2, 4t+3.
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint2 qa = *reinterpret_cast<const uint2*>(qw + g * L::kQS + kk * 16 + 4 * t);
          const uint2 qc = *reinterpret_cast<const uint2*>(qw + (g + 8) * L::kQS + kk * 16 + 4 * t);
          const uint32_t a[4] = {qa.x, qc.x, qa.y, qc.y};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n < nt_lim) {
              const uint2 kx =
                  *reinterpret_cast<const uint2*>(ks + (n * 8 + g) * L::kKS + kk * 16 + 4 * t);
              mma_bf16(s[n], a, kx.x, kx.y);
            }
          }
        }
      }

      // ---- Online softmax on the fragments: lane holds rows g and g + 8,
      // keys k0 + 8n + 2t + {0, 1}.
      float mx[2] = {kNegInf, kNegInf};
      // A tile that no mask reaches for any row of this warp (the same for
      // the whole warp) takes no per-key test.
      const bool edge = nt_lim < NT || k0 + BK > k_end || (causal && k0 + BK - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + 15 - window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            bool ok = n < nt_lim && kpos < k_end;
            if (causal) ok = ok && kpos <= qpos[r];
            if (window > 0) ok = ok && kpos > qpos[r] - window;
            s[n][e] = ok ? to_log2(s[n][e]) : kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = to_log2(s[n][e]);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // A masked key gives exactly 0, also while the whole row is
          // masked so far (m == kNegInf would make exp2(0) = 1).
          const float p = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }
      // Once the row maxima settle, most tiles move none of them.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }

      // ---- O += P·V on the tensor cores.
      if constexpr (L::kF32) {
        // k-step = 8-key column block n of the scores; column t holds key
        // 2t and column t + 4 key 2t + 1, so the score fragment is the A
        // fragment as it stands.
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < nt_lim) {
            const SplitFrag<4> a({s[n][0], s[n][2], s[n][1], s[n][3]});
            const T* v0 = vs + (n * 8 + 2 * t) * L::kVS + g;
#pragma unroll
            for (int c = 0; c < NO; ++c) {
              mma_3xtf32(o[c], a, SplitFrag<2>({to_float(v0[c * 8]), to_float(v0[L::kVS + c * 8])}));
            }
          }
        }
      } else {
        // k-step = 16 keys, blocks 2n and 2n + 1 of the scores, rounded to
        // bf16 as the Pallas body does (p.astype(v.dtype)).
        const unsigned short* vh = reinterpret_cast<const unsigned short*>(vs);
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          if (2 * n < nt_lim) {
            const uint32_t a[4] = {pack_bf16(s[2 * n][0], s[2 * n][1]),
                                   pack_bf16(s[2 * n][2], s[2 * n][3]),
                                   pack_bf16(s[2 * n + 1][0], s[2 * n + 1][1]),
                                   pack_bf16(s[2 * n + 1][2], s[2 * n + 1][3])};
            const unsigned short* v0 = vh + (n * 16 + 2 * t) * L::kVS + g;
#pragma unroll
            for (int c = 0; c < NO; ++c) {
              const uint32_t b0 = v0[c * 8] | (static_cast<uint32_t>(v0[L::kVS + c * 8]) << 16);
              const uint32_t b1 = v0[8 * L::kVS + c * 8] |
                                  (static_cast<uint32_t>(v0[9 * L::kVS + c * 8]) << 16);
              mma_bf16(o[c], a, b0, b1);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // nothing in flight at exit (a block with no key tile loaded Q alone)

  // Row sums over the row's four lanes; a row with no valid key has l = 0
  // and o = 0 and comes out as zeros.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* orow = out + ((static_cast<size_t>(b) * H + h) * S + qpos[r]) * HD + 2 * t;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const float x0 = o[c][2 * r] * inv, x1 = o[c][2 * r + 1] * inv;
        if constexpr (L::kF32) {
          *reinterpret_cast<float2*>(orow + c * 8) = make_float2(x0, x1);
        } else {
          *reinterpret_cast<uint32_t*>(orow + c * 8) = pack_bf16(x0, x1);
        }
      }
    }
  }
}

// What a launch takes, whatever the instantiation.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  int B, H, KV, S;
  Strides sq, sk, sv;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int HD, int WARPS, int BK, bool SOFTCAP>
cudaError_t launch(const Args& a) {
  const size_t smem = Tile<T, HD, BK>::shared_bytes(WARPS);
  cudaError_t err = allow_shared_bytes(flash_attention_kernel<T, HD, WARPS, BK, SOFTCAP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.S + 16 * WARPS - 1) / (16 * WARPS));
  flash_attention_kernel<T, HD, WARPS, BK, SOFTCAP><<<grid, 32 * WARPS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, static_cast<T*>(a.out), a.H, a.KV, a.S, a.sq, a.sk, a.sv, a.causal, a.window,
      1.f / std::sqrt(static_cast<float>(HD)), a.softcap);
  return cudaGetLastError();
}

template <int HD>
constexpr int kLargeBlockK = HD == 128 ? 16 : 64;

template <typename T, int HD, bool SOFTCAP>
cudaError_t dispatch_tile(const Args& a) {
  // 32 query rows and 32 keys a tile for the smallest bucket, where 64
  // would leave half of every tile idle; otherwise 64 query rows, and keys
  // by the head dimension: 16 at hd 128, so that three blocks' shared
  // memory (69 KB each in float32) fits a SM, 64 below.
  if (a.S <= 32) return launch<T, HD, 2, 32, SOFTCAP>(a);
  return launch<T, HD, 4, kLargeBlockK<HD>, SOFTCAP>(a);
}

template <typename T, bool SOFTCAP>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return dispatch_tile<T, 32, SOFTCAP>(a);
    case 64:
      return dispatch_tile<T, 64, SOFTCAP>(a);
    case 128:
      return dispatch_tile<T, 128, SOFTCAP>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_softcap(int hd, const Args& a) {
  return a.softcap > 0.f ? dispatch_hd<T, true>(hd, a) : dispatch_hd<T, false>(hd, a);
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, S, hd); k, v: (B, KV, S, hd), of the storage type `dtype`, with
// the head dimension contiguous and the other strides given in elements;
// every row must start on a 16-byte boundary (cp.async); lengths: (B,)
// int32 or null (every row has S keys); out: (B, H, S, hd), contiguous.
// hd must be 32, 64 or 128; softcap > 0 caps the scaled scores at
// ±softcap (tanh), 0 leaves them.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* lengths, void* out, int dtype, int B, int H,
                                      int KV, int S, int hd, long long sqb, long long sqh,
                                      long long sqs, long long skb, long long skh,
                                      long long sks, long long svb, long long svh,
                                      long long svs, int causal, int window, float softcap,
                                      void* stream) {
  using namespace repro_torch;
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, out, B, H, KV, S, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
               Strides{svb, svh, svs}, causal, window, softcap, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_softcap<float>(hd, a);
  if (dtype == kBFloat16) return dispatch_softcap<__nv_bfloat16>(hd, a);
  return cudaErrorInvalidValue;
}
