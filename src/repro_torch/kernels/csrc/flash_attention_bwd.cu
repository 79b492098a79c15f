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
// in up to four launches on one stream:
//   1. a pre-pass writes each row's D and L·log2(e) (+inf for a row with no
//      valid key, so that its P is exactly 0);
//   2. one block per (query head, batch row, query tile) writes dQ, walking
//      the key tiles its rows can see;
//   3. one block per (KV head · split, batch row, key tile) writes dK and dV,
//      walking the query tiles that can see its keys, for the query heads of
//      its share of the GQA group;
//   4. where a group is split over several blocks, a pass adds each key's
//      float32 partials in split order and writes dK and dV.
// No atomics: every output element is written once, by one thread, and every
// sum runs in a fixed order, so two calls give bit-identical gradients.
//
// What bounds it on the H100: operations (five products of hd multiply-adds
// per (query, key) pair; seven here, since the dQ launch recomputes q·k and
// dO·v).  All of them run on the tensor cores with mma.sync, as the forward's:
// float32 as three TF32 passes (big·big + big·small + small·big, accumulated
// in float32: float32 accuracy; one pass misses 1e-4), bfloat16 as one pass
// of m16n8k16 with P and dX rounded to bf16 before their products.  With
// mma.sync the splitting of the float32 operands, not the products, is most
// of what a warp issues, so the split is tensor_core.cuh's truncating one,
// two instructions a value.  The design around the products:
//   - A warp owns 16 rows (queries in launch 2, keys in launch 3) and keeps
//     their gradient in matrix-multiply accumulators for the whole walk.  The
//     two score products (S and dP) run in one loop, so that eight chains of
//     mma.sync, not four, are in flight.  In
//     launch 3 the scores are computed transposed (keys × queries), so that
//     Pᵀ and dXᵀ are already the A operands of dV += Pᵀ·dO and dK += dXᵀ·Q,
//     with no trip through shared memory; in launch 2 P and dX are the A
//     operand of dQ += dX·K.  The reduction dimension inside a k-step is
//     permuted so that an accumulator fragment is an A fragment as it stands.
//   - A block's own rows (Q and dO, or K and V) stay in shared memory; the
//     other side streams through a two-stage cp.async ring of 32-row tiles
//     (with each query tile's L and D in launch 3).  Rows are padded to an
//     odd multiple of four words, which makes both operand patterns (row g,
//     column t; rows 2t and 2t+1, column g) free of bank conflicts, for
//     32-bit loads and for ldmatrix's 16-byte rows alike (bf16 takes its
//     operands by ldmatrix, transposed where the pattern is the second).
//   - A GQA group's query heads are split across blocks (the host picks the
//     count), so that small B·KV still fills the card; heaviest causal tiles
//     are launched first in both launches.
//   - Tiles and 8-column blocks that the causal, window and length masks
//     remove are skipped; tiles that cross a mask test each pair.
//   - At head size 192 the dK and dV accumulators do not fit in registers
//     together: launch 3 runs twice, for dV and then for dK.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "tensor_core.cuh"

namespace repro_torch {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  const int* lengths;  // (B,) or null: every row has S keys
  int B, H, KV, S, causal, window;
  float scale, softcap;
};

// Tiles of one instantiation (the host planner in flash_attention.py
// mirrors kRows as KEY_ROWS).  kLd: row length in shared memory, 16 bytes of
// padding, an odd multiple of four 32-bit words for every head size.
template <typename T, int HD>
struct Cfg {
  static constexpr int kWarps = HD == 128 ? 8 : 4;
  static constexpr int kRows = 16 * kWarps;  // rows a block owns
  static constexpr int kBN = 32;             // rows a streamed tile
  static constexpr int kNB = kBN / 8;        // 8-column blocks of a score tile
  static constexpr int kNO = HD / 8;         // 8-column blocks of a gradient row
  static constexpr int kLd = HD + 16 / static_cast<int>(sizeof(T));
  static constexpr int kThreads = 32 * kWarps;
  static constexpr size_t tile_bytes() {
    return static_cast<size_t>(2 * kRows + 2 * 2 * kBN) * kLd * sizeof(T);
  }
};

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

// P and dX of one visible pair from x = q·k and dp = dO·v; lse2 = L·log2(e).
__device__ __forceinline__ void pair_grads(const Shape& sh, float x, float dp, float lse2, float D,
                                           float& p, float& dx) {
  float t2, dtdx;
  if (sh.softcap > 0.f) {
    const float th = tanhf(x * sh.scale / sh.softcap);
    t2 = th * (sh.softcap * kLog2e);
    dtdx = sh.scale * (1.f - th * th);
  } else {
    t2 = x * (sh.scale * kLog2e);
    dtdx = sh.scale;
  }
  p = exp2f(t2 - lse2);
  dx = p * (dp - D) * dtdx;
}

// ------------------------------------------------------- warp products
// A float32 fragment as two TF32 parts for the three passes, split by
// truncation (tensor_core.cuh).
template <int N>
using Frag = TruncSplitFrag<N>;

// Four 8×8 tiles of 16-bit elements from shared memory (ldmatrix): lane l
// gives the address of row l % 8 of tile l / 8; tile i lands in r[i] as an
// mma fragment (row g, columns 2t and 2t + 1), or with kTrans transposed
// (rows 2t and 2t + 1, column g).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// c[n] += A·Bᵀ over the HD columns, for the 8-row blocks n of B in [lo, hi):
// A = the warp's 16 rows at `a` (row stride LD), B = the tile's rows at `b`;
// with kTwo also c2[n] += A2·B2ᵀ in the same loop, whose chains of products
// interleave with the first's.  Fragment column t of a k-step is column t
// and t + 4 of the rows (m16n8k8, 32-bit loads) or the pairs 2t and 2t + 8
// (m16n8k16: ldmatrix, A's 16 × 16 tile in one, B's two 8-row blocks in one).
template <typename T, int HD, int LD, int NB, bool kTwo>
__device__ __forceinline__ void rows_dot(float (&c)[NB][4], const T* a, const T* b,
                                         float (&c2)[NB][4], const T* a2, const T* b2, int lo,
                                         int hi, int g, int t) {
  if constexpr (sizeof(T) == 4) {
    const float* af = reinterpret_cast<const float*>(a) + g * LD + t;
    const float* af2 = reinterpret_cast<const float*>(a2) + g * LD + t;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float* ar = af + kk * 8;
      const Frag<4> fa({ar[0], ar[8 * LD], ar[4], ar[8 * LD + 4]});
      const float* ar2 = af2 + kk * 8;
      const Frag<4> fa2 = kTwo ? Frag<4>({ar2[0], ar2[8 * LD], ar2[4], ar2[8 * LD + 4]}) : fa;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n >= lo && n < hi) {
          const int off = (n * 8 + g) * LD + kk * 8 + t;
          const float* br = reinterpret_cast<const float*>(b) + off;
          mma_3xtf32(c[n], fa, Frag<2>({br[0], br[4]}));
          if constexpr (kTwo) {
            const float* br2 = reinterpret_cast<const float*>(b2) + off;
            mma_3xtf32(c2[n], fa2, Frag<2>({br2[0], br2[4]}));
          }
        }
      }
    }
  } else {
    const int lane = 4 * g + t;
    const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);  // tiles a0..a3
    const int b_off = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);  // blocks n, n + 1
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t fa[4], fa2[4];
      ldsm_x4<false>(fa, a + a_off + kk * 16);
      if constexpr (kTwo) ldsm_x4<false>(fa2, a2 + a_off + kk * 16);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        if (n + 1 >= lo && n < hi) {
          const int off = n * 8 * LD + b_off + kk * 16;
          uint32_t fb[4];
          ldsm_x4<false>(fb, b + off);
          if (n >= lo) mma_bf16(c[n], fa, fb[0], fb[1]);
          if (n + 1 < hi) mma_bf16(c[n + 1], fa, fb[2], fb[3]);
          if constexpr (kTwo) {
            ldsm_x4<false>(fb, b2 + off);
            if (n >= lo) mma_bf16(c2[n], fa2, fb[0], fb[1]);
            if (n + 1 < hi) mma_bf16(c2[n + 1], fa2, fb[2], fb[3]);
          }
        }
      }
    }
  }
}

// o[c] += P·B: P the warp's 16 × (8·NB) accumulator fragments p[n] (only
// the blocks n in [lo, hi) are read), B the tile's 8·NB rows at `b` (row
// stride LD) and their HD columns.  Inside a k-step of m16n8k8, fragment
// column t is row 2t of B and column t + 4 row 2t + 1, so p[n] is the A
// fragment as it stands; m16n8k16 takes two blocks a step, rounded to bf16.
template <typename T, int HD, int LD, int NB>
__device__ __forceinline__ void frags_times_rows(float (&o)[HD / 8][4], const float (&p)[NB][4],
                                                 const T* b, int lo, int hi, int g, int t) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (n >= lo && n < hi) {
        const Frag<4> af({p[n][0], p[n][2], p[n][1], p[n][3]});
        const float* b0 = reinterpret_cast<const float*>(b) + (n * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) mma_3xtf32(o[c], af, Frag<2>({b0[c * 8], b0[LD + c * 8]}));
      }
    }
  } else {
    const int lane = 4 * g + t;
    // Transposed tiles: rows 16j + (0..7, 8..15) of columns 8c and 8c + 8.
    const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      if (2 * j + 1 >= lo && 2 * j < hi) {
        const uint32_t af[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]), pack_bf16(p[2 * j][2], p[2 * j][3]),
                                pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                                pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
        const T* b0 = b + j * 16 * LD + b_off;
#pragma unroll
        for (int c = 0; c < HD / 8; c += 2) {
          uint32_t fb[4];
          ldsm_x4<true>(fb, b0 + c * 8);
          mma_bf16(o[c], af, fb[0], fb[1]);
          mma_bf16(o[c + 1], af, fb[2], fb[3]);
        }
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Rows r0 + g and r0 + g + 8, columns 8c + 2t, +1 of a warp's accumulators,
// into rows of HD elements at `dst` (rows at or past `rows` are skipped).
template <typename Out, int HD>
__device__ __forceinline__ void store_rows(Out* dst, const float (&acc)[HD / 8][4], int r0,
                                           int rows, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= rows) continue;
    Out* out = dst + static_cast<size_t>(row) * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float x0 = acc[c][2 * r], x1 = acc[c][2 * r + 1];
      if constexpr (sizeof(Out) == 4) {
        *reinterpret_cast<float2*>(out + c * 8) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(out + c * 8) = pack_bf16(x0, x1);
      }
    }
  }
}

// ------------------------------------------------------------ 1. D, L
// A warp a row: stats[row] = L·log2(e) (+inf where L = -inf: P = 0 exactly),
// stats[rows + row] = D = rowsum(dO∘O).
template <typename T, int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ stats, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane * 4; c < HD; c += 128) {
    const size_t i = static_cast<size_t>(row) * HD + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(to_float(o[i + e]), to_float(dout[i + e]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float l = lse[row];
    stats[row] = l == -INFINITY ? INFINITY : l * kLog2e;
    stats[static_cast<size_t>(rows) + row] = acc;
  }
}

// ------------------------------------------------------------------ 2. dQ
// One block per (head, batch row, query tile of kRows rows), heaviest tile
// first; warp w owns rows q0 + 16w .. +15.  Key tiles stream through a
// two-stage ring.
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ stats, T* __restrict__ dq, Shape sh) {
  using C = Cfg<T, HD>;
  constexpr int LD = C::kLd, BM = C::kRows, BN = C::kBN, NB = C::kNB;
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);  // [BM][LD]
  T* do_s = q_s + BM * LD;               // [BM][LD]
  T* k_s = do_s + BM * LD;               // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;            // [2][BN][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int kvh = h / (sh.H / sh.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * warp;
  const size_t qrow = (static_cast<size_t>(b) * sh.H + h) * sh.S;
  const size_t krow = (static_cast<size_t>(b) * sh.KV + kvh) * sh.S;
  const T* kb = k + krow * HD;
  const T* vb = v + krow * HD;

  // The keys these rows can see, as the forward bounds them.
  const int n_keys = valid_keys(sh, b);
  int k_end = n_keys;
  if (sh.causal) k_end = min(k_end, min(q0 + BM, sh.S));
  const int k_begin = sh.window > 0 ? max(0, q0 - sh.window + 1) / BN * BN : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  int warp_end = sh.causal ? min(k_end, wq0 + 16) : k_end;
  if (wq0 >= sh.S) warp_end = 0;

  load_rows<T, HD>(q_s, LD, q + qrow * HD, HD, q0, BM, sh.S, tid, C::kThreads);
  load_rows<T, HD>(do_s, LD, dout + qrow * HD, HD, q0, BM, sh.S, tid, C::kThreads);
  if (n_tiles > 0) {
    load_rows<T, HD>(k_s, LD, kb, HD, k_begin, BN, sh.S, tid, C::kThreads);
    load_rows<T, HD>(v_s, LD, vb, HD, k_begin, BN, sh.S, tid, C::kThreads);
  }
  cp_async_commit();

  int qpos[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = wq0 + g + 8 * r;
    const bool in = qpos[r] < sh.S;
    lse2[r] = in ? stats[qrow + qpos[r]] : INFINITY;
    Dr[r] = in ? stats[static_cast<size_t>(sh.B) * sh.H * sh.S + qrow + qpos[r]] : 0.f;
  }
  float acc[C::kNO][4];
  zero(acc);
  const T* qw = q_s + 16 * warp * LD;
  const T* dow = do_s + 16 * warp * LD;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BN;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      load_rows<T, HD>(k_s + st * BN * LD, LD, kb, HD, k0 + BN, BN, sh.S, tid, C::kThreads);
      load_rows<T, HD>(v_s + st * BN * LD, LD, vb, HD, k0 + BN, BN, sh.S, tid, C::kThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, dO) landed for every thread

    const int hi = min(NB, max(0, (warp_end - k0 + 7) / 8));
    if (hi > 0) {
      const T* ks = k_s + (it & 1) * BN * LD;
      const T* vs = v_s + (it & 1) * BN * LD;
      float s[NB][4], dp[NB][4];
      zero(s);
      zero(dp);
      rows_dot<T, HD, LD, NB, true>(s, qw, ks, dp, dow, vs, 0, hi, g, t);  // S, dP
      const bool edge = hi < NB || k0 + BN > k_end || wq0 + 16 > sh.S ||
                        (sh.causal && k0 + BN - 1 > wq0) ||
                        (sh.window > 0 && k0 <= wq0 + 15 - sh.window);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p, dx;
          pair_grads(sh, s[n][e], dp[n][e], lse2[r], Dr[r], p, dx);
          if (edge && !visible(sh, n_keys, qpos[r], k0 + n * 8 + 2 * t + (e & 1))) dx = 0.f;
          s[n][e] = dx;
        }
      }
      frags_times_rows<T, HD, LD, NB>(acc, s, ks, 0, hi, g, t);  // dQ += dX·K
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  store_rows<T, HD>(dq + qrow * HD, acc, wq0, sh.S, g, t);
}

// ------------------------------------------------------------- 3. dK, dV
// One block per (KV head · split, batch row, key tile of kRows keys),
// heaviest (first) key tile first; warp w owns keys k0 + 16w .. +15.  The
// block walks the query heads hh of its split of the group and, for each,
// the query tiles that can see its keys, through a two-stage ring of Q, dO
// and their rows' L·log2(e) and D.  kGrads: 3 for dK and dV, 1 for dV
// alone, 2 for dK alone.  With one split the block writes dK and dV in T;
// with more it writes float32 partials (2, splits, B, KV, S, HD) that
// launch 4 adds.
template <typename T, int HD, int kGrads>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ stats, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ partial, int splits, Shape sh) {
  using C = Cfg<T, HD>;
  constexpr int LD = C::kLd, BM = C::kRows, BN = C::kBN, NB = C::kNB, NO = C::kNO;
  constexpr bool kDV = kGrads & 1, kDK = kGrads & 2;
  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);  // [BM][LD]
  T* v_s = k_s + BM * LD;                // [BM][LD]
  T* q_s = v_s + BM * LD;                // [2][BN][LD]
  T* do_s = q_s + 2 * BN * LD;           // [2][BN][LD]
  float* st_s = reinterpret_cast<float*>(do_s + 2 * BN * LD);  // [2][2][BN]: L·log2(e), D

  const int group = sh.H / sh.KV, per = group / splits;
  const int kvh = blockIdx.x / splits, split = blockIdx.x - kvh * splits;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + 16 * warp;
  const size_t krow = (static_cast<size_t>(b) * sh.KV + kvh) * sh.S;
  const size_t plane = static_cast<size_t>(sh.B) * sh.H * sh.S;  // stats: L2 then D
  const int h0 = kvh * group + split * per;

  // The query tiles that can see a key of this block (none past the keys'
  // length: their gradients are zeros).
  const int n_keys = valid_keys(sh, b);
  const int i_begin = sh.causal ? k0 / BN * BN : 0;
  const int i_end = sh.window > 0 ? min(sh.S, k0 + BM - 1 + sh.window) : sh.S;
  const int n_qt = k0 < n_keys && i_end > i_begin ? (i_end - i_begin + BN - 1) / BN : 0;
  const int n_iters = per * n_qt;

  const auto load_tile = [&](int it, int st) {
    const int hh = h0 + it / n_qt;
    const int qt0 = i_begin + (it % n_qt) * BN;
    const size_t qrow = (static_cast<size_t>(b) * sh.H + hh) * sh.S;
    load_rows<T, HD>(q_s + st * BN * LD, LD, q + qrow * HD, HD, qt0, BN, sh.S, tid, C::kThreads);
    load_rows<T, HD>(do_s + st * BN * LD, LD, dout + qrow * HD, HD, qt0, BN, sh.S, tid,
                     C::kThreads);
    if (tid < 2 * BN) {
      const int which = tid / BN, r = tid - which * BN;
      const bool in = qt0 + r < sh.S;
      const float* src = stats + which * plane + qrow + (in ? qt0 + r : 0);
      cp_async4(st_s + (st * 2 + which) * BN + r, src, in);
    }
  };

  if (n_iters > 0) {
    load_rows<T, HD>(k_s, LD, k + krow * HD, HD, k0, BM, sh.S, tid, C::kThreads);
    if (kDK) load_rows<T, HD>(v_s, LD, v + krow * HD, HD, k0, BM, sh.S, tid, C::kThreads);
    load_tile(0, 0);
  }
  cp_async_commit();

  float dk_acc[kDK ? NO : 1][4], dv_acc[kDV ? NO : 1][4];
  zero(dk_acc);
  zero(dv_acc);
  const T* kw = k_s + 16 * warp * LD;
  const T* vw = v_s + 16 * warp * LD;

  for (int it = 0; it < n_iters; ++it) {
    if (it + 1 < n_iters) {
      load_tile(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and K, V) landed for every thread

    const int q0 = i_begin + (it % n_qt) * BN;
    // 8-query blocks of this tile that can see one of this warp's keys.
    const int lo = sh.causal ? min(NB, max(0, (wk0 - q0) >> 3)) : 0;
    bool active = wk0 < n_keys && lo < NB;
    if (sh.window > 0) active = active && q0 <= wk0 + 15 + sh.window - 1;
    if (active) {
      const int st = it & 1;
      const T* qs = q_s + st * BN * LD;
      const T* dos = do_s + st * BN * LD;
      const float* l2s = st_s + st * 2 * BN;
      const float* d_s = l2s + BN;
      float s[NB][4], dp[NB][4];
      zero(s);
      zero(dp);
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dV alone needs no dPᵀ).
      rows_dot<T, HD, LD, NB, kDK>(s, kw, qs, dp, vw, dos, lo, NB, g, t);
      const bool edge = q0 + BN > sh.S || wk0 + 16 > n_keys || (sh.causal && wk0 + 15 > q0) ||
                        (sh.window > 0 && q0 + BN - 1 >= wk0 + sh.window);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          float p, dx;
          pair_grads(sh, s[n][e], dp[n][e], l2s[col], d_s[col], p, dx);
          if (edge && !visible(sh, n_keys, q0 + col, wk0 + g + 8 * (e >> 1))) p = dx = 0.f;
          s[n][e] = p;
          dp[n][e] = dx;
        }
      }
      if constexpr (kDV) frags_times_rows<T, HD, LD, NB>(dv_acc, s, dos, lo, NB, g, t);  // dV += Pᵀ·dO
      if constexpr (kDK) frags_times_rows<T, HD, LD, NB>(dk_acc, dp, qs, lo, NB, g, t);  // dK += dXᵀ·Q
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  if (splits == 1) {
    if constexpr (kDK) store_rows<T, HD>(dk + krow * HD, dk_acc, wk0, sh.S, g, t);
    if constexpr (kDV) store_rows<T, HD>(dv + krow * HD, dv_acc, wk0, sh.S, g, t);
  } else {
    const size_t n = static_cast<size_t>(sh.B) * sh.KV * sh.S * HD;
    const size_t off = (static_cast<size_t>(split) * sh.B * sh.KV * sh.S + krow) * HD;
    if constexpr (kDK) store_rows<float, HD>(partial + off, dk_acc, wk0, sh.S, g, t);
    if constexpr (kDV) {
      store_rows<float, HD>(partial + static_cast<size_t>(splits) * n + off, dv_acc, wk0, sh.S, g, t);
    }
  }
}

// ----------------------------------------------------------- 4. the sums
// dK and dV = the splits' partials added in split order; 4 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ partial, T* __restrict__ dk,
                         T* __restrict__ dv, int splits, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* src = partial + static_cast<size_t>(which) * splits * n + i;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(s) * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    T* out = (which == 0 ? dk : dv) + i;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out) = acc;
    } else {
      *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* stats;
  float* partial;
  int splits;
  void *dq, *dk, *dv;
  Shape sh;
  cudaStream_t stream;
};

template <typename T, int HD, int kGrads>
cudaError_t launch_dkdv(const Args& a, size_t smem) {
  cudaError_t err = allow_shared_bytes(flash_bwd_dkdv_kernel<T, HD, kGrads>, smem);
  if (err != cudaSuccess) return err;
  const Shape& sh = a.sh;
  using C = Cfg<T, HD>;
  const dim3 grid(sh.KV * a.splits, sh.B, (sh.S + C::kRows - 1) / C::kRows);
  flash_bwd_dkdv_kernel<T, HD, kGrads><<<grid, C::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.partial, a.splits, sh);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  using C = Cfg<T, HD>;
  const Shape& sh = a.sh;
  const int rows = sh.B * sh.H * sh.S;
  flash_bwd_prep_kernel<T, HD><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.stats, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_smem = C::tile_bytes();
  err = allow_shared_bytes(flash_bwd_dq_kernel<T, HD>, dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(sh.H, sh.B, (sh.S + C::kRows - 1) / C::kRows);
  flash_bwd_dq_kernel<T, HD><<<dq_grid, C::kThreads, dq_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.stats, static_cast<T*>(a.dq), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_smem = C::tile_bytes() + 2 * 2 * C::kBN * sizeof(float);
  if constexpr (HD == 192) {  // dV, then dK: both accumulators do not fit in registers
    err = launch_dkdv<T, HD, 1>(a, dkdv_smem);
    if (err != cudaSuccess) return err;
    err = launch_dkdv<T, HD, 2>(a, dkdv_smem);
  } else {
    err = launch_dkdv<T, HD, 3>(a, dkdv_smem);
  }
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t n = static_cast<size_t>(sh.B) * sh.KV * sh.S * HD;
  flash_bwd_sum_kernel<T><<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0, a.stream>>>(
      a.partial, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.splits, n);
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
// (B, H, S) float32, the forward's; stats: (2, B, H, S) float32 scratch,
// written by the first launch and read by the others; lengths: (B,) int32 or
// null.  splits: how many blocks share a GQA group's query heads in the dK/dV
// launch (it must divide H / KV); with splits > 1, partial is a (2, splits,
// B, KV, S, hd) float32 scratch, else it is not read and may be null.  hd
// must be 16, 32, 64, 128 or 192; causal, window and softcap as the forward
// took them.  Launches on `stream` and returns the first launch error (0 when
// every launch was accepted).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          const int* lengths, float* stats, float* partial,
                                          void* dq, void* dk, void* dv, int dtype, int B, int H,
                                          int KV, int S, int hd, int causal, int window,
                                          float softcap, int splits, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || !(softcap >= 0.f) || splits <= 0 ||
      (H / KV) % splits != 0 || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const Shape sh{lengths, B, H, KV, S, causal, window,
                 1.f / std::sqrt(static_cast<float>(hd)), softcap};
  const Args a{q, k, v, o, dout, lse, stats, partial, splits, dq, dk, dv, sh,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_hd<float>(hd, a);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16>(hd, a);
  return cudaErrorInvalidValue;
}
