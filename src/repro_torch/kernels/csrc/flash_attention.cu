// Flash attention (prefill) for Hopper (sm_90a): causal or full attention
// per (batch row, query head) with grouped-query KV heads, a per-row
// `lengths` mask and an optional sliding window, whose first `prefix` keys
// every query sees (Hymba's meta tokens: a query at i sees key j where
// j > i − window or j < prefix).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py, function
// flash_attention_pallas (body `_kernel`).  That kernel carried the
// online-softmax state (m, l, acc) across key blocks along the innermost,
// sequential grid axis.  Blocks on Hopper run in no order, so here one
// block owns a tile of query rows and loops over the key tiles itself; the
// state lives in the registers of the matrix-multiply accumulators.  The
// wrapper of the TPU kernel padded S up to the tile on the host; here the
// ragged tail of S is masked in the kernel and nothing is padded.
//
// What bounds it on the H100: operations, at the serving path's shapes
// (S <= 256, hd 16 to 192: ~S/2 multiply-adds per loaded element).  Both
// products run on the tensor cores.  One TF32 pass keeps 10 mantissa bits
// and misses the float32 tolerance (~1e-3 at these shapes), so each
// float32 operand x is split into big = tf32(x) and small = tf32(x - big),
// rounded to nearest with ties away from zero, and each product is
// big·big + big·small + small·big, accumulated in float32: three
// tensor-core passes that match float32 (only small·small, ~2^-22
// relative, is dropped), the route PyTorch's memory-efficient attention
// takes for float32 (CUTLASS's OpMultiplyAddFastF32).  bfloat16 inputs
// take one bf16 pass with float32 accumulation, and the probabilities are
// rounded to bf16 before P·V, as the Pallas body does.
//
// Two routes, chosen per call by the launch plan (flash_attention.py's
// flash_plan), which the launcher checks against its own layout:
//
// "wgmma", the Hopper route.  One block serves a whole GQA group: a (batch
// row, KV head, query tile) owns the rows (query head of the group, query
// position), head-major, `heads` x `positions` of them, packed into 64-row
// slabs, one a consumer warpgroup (one or two a block).  Each K/V tile is
// then loaded once for the group's heads, where a block a query head
// loaded it once per head.  One producer thread issues TMA loads
// (cp.async.bulk.tensor) of the block's Q rows and of each K and V tile
// into a ring of 2 to 4 stages; each stage has a `full` mbarrier (the
// tile's bytes landed) and an `empty` one (every consumer warp is done
// with it).  The tiles land swizzled (32-, 64- or 128-byte rows, by the
// row's width), elements past S as zeros, and threads spend no
// instructions on the copies.  The products are wgmma: S = Q·Kᵀ with K
// read from shared memory (K-major as stored) and Q from registers where
// they suffice (else shared memory), the online softmax in float32 on the
// accumulators, four lanes a row, and O += P·V with P from registers (the
// score accumulators are already the A fragment) and V from shared
// memory.  A warpgroup issues the next tile's Q·Kᵀ and this tile's P·V
// before it waits for the first, so that its softmax overlaps products.
// A bf16 output is staged in Q's shared memory and written by one TMA
// store; float32 rows are stored from the registers.
//   bf16: one pass each; V is read transposed by the descriptor (MN-major),
//   and P is rounded to bf16.
//   float32: three TF32 passes each, chained into one accumulator.  Each
//   operand is split once, by three producer warps (a `split` mbarrier a
//   stage): Q once a block (big in place, small beside it), each K tile
//   the same way, and each V tile transposed into Vᵀ big and small (TF32
//   wgmma takes K-major operands only).  Inside each 8-key group Vᵀ holds
//   keys 0, 2, 4, 6, 1, 3, 5, 7, so that the score accumulators are the
//   TF32 A fragment of P as they stand, with no shuffles.
// Masks go row by row on the position (causal, window and prefix,
// `lengths`, the ragged tail of S); a block walks the tiles that hold the
// prefix, then those of its window, and key tiles that no row of the
// block can see are never loaded, and a warpgroup skips the tiles no row of its slab can see
// (every wgmma is issued unconditionally within a tile: one under a branch
// is serialized); blocks are launched heaviest query tile first.  The
// order of accumulation is fixed and there are no atomics: two calls give
// the same bits.
//
// "mma_sync", the earlier kernel, in the Ampere instruction set: each warp
// owns 16 query rows of one head (2 or 4 warps a block), mma.sync m16n8k8
// TF32 (each warp splits the fragments it reads), K/V tiles in a two-stage
// cp.async ring.  The plan takes it where the card measures it faster:
// float32 at head size 192, where Q's two parts and a two-stage ring leave
// one consumer warpgroup an SM; it is built there alone, and the wgmma
// route everywhere else.
//
// Left for later: a persistent schedule (one block an SM walking the
// tiles, so that one tile's epilogue and the next one's Q load overlap
// the products, and the causal tiles balance across SMs), and ordering
// the two slabs' softmax and products against each other (ping-pong).
//
// A logit softcap (tanh(s / cap) · cap on the scaled scores, before the
// masks) is a template flag, so that the instantiations without it are the
// code they were.  Training asks for each row's log-sum-exp as well (the
// `lse` output, which flash_attention_bwd.cu reads); the serving path
// passes null and the epilogue writes nothing more.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace repro_torch {
namespace {

// ================================================================ mma.sync route
constexpr int kStages = 2;  // K/V tiles in flight

struct Strides {
  long long b, h, s;  // the head dimension is contiguous
};

// ------------------------------------------------------------ tiling
// Shared-memory row lengths (in elements), chosen for conflict-free
// fragment loads: Q and K are read as 8-byte pairs by rows g = 0..7 and
// pair index t = 0..3, half a warp (rows 0..3 or 4..7) at a time, so a row
// stride of 8 words mod 32 keeps the four rows on distinct banks; V as
// single elements of rows 2t and 2t+1 (a row stride of 4 words mod 32).
// Every row stays a multiple of 16 bytes.  Float32 alone.
template <typename T, int HD, int BK>
struct Tile {
  static_assert(sizeof(T) == 4, "the mma.sync route is built for float32");
  static constexpr int kBlockK = BK;  // keys per tile
  static constexpr int kQS = HD + 8;
  static constexpr int kKS = kQS;
  static constexpr int kVS = HD + 4;
  static constexpr int kNT = kBlockK / 8;  // 8-key column blocks of a score tile
  static constexpr int kNO = HD / 8;       // 8-wide column blocks of the output

  static constexpr size_t shared_bytes(int warps) {
    return (static_cast<size_t>(16 * warps) * kQS +
            static_cast<size_t>(kStages) * kBlockK * (kKS + kVS)) *
           sizeof(T);
  }
};

template <typename T, int HD, int WARPS, int BK, bool SOFTCAP>
__global__ void __launch_bounds__(32 * WARPS)
    flash_attention_kernel(const T* __restrict__ q,  // (B, H, S, HD)
                           const T* __restrict__ k,  // (B, KV, S, HD)
                           const T* __restrict__ v,  // (B, KV, S, HD)
                           const int* __restrict__ lengths,  // (B,) or null: all S
                           T* __restrict__ out,              // (B, H, S, HD), contiguous
                           float* __restrict__ lse,          // (B, H, S) or null: not written
                           int H, int KV, int S, Strides sq, Strides sk, Strides sv, int causal,
                           int window, int prefix, float sm_scale, float softcap) {
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
  // The prefix's tiles below the window's first, walked first.
  const int n_pre = window > 0 && prefix > 0 ? min((prefix + BK - 1) / BK, k_begin / BK) : 0;
  const int n_tiles = n_pre + (k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0);
  const auto tile_k0 = [&](int it) { return it < n_pre ? it * BK : k_begin + (it - n_pre) * BK; };

  load_rows<T, HD>(q_s, L::kQS, qb, sq.s, q0, BQ, S, tid, kThreads);
  if (n_tiles > 0) {
    load_rows<T, HD>(k_s, L::kKS, kb, sk.s, tile_k0(0), BK, S, tid, kThreads);
    load_rows<T, HD>(v_s, L::kVS, vb, sv.s, tile_k0(0), BK, S, tid, kThreads);
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
    const int k0 = tile_k0(it);
    if (it + 1 < n_tiles) {
      const int st = (it + 1) % kStages;
      const int k1 = tile_k0(it + 1);
      load_rows<T, HD>(k_s + st * BK * L::kKS, L::kKS, kb, sk.s, k1, BK, S, tid, kThreads);
      load_rows<T, HD>(v_s + st * BK * L::kVS, L::kVS, vb, sv.s, k1, BK, S, tid, kThreads);
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
            if (window > 0) ok = ok && (kpos > qpos[r] - window || kpos < prefix);
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
  // The backward's statistics: the log-sum-exp of each row's capped, scaled
  // and masked scores, in natural units (m is in log2 units); -inf for a
  // row with no valid key.
  if (lse != nullptr && t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] < S)
        lse[(static_cast<size_t>(b) * H + h) * S + qpos[r]] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* orow = out + ((static_cast<size_t>(b) * H + h) * S + qpos[r]) * HD + 2 * t;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const float x0 = o[c][2 * r] * inv, x1 = o[c][2 * r + 1] * inv;
        *reinterpret_cast<float2*>(orow + c * 8) = make_float2(x0, x1);

      }
    }
  }
}

// ================================================================ wgmma route
constexpr int kMaxWarpgroups = 2;  // consumer warpgroups a block
constexpr int kMaxStages = 4;
constexpr int kMaxShared = 232448;  // shared memory a block can use on the H100
constexpr int kSplitWarps = 3;      // float32: the producer warps that split the tiles

// The block's shared-memory layout, from the dynamic shared memory's base,
// which is 1024-byte aligned (the swizzle patterns repeat every 1024 bytes;
// the kernel traps where it is not):
//   Q: `chunks` regions of 64·wgs rows x kChunkBytes (float32: then Q's
//      small part, the same layout); a bf16 O is staged here for its TMA store;
//   each stage: K, V (as TMA writes them: `chunks` regions of kBlockK rows
//      x kChunkBytes), and in float32 K's small part, Vᵀ big, Vᵀ small
//      (HD rows x kBlockK keys);
//   the mbarriers: full[4], split[4] (float32), empty[4], Q's full and split.
// Mirrored by flash_attention.py's wgmma_shared_bytes: change both.
template <typename T, int HD>
struct Hop {
  static constexpr bool kF32 = sizeof(T) == 4;
  static_assert(!(kF32 && HD == 192), "float32 at head size 192 takes the mma.sync route");
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kChunkBytes = kRowBytes < 128 ? kRowBytes : 128;  // the swizzle's width
  static constexpr int kChunkElems = kChunkBytes / static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / kChunkBytes;
  // Keys a tile: float32 stages five tile copies, so 32 up to head size 64
  // and 16 above (two warpgroups' Q parts and two stages fit at 128).
  static constexpr int kBlockK = kF32 ? (HD >= 128 ? 16 : 32) : 64;
  static constexpr int kTileBytes = kBlockK * kRowBytes;
  static constexpr int kStageBytes = (kF32 ? 5 : 2) * kTileBytes;
  static constexpr int kVtRowBytes = kBlockK * 4;  // a row of Vᵀ (float32)
  // Q's parts held in the consumers' registers as the A operand of Q·Kᵀ
  // (2: big and small, 1: big, 0: none, read from shared memory): every
  // k-step of a shared-memory A reads 2 KB for a product N = kBlockK keys
  // wide, which bounds the float32 products by shared memory.  bf16 at
  // head sizes to 64 keeps its registers for more blocks an SM.
  static constexpr int kQRegs = kF32 ? (HD <= 64 ? 2 : 1) : (HD >= 128 ? 1 : 0);
  // Where the accumulators and Q's fragments need more registers than a
  // block of three warpgroups has each, the producer, a whole warpgroup,
  // hands its own to the consumers (setmaxnreg, 40 and 232 a thread).
  static constexpr bool kRebalance = kF32 || HD >= 128;
  // The producer: one warp issues the copies; in float32 kSplitWarps more
  // split them; a warpgroup in all where registers are rebalanced.
  static constexpr int kProducerThreads = (kF32 || kRebalance) ? 32 * (1 + kSplitWarps) : 32;
  __host__ __device__ static constexpr size_t q_bytes(int wgs) {
    return static_cast<size_t>(kF32 ? 2 : 1) * 64 * wgs * kRowBytes;
  }
  __host__ __device__ static constexpr size_t shared_bytes(int wgs, int stages) {
    return q_bytes(wgs) + static_cast<size_t>(stages) * kStageBytes + 128;
  }
};

// The float32 split pass of one stage, by `n` threads (`i0` this one's
// index): K big in place and small beside it (the same swizzled layout), V
// into Vᵀ big and small with each 8-key group's keys in the order 0, 2, 4,
// 6, 1, 3, 5, 7.
template <int HD>
__device__ __forceinline__ void split_stage(uint8_t* ks, int i0, int n) {
  using L = Hop<float, HD>;
  constexpr int BK = L::kBlockK;
  constexpr int CB = L::kChunkBytes;
  const uint8_t* vs = ks + L::kTileBytes;
  uint8_t* k_small = ks + 2 * L::kTileBytes;
  uint8_t* vt_big = ks + 3 * L::kTileBytes;
  uint8_t* vt_small = ks + 4 * L::kTileBytes;
  for (int i = i0; i < L::kTileBytes / 16; i += n) split4(ks + 16 * i, ks + 16 * i, k_small + 16 * i);
  for (int i = i0; i < BK * HD / 4; i += n) {
    const int key = i % BK, d = (i / BK) * 4;  // lanes on keys: conflict-free Vᵀ writes
    const int c = d / L::kChunkElems;
    const float4 x = *reinterpret_cast<const float4*>(
        vs + swizzle<CB>(c * BK * CB + key * CB + (d - c * L::kChunkElems) * 4));
    const int kk = key & 7;
    const int col = (key & ~7) | ((kk & 1) ? 4 + (kk >> 1) : kk >> 1);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t big, small;
      split_tf32(xs[j], big, small);
      const uint32_t off = swizzle<L::kVtRowBytes>((d + j) * L::kVtRowBytes + col * 4);
      *reinterpret_cast<uint32_t*>(vt_big + off) = big;
      *reinterpret_cast<uint32_t*>(vt_small + off) = small;
    }
  }
}

template <typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(128 * kMaxWarpgroups + Hop<T, HD>::kProducerThreads, 1)
    flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,  // (hd, S, H, B)
                                 const __grid_constant__ CUtensorMap map_k,  // (hd, S, KV, B)
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_o,  // (hd, S, H, B): bf16
                                 const int* __restrict__ lengths,  // (B,) or null: all S
                                 T* __restrict__ out,              // (B, H, S, HD), contiguous
                                 float* __restrict__ lse,          // (B, H, S) or null
                                 int H, int S, int group, int heads, int positions, int wgs,
                                 int stages, int causal, int window, int prefix, float sm_scale,
                                 float softcap) {
  using L = Hop<T, HD>;
  constexpr int BK = L::kBlockK;
  constexpr int CB = L::kChunkBytes;
  constexpr uint32_t kLayout = desc_layout<CB>();
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* q_s = smem;
  uint8_t* q_small = smem + 64 * wgs * L::kRowBytes;  // float32
  uint8_t* stage0 = smem + L::q_bytes(wgs);
  const uint32_t full0 = smem_addr(stage0 + static_cast<size_t>(stages) * L::kStageBytes);
  const uint32_t split0 = full0 + 8 * kMaxStages;  // float32: the stage's tiles split
  const uint32_t empty0 = split0 + 8 * kMaxStages;
  const uint32_t q_full = empty0 + 8 * kMaxStages;
  const uint32_t q_split = q_full + 8;
  // What the consumers wait for: the tiles as loaded (bf16) or as split.
  const uint32_t ready0 = L::kF32 ? split0 : full0;
  const uint32_t q_ready = L::kF32 ? q_split : q_full;

  // Heaviest query tiles first: z runs slowest in the block order.
  const int head_tiles = group / heads;
  const int kvh = blockIdx.x / head_tiles;
  const int h0 = kvh * group + (blockIdx.x - kvh * head_tiles) * heads;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * positions;
  const int rows = heads * positions;
  const int consumers = 128 * wgs;

  // Keys the block's rows can see at all.
  int len_end = S;
  if (lengths != nullptr) len_end = __shfl_sync(0xffffffffu, min(len_end, max(lengths[b], 0)), 0);
  const int k_end = causal ? min(len_end, min(q0 + positions, S)) : len_end;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  // The prefix's tiles below the window's first, walked first.
  const int n_pre = window > 0 && prefix > 0 ? min((prefix + BK - 1) / BK, k_begin / BK) : 0;
  const int n_tiles = n_pre + (k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0);
  const auto tile_k0 = [&](int it) { return it < n_pre ? it * BK : k_begin + (it - n_pre) * BK; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    if (smem_addr(smem) & 1023) __trap();  // the layout's swizzles need the alignment
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(split0 + 8 * i, kSplitWarps);
      mbar_init(empty0 + 8 * i, 4 * wgs);  // one arrival a consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_split, kSplitWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= consumers) {  // ---- the producer
    if constexpr (L::kRebalance) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = tid - consumers;
    if (ptid == 0) {  // one thread issues every copy
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_expect_tx(q_full, rows * L::kRowBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_4d(smem_addr(q_s + c * 64 * wgs * CB), &map_q, q_full, c * L::kChunkElems, q0, h0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % stages;
        mbar_wait(empty0 + 8 * st, ((it / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * L::kTileBytes);
        uint8_t* ks = stage0 + st * L::kStageBytes;
        const int k0 = tile_k0(it);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(smem_addr(ks + c * BK * CB), &map_k, full, c * L::kChunkElems, k0, kvh, b);
          tma_load_4d(smem_addr(ks + L::kTileBytes + c * BK * CB), &map_v, full, c * L::kChunkElems,
                      k0, kvh, b);
        }
      }
    } else if constexpr (L::kF32) {
      if (ptid >= 32) {  // the split warps: Q once, then every stage as it lands
        constexpr int kSplitThreads = 32 * kSplitWarps;
        const int sid = ptid - 32;
        mbar_wait(q_full, 0);
        for (int i = sid; i < 64 * wgs * L::kRowBytes / 16; i += kSplitThreads)
          split4(q_s + 16 * i, q_s + 16 * i, q_small + 16 * i);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(q_split);
        for (int it = 0; it < n_tiles; ++it) {
          const int st = it % stages;
          mbar_wait(full0 + 8 * st, (it / stages) & 1);
          split_stage<HD>(stage0 + st * L::kStageBytes, sid, kSplitThreads);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(split0 + 8 * st);
        }
      }
    }
    return;
  }

  if constexpr (L::kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // ---- the consumer warpgroups: warpgroup wg owns rows [64·wg, 64·wg + 64).
  // wg as lane 0 holds it, so that the compiler knows it uniform across the
  // warp, and the branches on it around the wgmma for what they are.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  int qpos[2], qhead[2], qrow[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = 64 * wg + 16 * warp + g + 8 * r;
    qhead[r] = qrow[r] / positions;
    qpos[r] = q0 + qrow[r] - qhead[r] * positions;
    qhead[r] += h0;
    row_ok[r] = qrow[r] < rows && qpos[r] < S;
  }
  // The slab's positions, the keys its rows can see, and its tiles [lo, hi).
  const int r_lo = 64 * wg, r_hi = min(64 * wg + 63, rows - 1);
  int p_lo = 0, p_hi = positions - 1;
  if (r_hi - r_lo + 1 < positions && r_lo % positions <= r_hi % positions) {
    p_lo = r_lo % positions;
    p_hi = r_hi % positions;
  }
  const bool slab_on = r_lo < rows && q0 + p_lo < S;
  const bool slab_full = r_lo + 63 < rows && q0 + p_hi < S;
  const int min_pos = q0 + p_lo, max_pos = min(q0 + p_hi, S - 1);
  const int slab_end = causal ? min(len_end, max_pos + 1) : len_end;
  const int slab_begin = window > 0 ? max(0, min_pos - window + 1) : 0;
  // With a prefix the slab walks every tile from the first up to its
  // window's last: the prefix's, and the few of the block's window that
  // its rows cannot see, all masked.
  int lo = n_tiles, hi = n_tiles;
  if (slab_on && slab_end > k_begin) {
    lo = n_pre > 0 ? 0 : min(n_tiles, (slab_begin - k_begin) / BK);
    hi = min(n_tiles, n_pre + (slab_end - k_begin + BK - 1) / BK);
  } else if (slab_on && n_pre > 0) {
    lo = 0;
    hi = n_pre;
  }

  const auto wait_tile = [&](int it) { mbar_wait(ready0 + 8 * (it % stages), (it / stages) & 1); };
  const auto release = [&](int it) {  // this warp is done with the tile's stage
    __syncwarp();
    mbar_arrive_if(empty0 + 8 * (it % stages), lane == 0);
  };
  const auto stage_addr = [&](int it) {
    return smem_addr(stage0) + static_cast<uint32_t>((it % stages) * L::kStageBytes);
  };
  const uint32_t q_wg = smem_addr(q_s) + 64 * wg * CB;  // this slab's rows in chunk 0
  const uint32_t q_wg_small = smem_addr(q_small) + 64 * wg * CB;
  const uint32_t q_chunk = 64 * wgs * CB;

  // Q's A fragments of this warp's 16 rows, read once (kQRegs parts; the
  // TF32 fragment: rows g, g + 8 x columns t, t + 4 of each 8-wide k-step;
  // bf16: column pairs 2t, 2t + 8 of each 16-wide one).
  constexpr int kQSteps = L::kF32 ? HD / 8 : HD / 16;
  uint32_t q_big[L::kQRegs >= 1 ? kQSteps : 1][4], q_sm[L::kQRegs >= 2 ? kQSteps : 1][4];
  const auto load_q = [&]() {
    constexpr int es = static_cast<int>(sizeof(T));
#pragma unroll
    for (int j = 0; j < (L::kQRegs > 0 ? kQSteps : 0); ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 64 * wg + 16 * warp + g + (e & 1) * 8;
        const int col = L::kF32 ? 8 * j + t + (e >> 1) * 4 : 16 * j + 2 * t + (e >> 1) * 8;
        const int chunk = col / L::kChunkElems;
        const uint32_t off = chunk * q_chunk + swizzle<CB>(row * CB + (col - chunk * L::kChunkElems) * es);
        q_big[j][e] = *reinterpret_cast<const uint32_t*>(q_s + off);
        if constexpr (L::kQRegs >= 2) q_sm[j][e] = *reinterpret_cast<const uint32_t*>(q_small + off);
      }
    }
  };

  // S = Q·Kᵀ of tile `it` into s, issued and committed (not waited for).
  const auto issue_qk = [&](int it, float(&s)[BK / 2]) {
    const uint32_t k_big = stage_addr(it);
    if constexpr (L::kF32) {
      const uint32_t k_small = k_big + 2 * L::kTileBytes;
      // small·big, big·small, big·big, chained in one accumulator.
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int c = j * 32 / CB, off = j * 32 - c * CB;
          const uint64_t db =
              wgmma_desc((pass == 1 ? k_small : k_big) + c * BK * CB + off, 16, 8 * CB, kLayout);
          const int acc = pass > 0 || j > 0;
          if (pass == 0 && L::kQRegs >= 2) {
            wgmma_tf32_rs<BK>(s, q_sm[L::kQRegs >= 2 ? j : 0], db, acc);
          } else if (pass > 0 && L::kQRegs >= 1) {
            wgmma_tf32_rs<BK>(s, q_big[L::kQRegs >= 1 ? j : 0], db, acc);
          } else {
            const uint64_t da =
                wgmma_desc((pass == 0 ? q_wg_small : q_wg) + c * q_chunk + off, 16, 8 * CB, kLayout);
            wgmma_tf32_ss<BK>(s, da, db, acc);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const int c = j * 32 / CB, off = j * 32 - c * CB;
        const uint64_t db = wgmma_desc(k_big + c * BK * CB + off, 16, 8 * CB, kLayout);
        if constexpr (L::kQRegs >= 1) {
          wgmma_bf16_rs_kmajor<BK>(s, q_big[j], db, j > 0);
        } else {
          wgmma_bf16_ss<BK>(s, wgmma_desc(q_wg + c * q_chunk + off, 16, 8 * CB, kLayout), db, j > 0);
        }
      }
    }
    wgmma_commit();
  };

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // The running maxima m are of the raw scores (of the capped ones, in
  // log2 units, with a softcap); exp2(s·sf − m·sf) is exp of the scaled
  // score's difference, one FFMA and one MUFU a key.  Masked keys are −inf.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  constexpr float kLog2e = 1.4426950408889634f;
  const float sf = SOFTCAP ? 1.f : sm_scale * kLog2e;
  const auto cap = [&](float x) {
    if constexpr (SOFTCAP) {
      return tanhf(x * sm_scale / softcap) * (softcap * kLog2e);
    } else {
      return x;
    }
  };

  // Online softmax of tile `it` on the accumulators: lane holds rows g and
  // g + 8 of its warp, keys k0 + 8n + 2t + {0, 1} in s[4n + {0, 1}] and
  // s[4n + {2, 3}].  Leaves the probabilities in s and returns the factor
  // the output's rows take.
  const auto softmax = [&](int it, float(&s)[BK / 2], float(&alpha)[2]) {
    const int k0 = tile_k0(it);
    float mx[2] = {-INFINITY, -INFINITY};
    // A tile that no mask reaches for any row of the slab takes no per-key
    // test (the flag as lane 0 has it: uniform across the warp).
    const bool edge = __shfl_sync(0xffffffffu,
                                  !slab_full || k0 + BK > len_end || (causal && k0 + BK - 1 > min_pos) ||
                                      (window > 0 && k0 <= max_pos - window),
                                  0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int kpos = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        bool ok = row_ok[r] && kpos < len_end;
        if (causal) ok = ok && kpos <= qpos[r];
        if (window > 0) ok = ok && (kpos > qpos[r] - window || kpos < prefix);
        s[i] = ok ? cap(s[i]) : -INFINITY;
        mx[r] = fmaxf(mx[r], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = cap(s[i]);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    }
    float m_sf[2];  // the new maxima times sf; 0 while a row has no valid key
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const bool none = m_new == -INFINITY;
      alpha[r] = none ? 1.f : exp2f((m[r] - m_new) * sf);
      m[r] = m_new;
      l[r] *= alpha[r];
      m_sf[r] = none ? 0.f : m_new * sf;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(fmaf(s[i], sf, -m_sf[r]));  // a masked key: exp2(−inf) = 0
      s[i] = p;
      l[r] += p;
    }
  };

  // P as the A operand of P·V: bf16, rounded as the Pallas body rounds it
  // (p.astype(v.dtype)), 16 keys a k-step; float32, split into TF32 big and
  // small, 8 keys a k-step, its columns t and t + 4 keys 2t and 2t + 1 (Vᵀ's order).
  constexpr int kKeyStep = L::kF32 ? 8 : 16;
  constexpr int kSteps = BK / kKeyStep;
  uint32_t p_big[kSteps][4], p_small[L::kF32 ? kSteps : 1][4];
  const auto make_p = [&](const float(&s)[BK / 2]) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if constexpr (L::kF32) {
        const float v[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], p_big[j][e], p_small[j][e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) p_big[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
      }
    }
  };
  // O += P·V of tile `it`, issued and committed.  Every k-step is issued,
  // masked keys with P = 0: a wgmma under a branch is serialized.
  const auto issue_pv = [&](int it) {
    const uint32_t base = stage_addr(it);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if constexpr (L::kF32) {
        constexpr uint32_t kVtLayout = desc_layout<L::kVtRowBytes>();
        const uint64_t db = wgmma_desc(base + 3 * L::kTileBytes + 32 * j, 16, 8 * L::kVtRowBytes, kVtLayout);
        const uint64_t ds = wgmma_desc(base + 4 * L::kTileBytes + 32 * j, 16, 8 * L::kVtRowBytes, kVtLayout);
        wgmma_tf32_rs<HD>(o, p_small[j], db, 1);
        wgmma_tf32_rs<HD>(o, p_big[j], ds, 1);
        wgmma_tf32_rs<HD>(o, p_big[j], db, 1);
      } else {
        // V's rows of 16 keys, transposed by the descriptor: 8 keys a step
        // of 8·CB bytes, head dims in CB-wide atoms BK·CB bytes apart.
        wgmma_bf16_rs<HD>(o, p_big[j], wgmma_desc(base + L::kTileBytes + 16 * j * CB, BK * CB, 8 * CB, kLayout),
                          1);
      }
    }
    wgmma_commit();
  };

  mbar_wait(q_ready, 0);
  if constexpr (L::kQRegs > 0) load_q();
  for (int it = 0; it < lo; ++it) {
    wait_tile(it);
    release(it);
  }
  if (lo < hi) {
    // The tiles overlap: tile it's Q·Kᵀ and tile it-1's P·V are in flight
    // while tile it-1's softmax ends and tile it's begins.
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float alpha[2];
    wait_tile(lo);
    wgmma_fence();
    issue_qk(lo, s);
    wgmma_wait<0>();
    pin_registers(s);
    softmax(lo, s, alpha);
    make_p(s);
    for (int it = lo + 1; it < hi; ++it) {
      wait_tile(it);
      wgmma_fence();
      issue_qk(it, s);
      issue_pv(it - 1);
      wgmma_wait<1>();  // Q·Kᵀ of tile it
      pin_registers(s);
      softmax(it, s, alpha);
      wgmma_wait<0>();  // P·V of tile it - 1
      pin_registers(o);
      release(it - 1);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      make_p(s);
    }
    wgmma_fence();
    issue_pv(hi - 1);
    wgmma_wait<0>();
    pin_registers(o);
    release(hi - 1);
  }
  for (int it = max(lo, hi); it < n_tiles; ++it) {
    wait_tile(it);
    release(it);
  }

  // Row sums over the row's four lanes; a row with no valid key has l = 0
  // and o = 0 and comes out as zeros.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // The backward's statistics: the log-sum-exp of each row's capped, scaled
  // and masked scores, in natural units (m is in log2 units); -inf for a
  // row with no valid key.
  if (lse != nullptr && t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row_ok[r])
        lse[(static_cast<size_t>(blockIdx.y) * H + qhead[r]) * S + qpos[r]] =
            l[r] > 0.f ? (m[r] * sf + log2f(l[r])) * kLn2 : -INFINITY;
    }
  }
  // The output: float32 rows straight from the registers, 8 bytes a lane;
  // bf16 rows into the slab's own rows of Q's shared memory, in the layout
  // the tensor map reads (rows past S or past the block's are not stored),
  // then one TMA store of the block's rows once every slab has written.
  // The card measures each faster than the other way.
  if constexpr (L::kF32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row_ok[r]) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        T* orow = out + ((static_cast<size_t>(b) * H + qhead[r]) * S + qpos[r]) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c)
          *reinterpret_cast<float2*>(orow + c * 8) = make_float2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const int col = 8 * c + 2 * t;
        const int chunk = col / L::kChunkElems;
        uint8_t* dst = q_s + chunk * q_chunk + swizzle<CB>(qrow[r] * CB + (col - chunk * L::kChunkElems) * 2);
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      }
    }
    fence_proxy_async();
    named_barrier(1, consumers);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_store_4d(&map_o, smem_addr(q_s + c * q_chunk), c * L::kChunkElems, q0, h0, b);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ================================================================ launch
// What a launch takes, whatever the route and instantiation.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* lse;
  int B, H, KV, S;
  Strides sq, sk, sv;
  int causal, window, prefix;
  float softcap;
  cudaStream_t stream;
};

// The launch plan (flash_attention.py's FlashPlan); the routes' numbers.
enum Route : int { kMmaSync = 0, kWgmma = 1 };
struct Plan {
  int route, warps, heads, positions, block_k, stages;
  long long shared_bytes;
};

template <typename T, int HD, int WARPS, int BK, bool SOFTCAP>
cudaError_t launch_mma_sync(const Args& a) {
  const size_t smem = Tile<T, HD, BK>::shared_bytes(WARPS);
  cudaError_t err = allow_shared_bytes(flash_attention_kernel<T, HD, WARPS, BK, SOFTCAP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.S + 16 * WARPS - 1) / (16 * WARPS));
  flash_attention_kernel<T, HD, WARPS, BK, SOFTCAP><<<grid, 32 * WARPS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, static_cast<T*>(a.out), a.lse, a.H, a.KV, a.S, a.sq, a.sk, a.sv, a.causal, a.window,
      a.prefix, 1.f / std::sqrt(static_cast<float>(HD)), a.softcap);
  return cudaGetLastError();
}

constexpr int kMmaSyncBlockK = 16;

// The mma.sync route: 2 warps (32 query rows a tile, for the smallest
// buckets) or 4 (64 rows), 16 keys a tile (at head size 192 a lane holds
// 96 output accumulators whatever the rows).
template <typename T, int HD, bool SOFTCAP>
cudaError_t dispatch_mma_sync(const Args& a, const Plan& p) {
  using L = Tile<T, HD, kMmaSyncBlockK>;
  if ((p.warps != 2 && p.warps != 4) || p.block_k != kMmaSyncBlockK || p.stages != kStages ||
      p.shared_bytes != static_cast<long long>(L::shared_bytes(p.warps)))
    return cudaErrorInvalidValue;
  return p.warps == 2 ? launch_mma_sync<T, HD, 2, kMmaSyncBlockK, SOFTCAP>(a)
                      : launch_mma_sync<T, HD, 4, kMmaSyncBlockK, SOFTCAP>(a);
}

// The 4-dimensional map (hd, S, heads, B) of a (B, heads, S, hd) tensor
// with element strides `st`, read in boxes of (inner, rows, box_heads, 1)
// with the `swz` swizzle.  A dimension of one element takes the dense
// stride (its stride is never stepped).
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const void* base, int B, int NH, int S, int hd,
                       const Strides& st, int inner, int rows, int box_heads, CUtensorMapSwizzle swz) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(NH), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  strides[0] = S > 1 ? st.s * es : hd * es;
  strides[1] = NH > 1 ? st.h * es : strides[0] * S;
  strides[2] = B > 1 ? st.b * es : strides[1] * NH;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(inner), static_cast<cuuint32_t>(rows),
                             static_cast<cuuint32_t>(box_heads), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(base), dims, strides, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD, bool SOFTCAP>
cudaError_t launch_wgmma(const Args& a, const Plan& p) {
  using L = Hop<T, HD>;
  const int group = a.H / a.KV;
  // The consumers hold two stages at once (one tile's P·V beside the next
  // one's Q·Kᵀ): a ring of at least two.
  if (p.block_k != L::kBlockK || p.warps < 1 || p.warps > kMaxWarpgroups || p.stages < 2 ||
      p.stages > kMaxStages || p.heads < 1 || group % p.heads != 0 || p.positions < 1 ||
      p.heads * p.positions > 64 * p.warps || p.heads > 256 || p.positions > 256 ||
      p.shared_bytes != static_cast<long long>(L::shared_bytes(p.warps, p.stages)) ||
      p.shared_bytes > kMaxShared)
    return cudaErrorInvalidValue;
  constexpr CUtensorMapSwizzle swz = tma_swizzle<L::kChunkBytes>();
  const Strides so{static_cast<long long>(a.H) * a.S * HD, static_cast<long long>(a.S) * HD, HD};
  CUtensorMap mq, mk, mv, mo{};  // mo: the bf16 output's (float32 rows are stored directly)
  cudaError_t err = encode_map<T>(&mq, a.q, a.B, a.H, a.S, HD, a.sq, L::kChunkElems, p.positions,
                                  p.heads, swz);
  if (err == cudaSuccess)
    err = encode_map<T>(&mk, a.k, a.B, a.KV, a.S, HD, a.sk, L::kChunkElems, L::kBlockK, 1, swz);
  if (err == cudaSuccess)
    err = encode_map<T>(&mv, a.v, a.B, a.KV, a.S, HD, a.sv, L::kChunkElems, L::kBlockK, 1, swz);
  if (err == cudaSuccess && !L::kF32)
    err = encode_map<T>(&mo, a.out, a.B, a.H, a.S, HD, so, L::kChunkElems, p.positions, p.heads, swz);
  if (err != cudaSuccess) return err;
  const auto kernel = flash_attention_kernel_wgmma<T, HD, SOFTCAP>;
  err = allow_shared_bytes(kernel, static_cast<size_t>(p.shared_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.KV * (group / p.heads), a.B, (a.S + p.positions - 1) / p.positions);
  kernel<<<grid, 128 * p.warps + L::kProducerThreads, static_cast<size_t>(p.shared_bytes), a.stream>>>(
      mq, mk, mv, mo, a.lengths, static_cast<T*>(a.out), a.lse, a.H, a.S, group, p.heads, p.positions, p.warps, p.stages,
      a.causal, a.window, a.prefix, 1.f / std::sqrt(static_cast<float>(HD)), a.softcap);
  return cudaGetLastError();
}

template <typename T, int HD, bool SOFTCAP>
cudaError_t dispatch_route(const Args& a, const Plan& p) {
  // Each route is built only where the plan takes it: mma.sync for float32
  // at head size 192, wgmma at every other head size and type.
  if constexpr (sizeof(T) == 4 && HD == 192) {
    if (p.route == kMmaSync) return dispatch_mma_sync<T, HD, SOFTCAP>(a, p);
  } else {
    if (p.route == kWgmma) return launch_wgmma<T, HD, SOFTCAP>(a, p);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool SOFTCAP>
cudaError_t dispatch_hd(int hd, const Args& a, const Plan& p) {
  switch (hd) {
    case 16:
      return dispatch_route<T, 16, SOFTCAP>(a, p);
    case 32:
      return dispatch_route<T, 32, SOFTCAP>(a, p);
    case 64:
      return dispatch_route<T, 64, SOFTCAP>(a, p);
    case 128:
      return dispatch_route<T, 128, SOFTCAP>(a, p);
    case 192:
      return dispatch_route<T, 192, SOFTCAP>(a, p);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_softcap(int hd, const Args& a, const Plan& p) {
  return a.softcap > 0.f ? dispatch_hd<T, true>(hd, a, p) : dispatch_hd<T, false>(hd, a, p);
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, S, hd); k, v: (B, KV, S, hd), of the storage type `dtype`, with
// the head dimension contiguous and the other strides given in elements;
// every row must start on a 16-byte boundary (cp.async and TMA); lengths:
// (B,) int32 or null (every row has S keys); out: (B, H, S, hd),
// contiguous; lse: (B, H, S) float32, contiguous, or null (the serving
// path: not written), the log-sum-exp of each row's scores that the
// backward reads.  With window > 0 every query also sees the keys below
// `prefix` (>= 0; 0: none).  hd must be 16, 32, 64, 128 or 192; softcap > 0 caps the
// scaled scores at ±softcap (tanh), 0 leaves them.  The plan
// (flash_attention.py's flash_plan): route (0 mma.sync, 1 wgmma), warps
// (mma.sync: warps a block; wgmma: consumer warpgroups), heads and
// positions (wgmma: a block's query heads and positions), block_k (keys a
// tile), stages, and the dynamic shared bytes; a plan that its route does
// not fit is refused.  Launches on `stream` and returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* lengths, void* out, float* lse, int dtype,
                                      int B, int H, int KV, int S, int hd, long long sqb,
                                      long long sqh, long long sqs, long long skb, long long skh,
                                      long long sks, long long svb, long long svh,
                                      long long svs, int causal, int window, int prefix, float softcap,
                                      int route, int warps, int heads, int positions, int block_k,
                                      int stages, long long shared_bytes, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || prefix < 0 || !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, lengths, out, lse, B, H, KV, S, Strides{sqb, sqh, sqs}, Strides{skb, skh, sks},
               Strides{svb, svh, svs}, causal, window, prefix, softcap, static_cast<cudaStream_t>(stream)};
  const Plan p{route, warps, heads, positions, block_k, stages, shared_bytes};
  if (dtype == kFloat32) return dispatch_softcap<float>(hd, a, p);
  if (dtype == kBFloat16) return dispatch_softcap<__nv_bfloat16>(hd, a, p);
  return cudaErrorInvalidValue;
}
