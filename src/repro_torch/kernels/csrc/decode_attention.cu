// Decode attention for Hopper (sm_90a): one query token per row against a
// KV cache, grouped-query heads sharing their KV head's cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention_pallas (body `_kernel`).  That kernel keeps a
// KV group's (g × hd) tile of query heads resident, feeds the group's
// product to the MXU, and carries the online-softmax state (m, l, acc)
// from one cache block to the next along a sequential grid axis, one
// program per (batch row, KV head).  Blocks on Hopper run in no order, so
// here a block owns a (batch row, KV head) and walks its cache itself;
// where B·KV blocks would leave the card's 132 SMs under-filled (16 blocks
// at GLM-4-9B's batch of 8) the cache is split along S as well
// (flash-decoding): a (batch row, KV head) gets a thread-block cluster of
// up to 8 blocks, each taking a share of its valid keys, and the
// blocks merge their states through distributed shared memory, each
// writing a slice of the output: no scratch buffer and no second launch.
//
// What bounds it on the H100: bytes.  Each cache element is read once and
// feeds 2·g multiply-adds per query-head group: g/2 flops a byte over a
// float32 cache, g over a bfloat16 one.  The card's float32 SIMT ridge is
// ~20 flops a byte, so a group of up to 4 stays on the SIMT cores and a
// larger one goes to the tensor cores, where the ridge is far away.  The
// launch plan (route, warps, stages, cluster, shared bytes) is made on the
// host by kernels/decode_attention.py::decode_plan and handed in; the
// launcher checks it against what each route needs, its shared bytes
// equal to this file's layout (*_shared_bytes), so that a layout changed
// on one side only is refused at the first launch.  Three routes:
//
// - SIMT, groups of 1 to 4 (the group rounded up to G = 1, 2 or 4 heads,
//   one warp a head): a block stages several 32-key tiles at once, one per
//   slot of G warps, with 16-byte cp.async, and walks its share of the
//   cache in such steps; one lane owns one key, so a tile's scores take
//   one pass and two warp reductions per head; P·V deals the head's dims
//   to the lanes.  A small group has little work a tile, so its block
//   holds up to 8 tile slots (orloj_gpt's step: 96 blocks of 8 slots, one
//   per row and KV head).
// - Tensor cores, groups above 4: the group's query heads are the M rows
//   of mma.sync products, padded to a multiple of 16 (groups 5 to 16 one
//   M tile, Granite-34B's 48 three), so every group reads its cache once.
//   Each warp owns one M tile and 16 keys of a stage: scores Q_g·Kᵀ (N =
//   16 keys, K = hd), the online softmax on the accumulator fragments in
//   float32, then P·V (N = hd, K = 16 keys).  A stage holds 16 keys for
//   each key warp of the block; stages go through a ring of up to 4 slots
//   filled by cp.async, so a stage's copy overlaps the products of the one
//   before.  Float32 accuracy: over a float32 cache, TF32 m16n8k8 products
//   as in flash_attention.cu, each operand x split into big = tf32(x) and
//   small = tf32(x - big) and each product big·big + big·small + small·big
//   (three passes); over a bf16 cache, bf16 m16n8k16 products with
//   ldmatrix operands: the cache's values are bf16 already, so only the
//   float32 A operand (q, then P) is split, into three bf16 parts (24
//   bits), and bf16 queries take one part (P rounded to bf16, as the plain
//   version rounds it).  The queries are split once, into shared memory,
//   for the whole walk.  Each pass or part has its own accumulators (and
//   even and odd k-steps too, where one would chain), so that consecutive
//   products never wait on each other.  Every fragment load is free of
//   bank conflicts (padded rows).  The plan gives a block enough keys for
//   its warps and covers the SMs once; where the card cannot hold all the
//   clusters at one block an SM (it holds only 15 clusters of 8: a
//   cluster's blocks share a GPC), it sizes blocks so that two fit an SM.
// - Head size 512 (xLSTM-1.3B's token path: one query head a KV head,
//   float32, no softcap): a block of several warps; a lane owns 16 of the
//   512 dims (four float4), a score is a warp reduction, and each warp
//   walks its own keys (2 a stage) through its own cp.async ring of up to
//   4 stages.  A lane reads back only the bytes it copied itself, so the
//   ring needs no barrier; several blocks share an SM.
//
// Every route: tiles past valid_len[b] are never loaded, so cache slots
// that were never written are never read (a block with none only waits for
// the merge); the ragged tail of S is masked in the kernel, so any cache
// length is served; valid_len == 0 gives zeros, never NaN.  The order of
// every sum is fixed and there are no atomics: two calls give the same
// bits.  The launch allocates nothing and does not synchronise, so a CUDA
// graph captures it.
//
// Storage types: q and the output share one type, the caches may have
// another.  The models' decode step attends float32 queries over a
// bfloat16 cache (the reference's default cache type, read back to
// float32); the bf16 tiles are staged as they are, half the bytes of a
// float32 cache.  A logit softcap (tanh(s / cap) · cap on the scaled
// scores, before the mask) is a template flag, so that the instantiations
// without it are the code they were.

#include <cooperative_groups.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;          // blocks of a cluster (the portable limit)
constexpr size_t kMaxShared = 232448;   // shared memory a block can use
constexpr float kLog2e = 1.4426950408889634f;

// Routes, as decode_plan numbers them.
enum Route : int { kSimt = 0, kTensorCores = 1, kWide = 2 };

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

// Waits until at most `n` committed cp.async groups of this thread are in
// flight (n = 0 .. 3: the ring's stages ahead, less one, or all of them).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) {
    cp_async_wait<0>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else if (n == 2) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<3>();
  }
}

// ============================================================ SIMT route
constexpr int kTile = 32;                      // keys of a tile, one per lane of a warp
constexpr int kMaxWarps = 8;

// Rows of a staged tile, padded by 16 bytes so that a lane reading its own
// key's row in 16-byte pieces meets no bank conflict.  Shared memory at hd
// 192 (the most): the static q_s and acc_s hold G·HD floats each (3 KB at
// G = 4); a float32 tile slot is 2·32·196·4 = 49 KB, so a small group's
// block stages 3 slots (147 KB) and a group of 4 one.
template <typename T, int HD>
constexpr int kRowLen = HD + 16 / static_cast<int>(sizeof(T));

// Dynamic shared memory of a block with `slots` tile slots: the staged K and
// V tiles, which the warps' states reuse once the walk is over.
template <typename T, int HD, int G>
constexpr size_t simt_shared_bytes(int slots) {
  const size_t stage = static_cast<size_t>(slots) * 2 * kTile * kRowLen<T, HD> * sizeof(T);
  const size_t states = static_cast<size_t>(slots) * G * HD * sizeof(float);
  return stage > states ? stage : states;
}

// One cluster of gridDim.x blocks per (KV head, batch row); each block has
// `slots` slots of G warps.  Warp (slot, w) scores its slot's tile against
// head w (one lane per key) and folds it into its online state (m, l, acc).
// Block r of the cluster walks steps r, r + gridDim.x, ... of `slots`
// tiles each.
template <typename TQ, typename T, int HD, int G, bool SOFTCAP>
__global__ void __launch_bounds__(32 * kMaxWarps)
    decode_simt_kernel(const TQ* __restrict__ q,       // (B, H, HD)
                       const T* __restrict__ k_cache,  // (B, KV, S, HD)
                       const T* __restrict__ v_cache,  // (B, KV, S, HD)
                       const int* __restrict__ valid_len,  // (B,)
                       TQ* __restrict__ out,           // (B, H, HD)
                       int H, int KV, int S, float sm_scale, float softcap) {
  // P·V: LPK lanes share a key's row, each owning DPL output dims, and a
  // warp step takes KPS keys.  At hd >= 32 the whole warp reads one row
  // (DPL = hd / 32: 1 at hd 32 ... 6 at hd 192); at hd 16 each half-warp
  // takes its own key, one dim a lane, and the halves' sums are added
  // once the walk is over (both saw the same running maxima).
  constexpr int LPK = HD >= 32 ? 32 : HD;
  constexpr int KPS = 32 / LPK;
  constexpr int DPL = HD / LPK;
  constexpr int LD = kRowLen<T, HD>;
  constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));  // elements per cp.async
  constexpr int CPR = HD / CHUNK;                           // cp.async per row
  extern __shared__ float4 dyn4[];
  __shared__ __align__(16) float q_s[G][HD];
  __shared__ __align__(16) float acc_s[G][HD];  // the block's state, read by the cluster
  __shared__ float m_s[G], l_s[G];
  __shared__ float wm_s[kMaxWarps][G], wl_s[kMaxWarps][G];  // the slots' (m, l)

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans the x dimension of the grid
  const int blocks = gridDim.x;
  const int c = blockIdx.y;  // KV head
  const int b = blockIdx.z;  // batch row
  const int g = H / KV;      // <= G
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slots = (blockDim.x >> 5) / G;
  const int slot = warp / G;
  const int h0 = warp % G;              // this warp's head
  const int dim0 = (lane % LPK) * DPL;  // this lane's first output dim
  const int sub = lane / LPK;           // which of a step's KPS keys this lane takes
  const bool writer = sub == 0;         // lanes that hold the summed output dims
  const int step_keys = slots * kTile;
  const int n = min(max(valid_len[b], 0), S);
  const size_t kv_base = (static_cast<size_t>(b) * KV + c) * static_cast<size_t>(S) * HD;
  const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(c) * g) * HD;
  T* k_t = reinterpret_cast<T*>(dyn4) + slot * 2 * kTile * LD;  // this slot's tile
  T* v_t = k_t + kTile * LD;
  float* state = reinterpret_cast<float*>(dyn4);  // [slots][G][HD], once the walk is over

  for (int i = threadIdx.x; i < G * HD; i += blockDim.x)
    q_s[i / HD][i % HD] = i / HD < g ? to_float(q[q_base + i]) : 0.f;

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  for (int s0 = rank * step_keys; s0 < n; s0 += blocks * step_keys) {
    const int rows = min(step_keys, n - s0);
    __syncthreads();  // q_s is written, and the previous step is consumed
    // The step's rows, all in flight at once; rows past valid_len are zeros.
    for (int i = threadIdx.x; i < step_keys * CPR; i += blockDim.x) {
      const int r = i / CPR;
      const int col = (i - r * CPR) * CHUNK;
      const bool in = r < rows;
      const size_t off = kv_base + (in ? static_cast<size_t>(s0 + r) * HD + col : 0);
      T* dst = reinterpret_cast<T*>(dyn4) + (r / kTile) * 2 * kTile * LD + (r % kTile) * LD + col;
      cp_async16(dst, k_cache + off, in);
      cp_async16(dst + kTile * LD, v_cache + off, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int nt = min(kTile, rows - slot * kTile);  // keys of this slot's tile
    if (nt <= 0) continue;
    // This lane's key: its score against this warp's head.
    float s = 0.f;
    const T* kr = k_t + lane * LD;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 kx = load4(kr + d);
      const float4 qx = *reinterpret_cast<const float4*>(&q_s[h0][d]);
      s = fmaf(qx.x, kx.x, s);
      s = fmaf(qx.y, kx.y, s);
      s = fmaf(qx.z, kx.z, s);
      s = fmaf(qx.w, kx.w, s);
    }
    float sj = s * sm_scale;
    if constexpr (SOFTCAP) sj = tanhf(sj / softcap) * softcap;
    sj = lane < nt ? sj : kNegInf;
    const float m_new = fmaxf(m, warp_max(sj));
    const float p = lane < nt ? expf(sj - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
    // acc += p·V: key u's probability comes from lane u; each lane reads
    // its DPL dims of V row u.  With KPS = 2 the last step may take row
    // nt (< 32), which is zeros with p = 0.
#pragma unroll 8
    for (int u0 = 0; u0 < nt; u0 += KPS) {
      const int u = u0 + sub;
      const T* vr = v_t + u * LD + dim0;
      float vx[DPL];
      if constexpr (DPL % 4 == 0) {  // hd 128: 4 dims a lane
#pragma unroll
        for (int e = 0; e < DPL; e += 4) {
          const float4 v4 = load4(vr + e);
          vx[e] = v4.x;
          vx[e + 1] = v4.y;
          vx[e + 2] = v4.z;
          vx[e + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) vx[e] = to_float(vr[e]);
      }
      const float pu = __shfl_sync(0xffffffffu, p, u);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] = fmaf(pu, vx[e], acc[e]);
    }
  }

  if constexpr (KPS > 1) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], LPK);
  }

  // Merge the slots' states in shared memory.  A slot that saw no key has
  // m = -1e30 and l = acc = 0, so it adds nothing; valid_len == 0 leaves
  // every row 0.  A block of one slot has nothing to merge: its warps'
  // states are the block's.
  if (slots == 1 && h0 < g && writer) {
    if (blocks == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int e = 0; e < DPL; ++e) out[q_base + h0 * HD + dim0 + e] = from_float<TQ>(acc[e] * inv);
    } else {
      if (lane == 0) {
        m_s[h0] = m;
        l_s[h0] = l;
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc_s[h0][dim0 + e] = acc[e];
    }
  }
  __syncthreads();  // the staged tiles and q_s are consumed: `state` reuses the tiles
  if (slots > 1) {
    if (lane == 0) {
      wm_s[slot][h0] = m;
      wl_s[slot][h0] = l;
    }
    if (writer) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) state[(slot * G + h0) * HD + dim0 + e] = acc[e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < g * HD; i += blockDim.x) {
      const int j = i / HD;
      const int d = i % HD;
      float mx = kNegInf, num = 0.f, den = 0.f;
      for (int w = 0; w < slots; ++w) {
        const float mw = wm_s[w][j];
        const float m_new = fmaxf(mx, mw);
        const float a = expf(mx - m_new), f = expf(mw - m_new);
        num = a * num + f * state[(w * G + j) * HD + d];
        den = a * den + f * wl_s[w][j];
        mx = m_new;
      }
      if (blocks == 1) {
        out[q_base + i] = from_float<TQ>(num / fmaxf(den, 1e-30f));
      } else {
        acc_s[j][d] = num;
        if (d == 0) {
          m_s[j] = mx;
          l_s[j] = den;
        }
      }
    }
  }
  if (blocks == 1) return;

  // Merge the cluster's blocks: block `rank` writes every blocks-th output
  // element of the group.
  cluster.sync();  // every block's state is in its shared memory
  for (int i = rank * blockDim.x + threadIdx.x; i < g * HD; i += blocks * blockDim.x) {
    const int j = i / HD;
    const int d = i % HD;
    float mx = kNegInf, num = 0.f, den = 0.f;
    for (int r = 0; r < blocks; ++r) {
      const float mr = *cluster.map_shared_rank(&m_s[j], r);
      const float lr = *cluster.map_shared_rank(&l_s[j], r);
      const float ar = *cluster.map_shared_rank(&acc_s[j][d], r);
      const float m_new = fmaxf(mx, mr);
      const float a = expf(mx - m_new), f = expf(mr - m_new);
      num = a * num + f * ar;
      den = a * den + f * lr;
      mx = m_new;
    }
    out[q_base + i] = from_float<TQ>(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();  // no block reuses or releases its state while it is read
}

// ================================================ the tensor-core and wide routes
// Their dynamic shared memory, in floats, each region a multiple of 16
// bytes: the block's merged state acc_s [rows][HD], m_s [rows], l_s [rows]
// (read by the cluster), the warps' (m, l) [parts][rows] each, then the
// route's own regions (see tc_shared_bytes and wide_shared_bytes).
__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr size_t merge_floats(int rows, int hd, int parts) {
  return static_cast<size_t>(rows) * hd + 2 * pad4(rows) + 2 * pad4(parts * rows);
}

// The last step of both routes: `parts` warp states of `rows` rows each
// (m in log2 units, l, acc [parts][rows][HD] in `state`) merged into the
// block's for the group's `heads` rows, then across the cluster; the
// output rows of the group are written from `out_base`.  Every thread of
// the block calls it once the walk is over and `state` is written.  A
// thread takes 4 adjacent dims of a row and reads all the states it sums
// at once (float4, the partners' unrolled), then adds them in a fixed
// order: the largest m first, then the parts in their order.
constexpr int kMaxParts = 8;  // warps a block merges

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&a);
  v.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void fma4(float4& acc, float f, const float4& x) {
  acc.x = fmaf(f, x.x, acc.x);
  acc.y = fmaf(f, x.y, acc.y);
  acc.z = fmaf(f, x.z, acc.z);
  acc.w = fmaf(f, x.w, acc.w);
}
__device__ __forceinline__ float4 scale4(const float4& x, float f) {
  return make_float4(x.x * f, x.y * f, x.z * f, x.w * f);
}

template <typename TQ, int HD>
__device__ void merge_and_write(const float* state, const float* wm, const float* wl, float* acc_s,
                                float* m_s, float* l_s, int rows, int parts, int heads,
                                TQ* out_base) {
  constexpr int C = HD / 4;  // float4 pieces of a row
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;
  const int blocks = gridDim.x;
  for (int i = threadIdx.x; i < heads * C; i += blockDim.x) {
    const int j = i / C;
    const int d = (i - j * C) * 4;
    float mw[kMaxParts], lw[kMaxParts];
    float4 aw[kMaxParts];
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kMaxParts; ++w) {
      if (w < parts) {
        mw[w] = wm[w * rows + j];
        lw[w] = wl[w * rows + j];
        aw[w] = *reinterpret_cast<const float4*>(state + (static_cast<size_t>(w) * rows + j) * HD + d);
        mx = fmaxf(mx, mw[w]);
      }
    }
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxParts; ++w) {
      if (w < parts) {
        const float f = exp2f(mw[w] - mx);
        fma4(num, f, aw[w]);
        den = fmaf(f, lw[w], den);
      }
    }
    if (blocks == 1) {
      store4(out_base + j * HD + d, scale4(num, 1.f / fmaxf(den, 1e-30f)));
    } else {
      store4(acc_s + j * HD + d, num);
      if (d == 0) {
        m_s[j] = mx;
        l_s[j] = den;
      }
    }
  }
  if (blocks == 1) return;
  cluster.sync();  // every block's state is in its shared memory
  for (int i = rank * blockDim.x + threadIdx.x; i < heads * C; i += blocks * blockDim.x) {
    const int j = i / C;
    const int d = (i - j * C) * 4;
    float mr[kMaxCluster], lr[kMaxCluster];
    float4 ar[kMaxCluster];
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < blocks) {
        mr[r] = *cluster.map_shared_rank(m_s + j, r);
        lr[r] = *cluster.map_shared_rank(l_s + j, r);
        ar[r] = *cluster.map_shared_rank(reinterpret_cast<float4*>(acc_s + j * HD + d), r);
        mx = fmaxf(mx, mr[r]);
      }
    }
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < blocks) {
        const float f = exp2f(mr[r] - mx);
        fma4(num, f, ar[r]);
        den = fmaf(f, lr[r], den);
      }
    }
    store4(out_base + j * HD + d, scale4(num, 1.f / fmaxf(den, 1e-30f)));
  }
  cluster.sync();  // no block reuses or releases its state while it is read
}

// This block's share of the valid keys [0, n): an equal part of them per
// block of the cluster.
__device__ __forceinline__ void block_keys(int n, int& start, int& end) {
  const int per = (n + gridDim.x - 1) / gridDim.x;
  start = min(n, static_cast<int>(blockIdx.x) * per);
  end = min(n, start + per);
}

// ------------------------------------------------------------ tensor cores
constexpr int kTcKeys = 16;  // keys of a warp's share of a stage: two 8-key column blocks
constexpr int kTcMaxWarps = 8;

// How the route multiplies, by cache type.  A float32 cache takes TF32
// products m16n8k8 (the queries are float32), each operand split into its
// big and small TF32 parts, three passes a product.  A bfloat16 cache takes
// bf16 products m16n8k16 with ldmatrix operands: the cache's values are
// bf16 already, so the A operand alone (q, then P) is split, into NP bf16
// parts (three, 24 bits, for float32 queries; one for bf16 queries, whose
// P is rounded to bf16 as the plain version rounds it).
template <typename TQ, typename T>
struct TcKind {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kParts = kF32 ? 2 : (std::is_same_v<TQ, float> ? 3 : 1);
  using Part = std::conditional_t<kF32, float, __nv_bfloat16>;  // a query part's storage
};

// Shared-memory row lengths (elements).  TF32: Q and K are read as 8-byte
// pairs by rows g = 0..7 and pair index t = 0..3, half a warp at a time, so
// a row stride of 8 words mod 32 keeps the four rows of a half on distinct
// banks; V as single elements of rows 2t and 2t + 1, 2·stride = 8 words mod
// 32.  bf16: ldmatrix reads 8 rows of 16 bytes a matrix, and a stride of an
// odd number of 16-byte units keeps them on distinct banks.  Every row is a
// multiple of 16 bytes.
template <int HD>
constexpr int kTcQS = HD + 8;
template <typename T, int HD>
constexpr int kTcKS = HD + 8;
template <typename T, int HD>
constexpr int kTcVS = sizeof(T) == 4 ? HD + 4 : HD + 8;

// The tensor-core route's dynamic shared memory for `m_tiles` M tiles,
// `key_warps` warps a tile and a ring of `stages` stages: the merge's
// regions, the split queries, then the ring of K/V stages, which the warps'
// states reuse once the walk is over.  decode_plan computes the same number.
template <typename TQ, typename T, int HD>
constexpr size_t tc_shared_bytes(int m_tiles, int key_warps, int stages) {
  using K = TcKind<TQ, T>;
  const int rows = 16 * m_tiles;
  const size_t q = static_cast<size_t>(K::kParts) * rows * kTcQS<HD> * sizeof(typename K::Part);
  const size_t ring = static_cast<size_t>(stages) * kTcKeys * key_warps *
                      (kTcKS<T, HD> + kTcVS<T, HD>) * sizeof(T);
  const size_t states = static_cast<size_t>(key_warps) * rows * HD * sizeof(float);
  return merge_floats(rows, HD, key_warps) * sizeof(float) + q + (ring > states ? ring : states);
}

// x as the sum of N bf16 values, the largest first, each the nearest to
// what the ones before it leave: 8 significant bits a part, 24 for three.
template <int N>
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16 (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    part[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(part[i]);
  }
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 matrices of 16-bit values from shared memory, as mma fragments;
// lane l gives the address of row l % 8 of matrix l / 8.  `trans` hands
// each lane the transposed elements (a B operand stored row-major).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// One cluster of gridDim.x blocks per (KV head, batch row); a block has
// m_tiles · key_warps warps: warp w owns M tile w % m_tiles (query heads
// 16·(w % m_tiles) ...) and keys [16·(w / m_tiles), +16) of each stage.
template <typename TQ, typename T, int HD, bool SOFTCAP>
__global__ void __launch_bounds__(32 * kTcMaxWarps)
    decode_tc_kernel(const TQ* __restrict__ q,       // (B, H, HD)
                     const T* __restrict__ k_cache,  // (B, KV, S, HD)
                     const T* __restrict__ v_cache,  // (B, KV, S, HD)
                     const int* __restrict__ valid_len,  // (B,)
                     TQ* __restrict__ out,           // (B, H, HD)
                     int H, int KV, int S, float sm_scale, float softcap, int m_tiles,
                     int stages) {
  using Kind = TcKind<TQ, T>;
  using Part = typename Kind::Part;
  constexpr bool kF32 = Kind::kF32;
  constexpr int NP = Kind::kParts;
  constexpr int QS = kTcQS<HD>;
  constexpr int KS = kTcKS<T, HD>;
  constexpr int VS = kTcVS<T, HD>;
  constexpr int NO = HD / 8;  // 8-wide output column blocks
  constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = HD / CHUNK;
  extern __shared__ float4 dyn4[];

  const int rows = 16 * m_tiles;
  const int warps = blockDim.x >> 5;
  const int key_warps = warps / m_tiles;
  const int stage_keys = kTcKeys * key_warps;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mt = warp % m_tiles;
  const int kw = warp / m_tiles;
  const int gr = lane >> 2;  // fragment row group
  const int t = lane & 3;    // fragment column pair

  float* acc_s = reinterpret_cast<float*>(dyn4);
  float* m_s = acc_s + rows * HD;
  float* l_s = m_s + pad4(rows);
  float* wm = l_s + pad4(rows);
  float* wl = wm + pad4(key_warps * rows);
  Part* qp = reinterpret_cast<Part*>(wl + pad4(key_warps * rows));  // [NP][rows][QS]
  T* ring = reinterpret_cast<T*>(qp + NP * rows * QS);
  float* state = reinterpret_cast<float*>(ring);  // [key_warps][rows][HD], once the walk is over
  const int stage_elems = stage_keys * (KS + VS);

  const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(c) * g) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * KV + c) * static_cast<size_t>(S) * HD;
  const int n = min(max(valid_len[b], 0), S);
  int start, end;
  block_keys(n, start, end);
  const int nsteps = (end - start + stage_keys - 1) / stage_keys;

  // The stage's K rows, then its V rows; rows past this block's keys are zeros.
  const auto load_stage = [&](int step) {
    T* ks = ring + (step % stages) * stage_elems;
    T* vs = ks + stage_keys * KS;
    const int k0 = start + step * stage_keys;
    for (int i = tid; i < stage_keys * CPR; i += blockDim.x) {
      const int r = i / CPR;
      const int col = (i - r * CPR) * CHUNK;
      const bool in = k0 + r < end;
      const size_t off = kv_base + (in ? static_cast<size_t>(k0 + r) * HD + col : 0);
      cp_async16(ks + r * KS + col, k_cache + off, in);
      cp_async16(vs + r * VS + col, v_cache + off, in);
    }
  };
  // The group's queries go into acc_s as they are stored (rows past the
  // group zero-filled), then the ring's first stages; the queries are
  // split once they have landed.
  {
    constexpr int QCHUNK = 16 / static_cast<int>(sizeof(TQ));
    TQ* q_raw = reinterpret_cast<TQ*>(acc_s);
    for (int i = tid; i < rows * HD / QCHUNK; i += blockDim.x) {
      const int e = i * QCHUNK;
      const bool in = e < g * HD;
      cp_async16(q_raw + e, q + q_base + (in ? e : 0), in);
    }
    cp_async_commit();
  }
  const int ahead = max(1, stages - 1);
  for (int p = 0; p < ahead; ++p) {
    if (p < nsteps) load_stage(p);
    cp_async_commit();
  }
  cp_async_wait_upto(ahead);  // the queries' group
  __syncthreads();
  for (int i = tid; i < rows * HD / 4; i += blockDim.x) {
    const int r = (4 * i) / HD;
    const int d = 4 * i - r * HD;
    const float4 x4 = load4(reinterpret_cast<const TQ*>(acc_s) + 4 * i);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    if constexpr (kF32) {
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
      *reinterpret_cast<uint4*>(qp + r * QS + d) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(qp + (rows + r) * QS + d) = make_uint4(small[0], small[1], small[2], small[3]);
    } else {
      __nv_bfloat16 part[4][NP];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_bf16<NP>(x[e], part[e]);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        *reinterpret_cast<uint2*>(qp + (p * rows + r) * QS + d) =
            make_uint2(pack2(part[0][p], part[1][p]), pack2(part[2][p], part[3][p]));
    }
  }

  float o[NO][4];
#pragma unroll
  for (int nb = 0; nb < NO; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const float scale2 = sm_scale * kLog2e;
  const auto to_log2 = [&](float x) {
    if constexpr (SOFTCAP) {
      return tanhf(x * sm_scale / softcap) * (softcap * kLog2e);
    } else {
      return x * scale2;
    }
  };
  const Part* qw = qp + (mt * 16) * QS;  // this warp's M tile, part 0

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait_upto(ahead - 1);  // this thread's copies of the step landed
    __syncthreads();                // everyone's; the previous step is consumed; q is split
    if (step + ahead < nsteps) load_stage(step + ahead);
    cp_async_commit();

    const int key0 = start + step * stage_keys + kw * kTcKeys;  // this warp's first key
    if (key0 >= end) continue;
    const T* ks = ring + (step % stages) * stage_elems + kw * kTcKeys * KS;
    const T* vs = ring + (step % stages) * stage_elems + stage_keys * KS + kw * kTcKeys * VS;

    // ---- S = Q·Kᵀ for the warp's two 8-key blocks (rows past the block's
    // keys hold zeros and are masked below).  Each pass or part has its own
    // accumulators, and the TF32 passes of even and of odd k-steps too, so
    // that consecutive products never wait on each other.
    float sc[2][4];
    if constexpr (kF32) {
      // k-step of 8 head dims; fragment column t holds dim 2t and column
      // t + 4 dim 2t + 1 of the step, in Q and in K alike.
      float s[3][2][2][4];  // [pass][parity][key block][fragment]
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) s[i][j][nb][0] = s[i][j][nb][1] = s[i][j][nb][2] = s[i][j][nb][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int par = kk & 1;
        uint32_t ab[4], as[4];
        {
          const float2 qa = *reinterpret_cast<const float2*>(qw + gr * QS + kk * 8 + 2 * t);
          const float2 qc = *reinterpret_cast<const float2*>(qw + (gr + 8) * QS + kk * 8 + 2 * t);
          const float2 sa = *reinterpret_cast<const float2*>(qw + (rows + gr) * QS + kk * 8 + 2 * t);
          const float2 sb = *reinterpret_cast<const float2*>(qw + (rows + gr + 8) * QS + kk * 8 + 2 * t);
          ab[0] = __float_as_uint(qa.x), ab[1] = __float_as_uint(qc.x);
          ab[2] = __float_as_uint(qa.y), ab[3] = __float_as_uint(qc.y);
          as[0] = __float_as_uint(sa.x), as[1] = __float_as_uint(sb.x);
          as[2] = __float_as_uint(sa.y), as[3] = __float_as_uint(sb.y);
        }
        uint32_t bb[2][2], bs[2][2];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const float2 kx = *reinterpret_cast<const float2*>(ks + (nb * 8 + gr) * KS + kk * 8 + 2 * t);
          split_tf32(kx.x, bb[nb][0], bs[nb][0]);
          split_tf32(kx.y, bb[nb][1], bs[nb][1]);
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) mma_tf32(s[1][par][nb], as[0], as[1], as[2], as[3], bb[nb][0], bb[nb][1]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) mma_tf32(s[2][par][nb], ab[0], ab[1], ab[2], ab[3], bs[nb][0], bs[nb][1]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) mma_tf32(s[0][par][nb], ab[0], ab[1], ab[2], ab[3], bb[nb][0], bb[nb][1]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nb][e] = (s[0][0][nb][e] + s[0][1][nb][e]) +
                      ((s[1][0][nb][e] + s[1][1][nb][e]) + (s[2][0][nb][e] + s[2][1][nb][e]));
    } else {
      // k-step of 16 head dims: one ldmatrix gives both key blocks' B
      // fragments, one a part's A fragment.  With a single part the even
      // and odd k-steps take their own accumulators.
      constexpr int PAR = NP == 1 ? 2 : 1;
      float s[PAR][NP][2][4];
#pragma unroll
      for (int i = 0; i < PAR; ++i)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) s[i][p][nb][0] = s[i][p][nb][1] = s[i][p][nb][2] = s[i][p][nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int par = kk % PAR;
        uint32_t kb[4];
        ldsm_x4(kb, ks + ((lane >> 4) * 8 + (lane & 7)) * KS + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int p = NP - 1; p >= 0; --p) {
          uint32_t a[4];
          ldsm_x4(a, qw + (p * rows + (lane & 15)) * QS + kk * 16 + (lane >> 4) * 8);
          mma_bf16(s[par][p][0], a, kb[0], kb[1]);
          mma_bf16(s[par][p][1], a, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = 0.f;
#pragma unroll
          for (int p = NP - 1; p >= 0; --p)
#pragma unroll
            for (int par = 0; par < PAR; ++par) x += s[par][p][nb][e];
          sc[nb][e] = x;
        }
    }

    // ---- Online softmax on the fragments: lane holds rows gr and gr + 8,
    // keys key0 + 8nb + 2t + {0, 1}.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = key0 + nb * 8 + 2 * t + (e & 1);
        sc[nb][e] = kpos < end ? to_log2(sc[nb][e]) : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nb][e]);
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
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A masked key gives exactly 0, also while the whole row is masked
        // so far (m == kNegInf would make exp2(0) = 1).
        const float p = sc[nb][e] > 0.5f * kNegInf ? exp2f(sc[nb][e] - m[e >> 1]) : 0.f;
        sc[nb][e] = p;
        l[e >> 1] += p;
      }
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < NO; ++nb) {
        o[nb][0] *= alpha[0];
        o[nb][1] *= alpha[0];
        o[nb][2] *= alpha[1];
        o[nb][3] *= alpha[1];
      }
    }

    // ---- O += P·V.  The output's column blocks go in groups, each pass
    // or part over the whole group before the next, so that a product
    // never waits on the one before it.
    if constexpr (kF32) {
      // k-step = 8-key block nb of the scores; column t holds key 2t and
      // column t + 4 key 2t + 1, so the score fragment is the A fragment as
      // it stands.
      constexpr int CG = NO < 4 ? NO : 4;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const float pa[4] = {sc[nb][0], sc[nb][2], sc[nb][1], sc[nb][3]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(pa[e], ab[e], as[e]);
        const T* v0 = vs + (nb * 8 + 2 * t) * VS + gr;
#pragma unroll
        for (int c0 = 0; c0 < NO; c0 += CG) {
          uint32_t bb[CG][2], bs[CG][2];
#pragma unroll
          for (int cb = 0; cb < CG; ++cb) {
            split_tf32(v0[(c0 + cb) * 8], bb[cb][0], bs[cb][0]);
            split_tf32(v0[VS + (c0 + cb) * 8], bb[cb][1], bs[cb][1]);
          }
#pragma unroll
          for (int cb = 0; cb < CG; ++cb) mma_tf32(o[c0 + cb], as[0], as[1], as[2], as[3], bb[cb][0], bb[cb][1]);
#pragma unroll
          for (int cb = 0; cb < CG; ++cb) mma_tf32(o[c0 + cb], ab[0], ab[1], ab[2], ab[3], bs[cb][0], bs[cb][1]);
#pragma unroll
          for (int cb = 0; cb < CG; ++cb) mma_tf32(o[c0 + cb], ab[0], ab[1], ab[2], ab[3], bb[cb][0], bb[cb][1]);
        }
      }
    } else {
      // k-step = the warp's 16 keys: the two blocks' score fragments are
      // the A fragment of P (registers a0..a3: block 0 rows gr, gr + 8,
      // block 1 rows gr, gr + 8), split into NP bf16 parts; one transposed
      // ldmatrix gives the B fragments of two output column blocks.
      uint32_t pa[NP][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat16 lo[NP], hi[NP];
        split_bf16<NP>(sc[i >> 1][2 * (i & 1)], lo);
        split_bf16<NP>(sc[i >> 1][2 * (i & 1) + 1], hi);
#pragma unroll
        for (int p = 0; p < NP; ++p) pa[p][i] = pack2(lo[p], hi[p]);
      }
      constexpr int DP = HD / 16;  // pairs of column blocks
      constexpr int GP = DP < 4 ? DP : 4;
#pragma unroll
      for (int d0 = 0; d0 < DP; d0 += GP) {
        uint32_t vb[GP][4];
#pragma unroll
        for (int j = 0; j < GP; ++j)
          ldsm_x4_trans(vb[j], vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * VS + (d0 + j) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int p = NP - 1; p >= 0; --p) {
#pragma unroll
          for (int j = 0; j < GP; ++j) {
            mma_bf16(o[2 * (d0 + j)], pa[p], vb[j][0], vb[j][1]);
            mma_bf16(o[2 * (d0 + j) + 1], pa[p], vb[j][2], vb[j][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight once the ring is reused
  __syncthreads();     // every warp is done with the ring and the split queries

  // This warp's state into `state` [kw][row][HD]; the row sums over the
  // row's four lanes first.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = mt * 16 + gr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float* dst = state + (static_cast<size_t>(kw) * rows + row) * HD + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NO; ++cb)
      *reinterpret_cast<float2*>(dst + cb * 8) = make_float2(o[cb][2 * r], o[cb][2 * r + 1]);
    if (t == 0) {
      wm[kw * rows + row] = m[r];
      wl[kw * rows + row] = l[r];
    }
  }
  __syncthreads();
  merge_and_write<TQ, HD>(state, wm, wl, acc_s, m_s, l_s, rows, key_warps, g, out + q_base);
}

// ------------------------------------------------------------ head size 512
constexpr int kWideHD = 512;
constexpr int kWideKeys = 2;  // keys of a warp's stage
constexpr int kWideMaxWarps = 8;

// The wide route's dynamic shared memory: the merge's regions (one row),
// then each warp's ring of `stages` stages of kWideKeys K and V rows, which
// the warps' states reuse once the walk is over.  decode_plan computes the
// same number.
constexpr size_t wide_shared_bytes(int warps, int stages) {
  const size_t ring = static_cast<size_t>(warps) * stages * 2 * kWideKeys * kWideHD;
  const size_t states = static_cast<size_t>(warps) * kWideHD;
  return (merge_floats(1, kWideHD, warps) + (ring > states ? ring : states)) * sizeof(float);
}

// One cluster of gridDim.x blocks per (KV head, batch row), one query head
// a KV head.  Lane l owns dims 128j + 4l .. +3 (j = 0..3) of q, of every K
// and V row and of the output; warp w takes keys kWideKeys·(i·warps + w)
// ... of step i of its block's keys.
__global__ void __launch_bounds__(32 * kWideMaxWarps)
    decode_wide_kernel(const float* __restrict__ q,       // (B, H, 512)
                       const float* __restrict__ k_cache,  // (B, KV, S, 512)
                       const float* __restrict__ v_cache,  // (B, KV, S, 512)
                       const int* __restrict__ valid_len,  // (B,)
                       float* __restrict__ out,           // (B, H, 512)
                       int KV, int S, float sm_scale, int stages) {
  constexpr int HD = kWideHD;
  constexpr int J = HD / 128;  // float4 pieces a lane
  constexpr int ROW = 2 * kWideKeys * HD;  // floats of a warp's stage: K rows, then V rows
  extern __shared__ float4 dyn4[];
  const int warps = blockDim.x >> 5;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float* acc_s = reinterpret_cast<float*>(dyn4);
  float* m_s = acc_s + HD;
  float* l_s = m_s + pad4(1);
  float* wm = l_s + pad4(1);
  float* wl = wm + pad4(warps);
  float* ring = wl + pad4(warps);
  float* mine = ring + static_cast<size_t>(warp) * stages * ROW;  // this warp's ring
  float* state = ring;  // [warps][HD], once the walk is over

  const size_t row_base = static_cast<size_t>(b) * KV + c;  // the (batch row, head) of q and out
  const size_t kv_base = row_base * static_cast<size_t>(S) * HD;
  const int n = min(max(valid_len[b], 0), S);
  int start, end;
  block_keys(n, start, end);
  const int stride = warps * kWideKeys;  // keys of a block step
  const int first = start + warp * kWideKeys;
  const int nsteps = first < end ? (end - first + stride - 1) / stride : 0;

  // A lane copies, and later reads, only its own 16-byte pieces of each row.
  const auto load_stage = [&](int step) {
    float* dst = mine + (step % stages) * ROW;
    const int k0 = first + step * stride;
#pragma unroll
    for (int u = 0; u < kWideKeys; ++u) {
      const bool in = k0 + u < end;
      const size_t off = kv_base + (in ? static_cast<size_t>(k0 + u) * HD : 0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = 128 * j + 4 * lane;
        cp_async16(dst + u * HD + col, k_cache + off + col, in);
        cp_async16(dst + (kWideKeys + u) * HD + col, v_cache + off + col, in);
      }
    }
  };
  const int ahead = max(1, stages - 1);
  for (int p = 0; p < ahead; ++p) {
    if (p < nsteps) load_stage(p);
    cp_async_commit();
  }
  float4 qx[J];
#pragma unroll
  for (int j = 0; j < J; ++j) qx[j] = load4(q + row_base * HD + 128 * j + 4 * lane);

  float m = kNegInf, l = 0.f;
  float4 acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float scale2 = sm_scale * kLog2e;

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait_upto(ahead - 1);  // this lane's pieces of the step landed
    if (step + ahead < nsteps) load_stage(step + ahead);
    cp_async_commit();
    const float* src = mine + (step % stages) * ROW;
    const int k0 = first + step * stride;
    float s[kWideKeys];
#pragma unroll
    for (int u = 0; u < kWideKeys; ++u) {
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 kx = load4(src + u * HD + 128 * j + 4 * lane);
        x = fmaf(qx[j].x, kx.x, x);
        x = fmaf(qx[j].y, kx.y, x);
        x = fmaf(qx[j].z, kx.z, x);
        x = fmaf(qx[j].w, kx.w, x);
      }
      s[u] = x;
    }
#pragma unroll
    for (int u = 0; u < kWideKeys; ++u) s[u] = k0 + u < end ? warp_sum(s[u]) * scale2 : kNegInf;
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kWideKeys; ++u) m_new = fmaxf(m_new, s[u]);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    float p[kWideKeys];
    l *= alpha;
#pragma unroll
    for (int u = 0; u < kWideKeys; ++u) {
      p[u] = s[u] > 0.5f * kNegInf ? exp2f(s[u] - m) : 0.f;
      l += p[u];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float4 a = acc[j];
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
#pragma unroll
      for (int u = 0; u < kWideKeys; ++u) {
        const float4 vx = load4(src + (kWideKeys + u) * HD + 128 * j + 4 * lane);
        a.x = fmaf(p[u], vx.x, a.x);
        a.y = fmaf(p[u], vx.y, a.y);
        a.z = fmaf(p[u], vx.z, a.z);
        a.w = fmaf(p[u], vx.w, a.w);
      }
      acc[j] = a;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: `state` reuses it
#pragma unroll
  for (int j = 0; j < J; ++j)
    *reinterpret_cast<float4*>(state + warp * HD + 128 * j + 4 * lane) = acc[j];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  merge_and_write<float, HD>(state, wm, wl, acc_s, m_s, l_s, 1, warps, 1, out + row_base * HD);
}

// ============================================================ launch
// What a launch takes, whatever the instantiation: the shapes and the plan.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;
  int B, H, KV, S;
  float softcap;
  int route, warps, stages, cluster;
  size_t smem;
  cudaStream_t stream;
};

// Whether a ring of `stages` stages of `stage_keys` keys serves every block
// of the plan: a ring of one stage serves only a block of one stage.
inline bool ring_fits(const Args& a, int stage_keys) {
  const int per = (a.S + a.cluster - 1) / a.cluster;
  return a.stages >= 2 || (per + stage_keys - 1) / stage_keys <= 1;
}

template <typename Kernel, typename... KArgs>
cudaError_t launch_kernel(Kernel kernel, const Args& a, KArgs... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(a.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.cluster), static_cast<unsigned>(a.KV),
                     static_cast<unsigned>(a.B));
  cfg.blockDim = dim3(static_cast<unsigned>(32 * a.warps));
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename TQ, typename T, int HD, int G, bool SOFTCAP>
cudaError_t launch_simt(const Args& a) {
  // The plan's warps are `slots` slots of G warps, and its stages the slots.
  if (a.warps != G * a.stages || a.warps > kMaxWarps || a.smem != simt_shared_bytes<T, HD, G>(a.stages))
    return cudaErrorInvalidValue;
  return launch_kernel(decode_simt_kernel<TQ, T, HD, G, SOFTCAP>, a, static_cast<const TQ*>(a.q),
                       static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.valid_len,
                       static_cast<TQ*>(a.out), a.H, a.KV, a.S,
                       1.f / std::sqrt(static_cast<float>(HD)), a.softcap);
}

template <typename TQ, typename T, int HD, bool SOFTCAP>
cudaError_t launch_tc(const Args& a) {
  const int m_tiles = (a.H / a.KV + 15) / 16;
  if (a.warps % m_tiles != 0 || a.warps > kTcMaxWarps || a.stages > 4 ||
      !ring_fits(a, kTcKeys * (a.warps / m_tiles)) ||
      a.smem != tc_shared_bytes<TQ, T, HD>(m_tiles, a.warps / m_tiles, a.stages))
    return cudaErrorInvalidValue;
  return launch_kernel(decode_tc_kernel<TQ, T, HD, SOFTCAP>, a, static_cast<const TQ*>(a.q),
                       static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.valid_len,
                       static_cast<TQ*>(a.out), a.H, a.KV, a.S,
                       1.f / std::sqrt(static_cast<float>(HD)), a.softcap, m_tiles, a.stages);
}

template <typename TQ, typename T, int HD, bool SOFTCAP>
cudaError_t launch_route(const Args& a) {
  const int g = a.H / a.KV;
  if (a.route == kTensorCores) return launch_tc<TQ, T, HD, SOFTCAP>(a);
  if (a.route != kSimt || g > 4) return cudaErrorInvalidValue;
  if (g > 2) return launch_simt<TQ, T, HD, 4, SOFTCAP>(a);
  if (g == 2) return launch_simt<TQ, T, HD, 2, SOFTCAP>(a);
  return launch_simt<TQ, T, HD, 1, SOFTCAP>(a);
}

template <typename TQ, typename T, bool SOFTCAP>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16:
      return launch_route<TQ, T, 16, SOFTCAP>(a);
    case 32:
      return launch_route<TQ, T, 32, SOFTCAP>(a);
    case 64:
      return launch_route<TQ, T, 64, SOFTCAP>(a);
    case 128:
      return launch_route<TQ, T, 128, SOFTCAP>(a);
    case 192:
      return launch_route<TQ, T, 192, SOFTCAP>(a);
    case kWideHD:
      // xLSTM-1.3B's token path: one query head a KV head, float32 queries
      // over a float32 cache, no softcap; no other instantiation at 512.
      if constexpr (std::is_same_v<TQ, float> && std::is_same_v<T, float> && !SOFTCAP) {
        if (a.route == kWide && a.H == a.KV && a.warps <= kWideMaxWarps && a.stages <= 4 &&
            ring_fits(a, kWideKeys * a.warps) && a.smem == wide_shared_bytes(a.warps, a.stages))
          return launch_kernel(decode_wide_kernel, a, static_cast<const float*>(a.q),
                               static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                               a.valid_len, static_cast<float*>(a.out), a.KV, a.S,
                               1.f / std::sqrt(static_cast<float>(kWideHD)), a.stages);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename T>
cudaError_t dispatch_softcap(int hd, const Args& a) {
  return a.softcap > 0.f ? dispatch_hd<TQ, T, true>(hd, a) : dispatch_hd<TQ, T, false>(hd, a);
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, hd) and out: (B, H, hd) of the storage type `q_dtype`;
// k_cache, v_cache: (B, KV, S, hd) of `cache_dtype`, all contiguous;
// valid_len: (B,) int32.  The pairs taken: float32 / float32, bfloat16 /
// bfloat16, and float32 queries over a bfloat16 cache.  hd must be 16, 32,
// 64, 128 or 192, or 512 for float32 / float32 with one query head a KV
// head and no softcap; softcap > 0 caps the scaled scores at ±softcap
// (tanh), 0 leaves them.  The plan (decode_plan in decode_attention.py):
// `route` (0 SIMT, 1 tensor cores, 2 head size 512), `warps` a block,
// `stages` (the SIMT route's tile slots; the others' ring depth, 1 to 4),
// `cluster` blocks a (KV head, batch row), 1 to 8, and `smem` dynamic
// shared bytes a block, exactly the route's layout; a plan that does not
// fit the route is refused.
// Launches on `stream` and returns the launch's error code (0 when it was
// accepted).
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const int* valid_len, void* out, int q_dtype,
                                       int cache_dtype, int B, int H, int KV, int S, int hd,
                                       float softcap, int route, int warps, int stages,
                                       int cluster, long long smem, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || !(softcap >= 0.f) || warps < 1 ||
      stages < 1 || cluster < 1 || cluster > kMaxCluster || smem < 0 ||
      static_cast<size_t>(smem) > kMaxShared)
    return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, valid_len, out, B, H, KV, S, softcap, route, warps, stages,
               cluster, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)};
  if (q_dtype == kFloat32 && cache_dtype == kFloat32) return dispatch_softcap<float, float>(hd, a);
  if (q_dtype == kBFloat16 && cache_dtype == kBFloat16)
    return dispatch_softcap<__nv_bfloat16, __nv_bfloat16>(hd, a);
  if (q_dtype == kFloat32 && cache_dtype == kBFloat16)
    return dispatch_softcap<float, __nv_bfloat16>(hd, a);
  return cudaErrorInvalidValue;
}
