// Decode attention for Hopper (sm_90a): one query token per row against a
// KV cache, grouped-query heads sharing their KV head's cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py,
// function decode_attention_pallas (body `_kernel`).  That kernel carried the
// online-softmax state (m, l, acc) from one cache block to the next along a
// sequential grid axis, one program per (batch row, KV head).  Blocks on
// Hopper run in no order, so here a block stages several 32-key tiles of its
// (batch row, KV head) at once, one per slot of warps, walks its share of
// the cache in such steps, and merges its warps' states in shared memory.
// Where B·KV blocks would leave the card's 132 SMs under-filled (64 blocks
// at Arctic's batch of 8), the cache is split along S as well
// (flash-decoding): a (batch row, KV head) gets a thread-block cluster of up
// to 8 blocks, and the blocks merge their states through distributed shared
// memory, each writing a slice of the output: no scratch buffer and no
// second launch.  A group of 1 or 2 query heads has little work a tile, so
// its blocks hold up to 8 tile slots and a cluster is rarely needed
// (orloj_gpt's step: 96 blocks of 8 slots, one per row and KV head); a group
// of 4 to 8 heads fills 4 warps a tile, keeps one slot, and spreads over
// the cluster instead (Arctic's: 64 clusters of 8 one-tile blocks).
//
// What bounds it on the H100: bytes.  Each cache element is read once and
// feeds 2·g flops per query head group (g = 7 for Arctic, 1 for orloj_gpt),
// far below the ~20 float32 flops per byte at which the card stops waiting
// on memory.  What the design does about it: every K/V element is read from
// device memory once, a whole step of tiles at once with 16-byte cp.async
// into shared memory, so a block pays one memory latency a step and not one
// per key; all the query heads of a group (up to 8, dealt to up to 4 warps
// a tile) are served from that copy, so a group of 7 reads its cache once,
// not 7 times; the split spreads the bytes over every SM; one lane owns one
// key, so a tile's scores take one pass and two warp reductions per head;
// tiles past valid_len[b] are never loaded, so cache slots that were never
// written are never read (a block with none only waits for the merge); and
// the merges read shared memory, not device memory.  The ragged tail of S
// is masked in the kernel, so any cache length is served.
//
// Storage types: q and the output share one type, the caches may have
// another.  The models' decode step attends float32 queries over a
// bfloat16 cache (the reference's default cache type, read back to
// float32); that instantiation stages the bf16 tiles as they are, half the
// bytes of a float32 cache, and computes in float32 like every other.  A
// logit softcap (tanh(s / cap) · cap on the scaled scores, before the mask)
// is a template flag, so that the instantiations without it are the code
// they were.

#include <cooperative_groups.h>

#include <algorithm>
#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 32;                      // keys of a tile, one per lane of a warp
constexpr int kMaxCluster = 8;                 // blocks of a cluster (the portable limit)
constexpr size_t kMaxStageBytes = 160 * 1024;  // staged tiles a block, at most

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

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

// The group's G query heads (G the group size rounded up to a power of
// two, at most 8) are dealt to kHeadWarps<G> warps, kHeadsPerWarp<G> each;
// a group larger than 8 takes several passes over the cache.
template <int G>
constexpr int kHeadsPerWarp = G > 4 ? G / 4 : 1;
template <int G>
constexpr int kHeadWarps = G / kHeadsPerWarp<G>;
constexpr int kMaxWarps = 8;

// Rows of a staged tile, padded by 16 bytes so that a lane reading its own
// key's row in 16-byte pieces meets no bank conflict.
template <typename T, int HD>
constexpr int kRowLen = HD + 16 / static_cast<int>(sizeof(T));

// Dynamic shared memory of a block with `slots` tile slots: the staged K and
// V tiles, which the warps' states reuse once the walk is over.
template <typename T, int HD, int G>
constexpr size_t shared_bytes(int slots) {
  const size_t stage = static_cast<size_t>(slots) * 2 * kTile * kRowLen<T, HD> * sizeof(T);
  const size_t states = static_cast<size_t>(slots) * G * HD * sizeof(float);
  return stage > states ? stage : states;
}

// One cluster of gridDim.x blocks per (KV head, batch row); each block has
// `slots` slots of kHeadWarps<G> warps.  Warp (slot, w) scores its slot's
// tile against heads w·kHeadsPerWarp<G> ... (one lane per key) and folds it
// into its online state (m, l, acc).  Block r of the cluster walks steps
// r, r + gridDim.x, ... of `slots` tiles each.
template <typename TQ, typename T, int HD, int G, bool SOFTCAP>
__global__ void __launch_bounds__(32 * kMaxWarps)
    decode_attention_kernel(const TQ* __restrict__ q,       // (B, H, HD)
                            const T* __restrict__ k_cache,  // (B, KV, S, HD)
                            const T* __restrict__ v_cache,  // (B, KV, S, HD)
                            const int* __restrict__ valid_len,  // (B,)
                            TQ* __restrict__ out,           // (B, H, HD)
                            int H, int KV, int S, float sm_scale, float softcap) {
  namespace cg = cooperative_groups;
  constexpr int GW = kHeadsPerWarp<G>;
  constexpr int DPL = HD / 32;  // output dims each lane owns: lane*DPL ...
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
  const int g = H / KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slots = (blockDim.x >> 5) / kHeadWarps<G>;
  const int slot = warp / kHeadWarps<G>;
  const int h0 = (warp % kHeadWarps<G>) * GW;  // this warp's first head, within a pass
  const int step_keys = slots * kTile;
  const int n = min(max(valid_len[b], 0), S);
  const size_t kv_base = (static_cast<size_t>(b) * KV + c) * static_cast<size_t>(S) * HD;
  T* k_t = reinterpret_cast<T*>(dyn4) + slot * 2 * kTile * LD;  // this slot's tile
  T* v_t = k_t + kTile * LD;
  float* state = reinterpret_cast<float*>(dyn4);  // [slots][G][HD], once the walk is over

  for (int j0 = 0; j0 < g; j0 += G) {
    const int gj = min(G, g - j0);  // heads of this pass
    const size_t q_base = (static_cast<size_t>(b) * H + static_cast<size_t>(c) * g + j0) * HD;
    for (int i = threadIdx.x; i < G * HD; i += blockDim.x)
      q_s[i / HD][i % HD] = i / HD < gj ? to_float(q[q_base + i]) : 0.f;

    float m[GW], l[GW], acc[GW][DPL];
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[j][e] = 0.f;
    }

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
      cp_async_wait_all();
      __syncthreads();

      const int nt = min(kTile, rows - slot * kTile);  // keys of this slot's tile
      if (nt <= 0) continue;
      // This lane's key: its scores against this warp's heads.
      float s[GW];
#pragma unroll
      for (int j = 0; j < GW; ++j) s[j] = 0.f;
      const T* kr = k_t + lane * LD;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kx = load4(kr + d);
#pragma unroll
        for (int j = 0; j < GW; ++j) {
          const float4 qx = *reinterpret_cast<const float4*>(&q_s[h0 + j][d]);
          s[j] = fmaf(qx.x, kx.x, s[j]);
          s[j] = fmaf(qx.y, kx.y, s[j]);
          s[j] = fmaf(qx.z, kx.z, s[j]);
          s[j] = fmaf(qx.w, kx.w, s[j]);
        }
      }
      float p[GW];
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        float sj = s[j] * sm_scale;
        if constexpr (SOFTCAP) sj = tanhf(sj / softcap) * softcap;
        sj = lane < nt ? sj : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(sj));
        p[j] = lane < nt ? expf(sj - m_new) : 0.f;
        const float alpha = expf(m[j] - m_new);
        l[j] = alpha * l[j] + warp_sum(p[j]);
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[j][e] *= alpha;
      }
      // acc += p·V: key u's probabilities come from lane u; each lane reads
      // its DPL dims of V row u.
#pragma unroll 8
      for (int u = 0; u < nt; ++u) {
        const T* vr = v_t + u * LD + lane * DPL;
        float vx[DPL];
        if constexpr (DPL == 4) {
          const float4 v4 = load4(vr);
          vx[0] = v4.x;
          vx[1] = v4.y;
          vx[2] = v4.z;
          vx[3] = v4.w;
        } else {
#pragma unroll
          for (int e = 0; e < DPL; ++e) vx[e] = to_float(vr[e]);
        }
#pragma unroll
        for (int j = 0; j < GW; ++j) {
          const float pu = __shfl_sync(0xffffffffu, p[j], u);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[j][e] = fmaf(pu, vx[e], acc[j][e]);
        }
      }
    }

    // Merge the slots' states in shared memory.  A slot that saw no key has
    // m = -1e30 and l = acc = 0, so it adds nothing; valid_len == 0 leaves
    // every row 0.  A block of one slot has nothing to merge: its warps'
    // states are the block's.
    if (slots == 1) {
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        if (h0 + j >= gj) continue;
        if (blocks == 1) {
          const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            out[q_base + (h0 + j) * HD + lane * DPL + e] = from_float<TQ>(acc[j][e] * inv);
        } else {
          if (lane == 0) {
            m_s[h0 + j] = m[j];
            l_s[h0 + j] = l[j];
          }
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc_s[h0 + j][lane * DPL + e] = acc[j][e];
        }
      }
    }
    __syncthreads();  // the staged tiles and q_s are consumed: `state` reuses the tiles
    if (slots > 1) {
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        if (lane == 0) {
          wm_s[slot][h0 + j] = m[j];
          wl_s[slot][h0 + j] = l[j];
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) state[(slot * G + h0 + j) * HD + lane * DPL + e] = acc[j][e];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < gj * HD; i += blockDim.x) {
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
    if (blocks == 1) continue;

    // Merge the cluster's blocks: block `rank` writes every blocks-th
    // output element of the group.
    cluster.sync();  // every block's state is in its shared memory
    for (int i = rank * blockDim.x + threadIdx.x; i < gj * HD; i += blocks * blockDim.x) {
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
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return count;
}

// What a launch takes, whatever the instantiation.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;
  int B, H, KV, S;
  float softcap;
  cudaStream_t stream;
};

template <typename TQ, typename T, int HD, int G, bool SOFTCAP>
cudaError_t launch_g(const Args& a) {
  // A small group (1 or 2 heads, little work a tile) takes as many tile
  // slots as 8 warps and kMaxStageBytes hold, so that one step covers a
  // short cache and one block a (row, KV head); a group of 4 or more heads
  // fills 4 warps a tile and keeps one slot.  Then as many blocks a cluster
  // as it takes for B·KV clusters to cover the SMs four times, at most 8
  // and at most one a step.
  const auto kernel = decode_attention_kernel<TQ, T, HD, G, SOFTCAP>;
  const int tiles = (a.S + kTile - 1) / kTile;
  const int slot_bytes = static_cast<int>(2 * kTile * kRowLen<T, HD> * sizeof(T));
  const int max_slots = kHeadWarps<G> >= 4 ? 1 : kMaxWarps / kHeadWarps<G>;
  const int slots =
      std::min({max_slots, tiles, static_cast<int>(kMaxStageBytes) / slot_bytes});
  const int steps = (tiles + slots - 1) / slots;
  const int want = (4 * sm_count() + a.B * a.KV - 1) / (a.B * a.KV);
  const int blocks = std::max(1, std::min({kMaxCluster, steps, want}));
  const size_t smem = shared_bytes<T, HD, G>(slots);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(a.KV),
                     static_cast<unsigned>(a.B));
  cfg.blockDim = dim3(static_cast<unsigned>(32 * kHeadWarps<G> * slots));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale = 1.f / std::sqrt(static_cast<float>(HD));
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
                            static_cast<const T*>(a.v), a.valid_len, static_cast<TQ*>(a.out), a.H,
                            a.KV, a.S, scale, a.softcap);
}

template <typename TQ, typename T, int HD, bool SOFTCAP>
cudaError_t launch(const Args& a) {
  const int g = a.H / a.KV;
  if (g > 4) return launch_g<TQ, T, HD, 8, SOFTCAP>(a);
  if (g > 2) return launch_g<TQ, T, HD, 4, SOFTCAP>(a);
  if (g == 2) return launch_g<TQ, T, HD, 2, SOFTCAP>(a);
  return launch_g<TQ, T, HD, 1, SOFTCAP>(a);
}

template <typename TQ, typename T, bool SOFTCAP>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return launch<TQ, T, 32, SOFTCAP>(a);
    case 64:
      return launch<TQ, T, 64, SOFTCAP>(a);
    case 128:
      return launch<TQ, T, 128, SOFTCAP>(a);
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
// bfloat16, and float32 queries over a bfloat16 cache.  hd must be 32, 64
// or 128; softcap > 0 caps the scaled scores at ±softcap (tanh), 0 leaves
// them.  Launches one cluster of blocks per (KV head, batch row) on
// `stream` and returns the launch's error code (0 when it was accepted).
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const int* valid_len, void* out, int q_dtype,
                                       int cache_dtype, int B, int H, int KV, int S, int hd,
                                       float softcap, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, valid_len, out, B, H, KV, S, softcap,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == kFloat32 && cache_dtype == kFloat32) return dispatch_softcap<float, float>(hd, a);
  if (q_dtype == kBFloat16 && cache_dtype == kBFloat16)
    return dispatch_softcap<__nv_bfloat16, __nv_bfloat16>(hd, a);
  if (q_dtype == kFloat32 && cache_dtype == kBFloat16)
    return dispatch_softcap<float, __nv_bfloat16>(hd, a);
  return cudaErrorInvalidValue;
}
