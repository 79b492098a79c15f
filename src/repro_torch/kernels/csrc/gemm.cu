// A float32 matrix product for Hopper (sm_90a): Y (M, N) = X (M, K) · W (K, N),
// with X's rows the tokens (K contiguous) and W a weight (N contiguous), as
// the port's models lay out activations and weights: the head projections
// (d, H, hd) flattened to (d, H·hd), the output projection (H, hd, d) to
// (H·hd, d), the MLP's (d, ff) and (ff, d), and the head's (d, V).
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (the einsums of repro/models/layers.py and model.py).  It was added
// because the serving forward's float32 weight products ran on cuBLAS's
// SIMT sgemm, on the CUDA cores, and took ~90% of the card's busy time.
//
// What bounds it on the H100: the weight's bytes at few token rows (each
// weight element serves M tokens, so below ~100 rows reading 4·K·N bytes at
// 3.35 TB/s takes longer than the products), and the tensor cores'
// float32 rate above that.  Float32 runs on the tensor cores as split
// TF32, as the attention kernels run it: each operand x = big + small, big
// = tf32(x), small = tf32(x - big), and each product is small·big +
// big·small + big·big accumulated in float32 (small·small, ~2^-22
// relative, is dropped): three TF32 passes, at most 495 / 3 = 165 TFLOP/s
// of float32 work.  One pass keeps 10 mantissa bits and misses float32's
// accuracy; it is never taken.
//
// The design:
// - Roles: the weight's output features are wgmma's 64-row M tiles (A) and
//   the tokens its N width (B, 8 to 128 a block): Yᵀ = Wᵀ·Xᵀ.  Every weight
//   byte is read from device memory once a product (the token tiles of one
//   feature tile are neighbours in the launch order and share it in L2),
//   and no token rows are padded to 64.
// - A block: two consumer warpgroups of 64 features each, and a producer
//   warpgroup.  One producer thread keeps TMA loads of the raw float32
//   tiles in flight in an mbarrier ring of 2 to 8 stages: W's (32 k x 128
//   features) tile as four 128-byte-swizzled boxes of 32 x 32, X's (tokens x
//   32 k) tile as one box; rows past M and columns past N or K arrive as
//   zeros.  The other three producer warps split each X tile as it lands,
//   big in place and small beside it (once, for both warpgroups), K-major
//   as wgmma's B operand wants it.
// - W's tile arrives N-major, and TF32 wgmma takes K-major operands only.
//   The consumers take it as the A operand from registers: each thread
//   reads its m16n8k8 fragment straight from the swizzled tile (the
//   transpose is in the addressing) and splits it in registers, so each
//   weight element is split once and no transposed copy is staged.
// - Each 8-deep k-step is one committed group of the three products; one
//   group stays in flight while the next k-step's fragments are read and
//   split.  The tensor cores' sums truncate, and carried over all of K they
//   drift by ~1e-5 relative (20-50x float32's error, measured): each K tile
//   of 32 is summed on the tensor cores from zero, and the tiles' sums are
//   added in registers, rounded to nearest.  Two accumulators of T/2
//   registers a thread bound the token width at 128.
// - Split-K where the output tiles are too few to fill the card (the k and
//   v projections' 256 features are two tiles): `splits` blocks of a tile
//   each sum a run of K tiles and write their float32 partial, (M, N) a
//   split, to a workspace; a second kernel adds the partials in split
//   order, every output element on its own thread, and writes Y, so two
//   calls give the same bits.  (One block adding a tile's partials reads
//   splits x tokens x 128 floats alone: at 32 splits, longer than the
//   product.)
// - The launch plan (gemm.py's gemm_plan) picks the token width, the ring's
//   depth and the splits from the shape; the launcher refuses a plan that
//   does not fit the kernel's layout.
// - No split copy of the weights is kept: big and small copies of GLM-4-9B's
//   35 GB of weights would not fit on the card beside them.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockK = 32;                       // K a tile: one 128-byte row of float32
constexpr int kRowBytes = kBlockK * 4;            // the swizzle's width
constexpr int kWarpgroups = 2;                    // consumer warpgroups, 64 features each
constexpr int kFeatures = 64 * kWarpgroups;       // output features a block
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kSplitWarps = 3;                    // the producer warps that split X
constexpr int kProducerThreads = 32 * (1 + kSplitWarps);
constexpr int kMaxStages = 8;
constexpr int kMaxShared = 232448;                // shared memory a block can use on the H100
constexpr int kWBytes = kFeatures * kRowBytes;    // W's tile: 32 k rows x 128 features
constexpr int kBarrierBytes = 256;                // the full, split and empty mbarriers

// The block's shared memory, from the dynamic base (1024-byte aligned: the
// swizzle patterns repeat every 1024 bytes; the kernel traps where it is
// not): `stages` stages of W's four 32-feature boxes (32 rows of 128 bytes
// each), X's tile (T rows of 128 bytes) split in place into big, and X's
// small part; then the mbarriers.  Mirrored by gemm.py's shared_bytes:
// change both.
template <int T>
struct Gemm {
  static constexpr int kXBytes = T * kRowBytes;
  static constexpr int kStageBytes = kWBytes + 2 * kXBytes;
  static constexpr size_t shared_bytes(int stages) {
    return static_cast<size_t>(stages) * kStageBytes + kBarrierBytes;
  }
};

template <int T>
__global__ void __launch_bounds__(kConsumers + kProducerThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_x,  // (K, M): X's rows
                const __grid_constant__ CUtensorMap map_w,  // (N, K): W's rows
                float* __restrict__ y, long long ldy,       // (M, N), row stride ldy; split-K:
                                                            // (splits, M, N), the partials
                int M, int N, int k_tiles, int tiles_per_split, int stages) {
  using L = Gemm<T>;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* bar_s = smem + static_cast<size_t>(stages) * L::kStageBytes;
  const uint32_t full0 = smem_addr(bar_s);
  const uint32_t split0 = full0 + 8 * kMaxStages;  // the stage's X tile split
  const uint32_t empty0 = split0 + 8 * kMaxStages;

  const int m0 = blockIdx.x * T;
  const int f0 = blockIdx.y * kFeatures;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int n_tiles = min(tiles_per_split, k_tiles - kt0);  // >= 1 by the plan

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    if (smem_addr(smem) & 1023) __trap();  // the swizzles need the alignment
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(split0 + 8 * i, kSplitWarps);
      mbar_init(empty0 + 8 * i, 4 * kWarpgroups);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // ---- the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = tid - kConsumers;
    if (ptid == 0) {  // one thread issues every copy
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % stages;
        mbar_wait(empty0 + 8 * st, ((it / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, kWBytes + L::kXBytes);
        const uint32_t base = smem_addr(smem) + static_cast<uint32_t>(st * L::kStageBytes);
        const int k0 = (kt0 + it) * kBlockK;
#pragma unroll
        for (int c = 0; c < kFeatures / 32; ++c) tma_load_2d(base + c * kBlockK * kRowBytes, &map_w, full, f0 + 32 * c, k0);
        tma_load_2d(base + kWBytes, &map_x, full, k0, m0);
      }
    } else if (ptid >= 32) {  // the split warps: X big in place, small beside it
      constexpr int kSplitThreads = 32 * kSplitWarps;
      const int sid = ptid - 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % stages;
        mbar_wait(full0 + 8 * st, (it / stages) & 1);
        uint8_t* xs = smem + static_cast<size_t>(st) * L::kStageBytes + kWBytes;
        for (int i = sid; i < L::kXBytes / 16; i += kSplitThreads)
          split4(xs + 16 * i, xs + 16 * i, xs + L::kXBytes + 16 * i);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(split0 + 8 * st);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // ---- the consumers: warpgroup wg owns features [64·wg, 64·wg + 64) of the
  // block, its warp w the 16 from 64·wg + 16·w.  wg as lane 0 holds it, so
  // that the compiler knows it uniform across the warp.
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column
  // This thread's A rows, features fw and fw + 8 of the block, lie in W's
  // 32-feature box fw / 32 at byte columns col and col + 32 of its rows.
  const int fw = 64 * wg + 16 * warp + g;
  const uint32_t box = static_cast<uint32_t>((fw >> 5) * kBlockK * kRowBytes);
  const uint32_t col = static_cast<uint32_t>((fw & 31) * 4);

  // Two accumulators.  The tensor cores add each product into `part`
  // without rounding to nearest (their sums truncate), and a sum carried
  // over all of K in them drifts: each K tile's products therefore start
  // `part` afresh, and `acc` adds the tiles' sums in float32, rounded to
  // nearest, as a float32 product's sums are.
  float acc[T / 2], part[T / 2];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;
  // Two sets of A fragments, big and small, alternating by k-step: one is
  // read by the group in flight while the other is loaded.
  uint32_t a_big[2][4], a_small[2][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % stages;
    mbar_wait(split0 + 8 * st, (it / stages) & 1);
    const uint8_t* w_s = smem + static_cast<size_t>(st) * L::kStageBytes + box;
    const uint32_t x_big = smem_addr(smem) + static_cast<uint32_t>(st * L::kStageBytes + kWBytes);
    const uint32_t x_small = x_big + L::kXBytes;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      uint32_t(&fb)[4] = a_big[j & 1];
      uint32_t(&fs)[4] = a_small[j & 1];
      // The TF32 A fragment: rows g, g + 8 (features) x columns t, t + 4 (k)
      // of the k-step; W's row k holds the features, 128-byte swizzled.
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t k = 8 * j + t + 4 * (e >> 1);
        const float x = *reinterpret_cast<const float*>(w_s + swizzle<kRowBytes>(k * kRowBytes + col + 32 * (e & 1)));
        split_tf32(x, fb[e], fs[e]);
      }
      const uint64_t db = wgmma_desc(x_big + 32 * j, 16, 8 * kRowBytes, desc_layout<kRowBytes>());
      const uint64_t ds = wgmma_desc(x_small + 32 * j, 16, 8 * kRowBytes, desc_layout<kRowBytes>());
      pin_registers(part);
      wgmma_fence();
      wgmma_tf32_rs<T>(part, fs, db, j > 0);  // small·big (the tile's first product overwrites)
      wgmma_tf32_rs<T>(part, fb, ds, 1);      // big·small
      wgmma_tf32_rs<T>(part, fb, db, 1);      // big·big
      wgmma_commit();
      pin_registers(part);
      wgmma_wait<1>();
      pin_registers(a_big[0]), pin_registers(a_big[1]);
      pin_registers(a_small[0]), pin_registers(a_small[1]);
    }
    wgmma_wait<0>();
    pin_registers(part);
    __syncwarp();  // the tile's products are done: its stage is free
    mbar_arrive_if(empty0 + 8 * st, lane == 0);
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] += part[i];
  }

  // d[4n + e] holds feature g + 8·(e / 2) of the warp's 16 and token
  // 8n + 2t + (e % 2) of the block's T.  A split writes its own partial.
  float* out = y + static_cast<size_t>(blockIdx.z) * M * ldy;
  const int fa = f0 + fw;
#pragma unroll
  for (int n = 0; n < T / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * n + 2 * t + (e & 1);
      const int f = fa + 8 * (e >> 1);
      if (m < M && f < N) out[static_cast<size_t>(m) * ldy + f] = acc[4 * n + e];
    }
  }
}

// y (n4 float4s) = the sum of `splits` partials of n4 float4s each, laid
// one after another, added in split order.
__global__ void __launch_bounds__(256)
    gemm_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ y, long long n4, int splits) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    float4 s = __ldcs(partial + i);
#pragma unroll 8
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = __ldcs(partial + sp * n4 + i);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    y[i] = s;
  }
}

// A 2-dimensional map of a row-major (rows, cols) float32 matrix with row
// stride `ld` elements, read in boxes of (box_cols, box_rows), 128-byte
// swizzled; elements outside arrive as zeros.
cudaError_t encode_2d(CUtensorMap* map, const float* base, long long rows, long long cols, long long ld,
                      int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle<kRowBytes>(),
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const float* x;
  long long ldx;
  const float* w;
  long long ldw;
  float* y;
  long long ldy;
  float* partial;
  int M, N, K, stages, splits, tiles_per_split;
  long long shared_bytes;
  cudaStream_t stream;
};

template <int T>
cudaError_t launch(const Args& a) {
  using L = Gemm<T>;
  if (a.stages < 2 || a.stages > kMaxStages ||
      a.shared_bytes != static_cast<long long>(L::shared_bytes(a.stages)) || a.shared_bytes > kMaxShared)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t err = encode_2d(&mx, a.x, a.M, a.K, a.ldx, kBlockK, T);
  if (err == cudaSuccess) err = encode_2d(&mw, a.w, a.K, a.N, a.ldw, 32, kBlockK);
  if (err != cudaSuccess) return err;
  const auto kernel = gemm_kernel<T>;
  err = allow_shared_bytes(kernel, static_cast<size_t>(a.shared_bytes));
  if (err != cudaSuccess) return err;
  const int k_tiles = (a.K + kBlockK - 1) / kBlockK;
  const dim3 grid((a.M + T - 1) / T, (a.N + kFeatures - 1) / kFeatures, a.splits);
  const bool split = a.splits > 1;
  kernel<<<grid, kConsumers + kProducerThreads, static_cast<size_t>(a.shared_bytes), a.stream>>>(
      mx, mw, split ? a.partial : a.y, split ? a.N : a.ldy, a.M, a.N, k_tiles, a.tiles_per_split, a.stages);
  if (!split) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(a.M) * a.N / 4;
  const int blocks = static_cast<int>(std::min<long long>((n4 + 255) / 256, 132LL * 8));
  gemm_reduce_kernel<<<blocks, 256, 0, a.stream>>>(reinterpret_cast<const float4*>(a.partial),
                                                    reinterpret_cast<float4*>(a.y), n4, a.splits);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace repro_torch

// y (M, N) = x (M, K) · w (K, N), all float32 and row-major, with row
// strides ldx, ldw and ldy in elements; x, w and y start on 16-byte
// boundaries, K, N, ldx and ldw are multiples of 4 (TMA's 16-byte rows).
// The plan (gemm.py's gemm_plan): `tokens` (the token rows a block: 8, 16,
// 32, 64 or 128), `warpgroups` (2), `block_k` (32), `stages`
// (2 to 8), `splits` and `tiles_per_split` (the K tiles of 32 a split; the
// last split takes the rest, at least one), and the dynamic shared bytes.
// With splits > 1, `partial` holds splits x M x N floats (the splits'
// partials), and y is contiguous (ldy == N).  A plan that the kernel's
// layout does not fit is refused.
// Launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int gemm_launch(const float* x, long long ldx, const float* w, long long ldw, float* y,
                           long long ldy, float* partial, int M, int N, int K, int tokens,
                           int warpgroups, int block_k, int stages, int splits, int tiles_per_split,
                           long long shared_bytes, void* stream) {
  using namespace repro_torch;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || N % 4 != 0 || ldx < K || ldx % 4 != 0 || ldw < N ||
      ldw % 4 != 0 || ldy < N || !aligned16(x) || !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  if (warpgroups != kWarpgroups || block_k != kBlockK || splits < 1 || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  const long long k_tiles = (K + kBlockK - 1) / kBlockK;
  if (static_cast<long long>(splits - 1) * tiles_per_split >= k_tiles ||
      static_cast<long long>(splits) * tiles_per_split < k_tiles)
    return cudaErrorInvalidValue;  // every split has a K tile, and the splits cover K
  if ((N + kFeatures - 1) / kFeatures > 65535 || splits > 65535 ||
      (splits > 1 && (partial == nullptr || ldy != N || !aligned16(partial))))
    return cudaErrorInvalidValue;
  const Args a{x, ldx, w, ldw, y, ldy, partial, M, N, K, stages, splits, tiles_per_split,
               shared_bytes, static_cast<cudaStream_t>(stream)};
  switch (tokens) {
    case 8:
      return launch<8>(a);
    case 16:
      return launch<16>(a);
    case 32:
      return launch<32>(a);
    case 64:
      return launch<64>(a);
    case 128:
      return launch<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
