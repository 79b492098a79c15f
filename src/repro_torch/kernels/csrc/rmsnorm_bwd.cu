// RMSNorm backward for Hopper (sm_90a): the gradients of rmsnorm.cu's
// y = x·r·scale, r = rsqrt(mean(x²) + eps), per row of x:
//
//   dx = r·(dy·scale − x̂·mean(dy·scale·x̂)),  x̂ = x·r
//   dscale = Σ_rows dy·x̂
//
// The TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm_pallas) has no
// backward; the port's model calls the forward kernel, so training on the
// card needs this one.
//
// What bounds it on the H100: bytes (x and dy read, dx written, a few flops
// an element).  The first launch reads each row once: a team of threads (a
// few warps) holds a row of x and dy in registers, loaded as 16-byte vectors
// where the row allows, sums x² and dy·scale·x over the team (shuffles,
// then one named barrier for the team alone: the block's other teams run
// on), and writes dx from the registers.  A block holds several teams, so
// several rows are in flight on a multiprocessor.  Each thread's columns
// are the same for every row it takes, so its share of dscale stays in
// registers; at the end the block adds its teams' shares in team order into
// its row of the float32 partial.  The second launch adds the blocks' rows
// column by column, in a fixed order.  No atomics: dscale is the same from
// run to run.  The host (rmsnorm.py, backward_plan) picks the team, the
// vectors a thread and the blocks; a row too wide for registers takes the
// rereading kernel instead, which keeps the block's dscale partial in shared
// memory and reads the row a second time from L1/L2.

#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

// ------------------------------------------------------------- rereading
constexpr int kThreads = 256;

__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    s.x += warp_sums[w].x;
    s.y += warp_sums[w].y;
  }
  __syncthreads();  // warp_sums is free for the next row
  return s;
}

// Blocks take rows blockIdx.x, blockIdx.x + gridDim.x, ...; thread t owns
// columns t, t + kThreads, ... of the row and of the block's dscale partial.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial,  // (gridDim.x, d)
                       int rows, int d, float eps) {
  extern __shared__ float dscale_s[];  // [d]
  for (int c = threadIdx.x; c < d; c += kThreads) dscale_s[c] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, dot = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float a = to_float(x[base + c]);
      ss = fmaf(a, a, ss);
      dot = fmaf(to_float(dy[base + c]) * scale[c], a, dot);
    }
    const float2 s = block_sum2(ss, dot);
    const float r = rsqrtf(s.x / static_cast<float>(d) + eps);
    // mean(dy·scale·x̂) = r·mean(dy·scale·x)
    const float m = r * s.y / static_cast<float>(d);
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xh = to_float(x[base + c]) * r;
      const float g = to_float(dy[base + c]);
      dx[base + c] = from_float<T>(r * (g * scale[c] - xh * m));
      dscale_s[c] = fmaf(g, xh, dscale_s[c]);
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads)
    partial[static_cast<size_t>(blockIdx.x) * d + c] = dscale_s[c];
}

// ----------------------------------------------------- rows in registers
constexpr int kMaxTeams = 8, kMaxTeamWarps = 8;  // a team: at most 256 threads
constexpr int kMaxColumns = 32;                  // columns a thread holds
// Threads a block: 512, or 256 where a thread holds 32 columns (x, dy and
// its dscale share: 96 registers).
constexpr int max_block(int columns) { return columns <= 16 ? 512 : 256; }

// VEC elements at p as float32: one 16-byte load (VEC = 16 / sizeof(T)) or one scalar.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
      out[4 * i] = v.x, out[4 * i + 1] = v.y, out[4 * i + 2] = v.z, out[4 * i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A team of `team` threads (a multiple of 32) takes rows team_id,
// team_id + teams·gridDim.x, ...; thread lt of a team owns the VEC-wide
// column groups (i·team + lt)·VEC, i < VPT, of every row it takes.
template <typename T, int VEC, int VPT>
__global__ void __launch_bounds__(VEC * VPT <= 16 ? 512 : 256)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial,  // (gridDim.x, d)
                            int rows, int d, int team, float eps) {
  extern __shared__ float4 smem4[];
  float2* sums = reinterpret_cast<float2*>(smem4);  // [teams][2 (row parity)][kMaxTeamWarps]
  float* comb = reinterpret_cast<float*>(sums + kMaxTeams * 2 * kMaxTeamWarps);  // [d], teams > 1
  const int teams = blockDim.x / team;
  const int tm = threadIdx.x / team, lt = threadIdx.x - tm * team;
  const int warps = team >> 5, wt = lt >> 5, lane = threadIdx.x & 31;
  const float inv_d = 1.f / static_cast<float>(d);

  float ds[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) ds[i][j] = 0.f;

  int parity = 0;
  for (int row = blockIdx.x * teams + tm; row < rows; row += gridDim.x * teams) {
    const size_t base = static_cast<size_t>(row) * d;
    float xv[VPT][VEC], gv[VPT][VEC];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * team + lt) * VEC;
      if (col < d) {
        load_vec<T, VEC>(x + base + col, xv[i]);
        load_vec<T, VEC>(dy + base + col, gv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xv[i][j] = gv[i][j] = 0.f;
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * team + lt) * VEC;
      float sc[VEC];
      if (col < d) {
        load_scale<VEC>(scale + col, sc);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sc[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ss = fmaf(xv[i][j], xv[i][j], ss);
        dot = fmaf(gv[i][j] * sc[j], xv[i][j], dot);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    // One barrier a row: the slots alternate with the row's parity, and a
    // team reaches the next row's barrier only after every warp has read.
    float2* slot = sums + (tm * 2 + parity) * kMaxTeamWarps;
    if (lane == 0) slot[wt] = make_float2(ss, dot);
    team_barrier(1 + tm, team);
    float2 s = make_float2(0.f, 0.f);
    for (int w = 0; w < warps; ++w) {
      s.x += slot[w].x;
      s.y += slot[w].y;
    }
    parity ^= 1;
    const float r = rsqrtf(s.x * inv_d + eps);
    const float m = r * s.y * inv_d;  // mean(dy·scale·x̂) = r·mean(dy·scale·x)
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * team + lt) * VEC;
      if (col < d) {
        float sc[VEC], out[VEC];
        load_scale<VEC>(scale + col, sc);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = xv[i][j] * r;
          out[j] = r * (gv[i][j] * sc[j] - xh * m);
          ds[i][j] = fmaf(gv[i][j], xh, ds[i][j]);
        }
        store_vec<T, VEC>(dx + base + col, out);
      }
    }
  }

  // The block's row of the partial: its teams' shares added in team order.
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  float* acc = teams == 1 ? out : comb;
  for (int k = 0; k < teams; ++k) {
    if (tm == k) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int col = (i * team + lt) * VEC;
        if (col < d) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[col + j] = k == 0 ? ds[i][j] : acc[col + j] + ds[i][j];
        }
      }
    }
    if (teams > 1) __syncthreads();
  }
  if (teams > 1)
    for (int c = threadIdx.x; c < d; c += blockDim.x) out[c] = comb[c];
}

// dscale[c] = Σ_b partial[b][c]: a block takes 32 columns, warp w adds the
// rows b ≡ w (mod 8) in order, then the eight warp sums are added in warp
// order (a fixed order: no atomics).
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                              int blocks, int d) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d)
    for (int b = warp; b < blocks; b += kWarps) s += partial[static_cast<size_t>(b) * d + c];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += sums[w][lane];
    dscale[c] = total;
  }
}

struct Plan {
  int vec, vpt, team, teams, blocks;
};

template <typename T, int VEC, int VPT>
cudaError_t launch_rows(const void* x, const float* scale, const void* dy, void* dx,
                        float* partial, int rows, int d, const Plan& p, float eps,
                        cudaStream_t stream) {
  const size_t smem = kMaxTeams * 2 * kMaxTeamWarps * sizeof(float2) +
                      (p.teams > 1 ? static_cast<size_t>(d) * sizeof(float) : 0);
  cudaError_t err = allow_shared_bytes(rmsnorm_bwd_rows_kernel<T, VEC, VPT>, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_rows_kernel<T, VEC, VPT><<<p.blocks, p.team * p.teams, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
      rows, d, p.team, eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_vpt(const void* x, const float* scale, const void* dy, void* dx,
                         float* partial, int rows, int d, const Plan& p, float eps,
                         cudaStream_t stream) {
  if (p.vpt * VEC > kMaxColumns || p.team * p.teams > max_block(p.vpt * VEC))
    return cudaErrorInvalidValue;
  switch (p.vpt) {
    case 1:
      return launch_rows<T, VEC, 1>(x, scale, dy, dx, partial, rows, d, p, eps, stream);
    case 2:
      return launch_rows<T, VEC, 2>(x, scale, dy, dx, partial, rows, d, p, eps, stream);
    case 4:
      return launch_rows<T, VEC, 4>(x, scale, dy, dx, partial, rows, d, p, eps, stream);
    case 8:
      if constexpr (8 * VEC <= kMaxColumns)
        return launch_rows<T, VEC, 8>(x, scale, dy, dx, partial, rows, d, p, eps, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const void* dy, void* dx, float* partial,
                   float* dscale, int rows, int d, const Plan& p, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  cudaError_t err;
  if (p.vpt == 0) {  // the rereading kernel
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    err = allow_shared_bytes(rmsnorm_bwd_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    rmsnorm_bwd_kernel<T><<<p.blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
        rows, d, eps);
    err = cudaGetLastError();
  } else if (p.vec == kVec && d % kVec == 0) {
    err = dispatch_vpt<T, kVec>(x, scale, dy, dx, partial, rows, d, p, eps, stream);
  } else if (p.vec == 1) {
    err = dispatch_vpt<T, 1>(x, scale, dy, dx, partial, rows, d, p, eps, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, kThreads, 0, stream>>>(partial, dscale, p.blocks, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, dy, dx: (rows, d), contiguous, of the storage type `dtype`; scale,
// dscale: (d,) float32; partial: (blocks, d) float32 scratch.  The plan
// (rmsnorm.py, backward_plan): vpt 0 takes the rereading kernel (256 threads
// a block, d * 4 bytes of shared memory: d <= 56832); else teams of `team`
// threads (a multiple of 32, at most 256), `teams` a block (at most 8, and
// team * teams <= 512, or 256 where vpt * vec = 32), each thread `vpt` (1, 2,
// 4 or 8) groups of `vec` columns (1, or 16 bytes of the storage type where
// d is a multiple of it and x, dy and scale start on 16-byte boundaries),
// vpt * vec <= 32, team * vpt * vec >= d.  Launches two kernels
// on `stream` and returns the first launch error (0 when both were accepted).
extern "C" int rmsnorm_bwd_launch(const void* x, const float* scale, const void* dy, void* dx,
                                  float* partial, float* dscale, int dtype, int rows, int d,
                                  float eps, int vec, int vpt, int team, int teams, int blocks,
                                  void* stream) {
  using namespace repro_torch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  if (vpt != 0 && (team <= 0 || team % 32 != 0 || team > 32 * kMaxTeamWarps || teams <= 0 ||
                   teams > kMaxTeams || static_cast<long long>(team) * vpt * vec < d))
    return cudaErrorInvalidValue;
  const Plan p{vec, vpt, team, teams, blocks};
  if (dtype == kFloat32) return launch<float>(x, scale, dy, dx, partial, dscale, rows, d, p, eps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, scale, dy, dx, partial, dscale, rows, d, p, eps, s);
  return cudaErrorInvalidValue;
}
