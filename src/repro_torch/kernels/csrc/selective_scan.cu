// Mamba's selective scan for Hopper (sm_90a), float32: for each (batch row,
// channel e) the recurrence over the positions t
//
//   h_t[n] = exp(A[e, n]·Δ_t[e])·h_{t-1}[n] + Δ_t[e]·x_t[e]·B_t[n],   h_{-1} = 0,
//   y_t[e] = (Σ_n C_t[n]·h_t[n] + D[e]·x_t[e]) · silu(z_t[e]),
//
// with A = −exp(a_log), written as y (B, S, E) and, where asked, the state
// after the last position (B, E, N), which a decode cache starts from.
//
// It replaces no TPU kernel: the JAX package computes the scan in jnp
// (repro.models.ssm), and the port's torch route is a log-depth doubling
// scan over (B, chunk, E, N) float32 tensors, copied at every doubling.
//
// What bounds it on the H100: bytes and the exponentials.  Every input is
// read once (x, Δ and z: B·S·E floats each; B and C: B·S·N) and y written
// once; a (position, channel) takes N exponentials and ~3N multiply-adds,
// against ~20 bytes moved.  The dependence runs along t only: one thread
// owns one channel's N states in registers (N independent chains, so the
// exponentials and multiply-adds of a position overlap) and walks the
// positions in order; a block is 64 channels of one batch row.  The
// positions come through shared memory in tiles of 32, by a two-stage ring
// of 16-byte cp.async copies (the next tile lands while this one is
// scanned): x, Δ and z as 32 rows of the block's 64 channels
// (conflict-free, one word a thread), B and C as 32 rows of N that every
// thread reads at the same address (a broadcast).  exp(A·Δ) is exp2 of
// (A·log2 e)·Δ, A scaled once a channel.
//
// One batch row of Hymba's E = 3200 is 50 blocks of 64 threads, which
// leave the card's 132 SMs mostly idle while each walks 2,176 positions;
// so S is cut into `chunks` runs (a multiple of 32 positions each, the
// launcher's plan) scanned side by side.  A first kernel scans every run
// but the last from h = 0 and writes its last state and its Σ Δ (the
// run's decay is exp(A·Σ Δ)); the second scans each run from the state
// it carries in, h_in(c) = exp(A·Σ Δ_{c−1})·h_in(c−1) + h_last_{c−1},
// folded over the runs before it in order, writes y and, for the last
// run, the state after the last position.  With one run the first kernel
// is not launched.  Rows past S and channels past E are zero-filled and
// never written.  The order of every sum is fixed: two calls give the
// same bits.

#include <cstddef>

#include "common.cuh"
#include "tensor_core.cuh"

namespace repro_torch {
namespace {

constexpr int kChannels = 64;  // threads (channels) a block
constexpr int kSteps = 32;     // positions a tile
constexpr int kStages = 2;

template <int N>
struct Layout {
  // A stage: x, Δ, z as [kSteps][kChannels], then B and C as [kSteps][2N].
  static constexpr int kStageFloats = 3 * kSteps * kChannels + kSteps * 2 * N;
  static constexpr size_t shared_bytes() {
    return static_cast<size_t>(kStages) * kStageFloats * sizeof(float);
  }
};

// Positions t0 .. min(t0 + kSteps, t_end) of the block's channels into
// stage `st`, as 16-byte copies shared by the block's threads.
template <int N>
__device__ __forceinline__ void load_tile(float* st, const float* x, const float* dt,
                                          const float* z, const float* bm, const float* cm, int t0,
                                          int t_end, int E, int e0) {
  constexpr int kChunksPerRow = kChannels / 4;
  float* xs = st;
  float* ds = xs + kSteps * kChannels;
  float* zs = ds + kSteps * kChannels;
  float* bc = zs + kSteps * kChannels;
  for (int i = threadIdx.x; i < kSteps * kChunksPerRow; i += kChannels) {
    const int r = i / kChunksPerRow;
    const int c = (i - r * kChunksPerRow) * 4;
    const bool in = t0 + r < t_end && e0 + c < E;
    const size_t off = in ? static_cast<size_t>(t0 + r) * E + e0 + c : 0;
    cp_async16(xs + r * kChannels + c, x + off, in);
    cp_async16(ds + r * kChannels + c, dt + off, in);
    cp_async16(zs + r * kChannels + c, z + off, in);
  }
  constexpr int kChunksPerState = N / 4;
  for (int i = threadIdx.x; i < kSteps * kChunksPerState; i += kChannels) {
    const int r = i / kChunksPerState;
    const int c = (i - r * kChunksPerState) * 4;
    const bool in = t0 + r < t_end;
    const size_t off = in ? static_cast<size_t>(t0 + r) * N + c : 0;
    cp_async16(bc + r * 2 * N + c, bm + off, in);
    cp_async16(bc + r * 2 * N + N + c, cm + off, in);
  }
}

// Positions [t_begin, t_end) of channel e0 + threadIdx.x from the state h.
// OUT: write y; else only advance h and add Δ into `dt_sum`.
template <int N, bool OUT>
__device__ __forceinline__ void scan_run(float* smem, const float* x, const float* dt,
                                         const float* z, const float* bm, const float* cm,
                                         float* y, const float (&a2)[N], float d, float (&h)[N],
                                         float& dt_sum, int t_begin, int t_end, int E, int e0,
                                         bool on) {
  using L = Layout<N>;
  const int e = e0 + threadIdx.x;
  const int tiles = (t_end - t_begin + kSteps - 1) / kSteps;
  load_tile<N>(smem, x, dt, z, bm, cm, t_begin, t_end, E, e0);
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    const int t0 = t_begin + it * kSteps;
    if (it + 1 < tiles) {
      load_tile<N>(smem + ((it + 1) % kStages) * L::kStageFloats, x, dt, z, bm, cm, t0 + kSteps,
                   t_end, E, e0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile landed for every thread
    const float* xs = smem + (it % kStages) * L::kStageFloats;
    const float* ds = xs + kSteps * kChannels;
    const float* zs = ds + kSteps * kChannels;
    const float* bc = zs + kSteps * kChannels;
    const int steps = min(kSteps, t_end - t0);
    // Unrolled, so that a position's exponentials issue while the one
    // before it finishes its states: only h carries from one to the next.
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float xv = xs[t * kChannels + threadIdx.x];
      const float dv = ds[t * kChannels + threadIdx.x];
      const float4* bt = reinterpret_cast<const float4*>(bc + t * 2 * N);
      const float dx = dv * xv;
      if constexpr (OUT) {
        const float4* ct = reinterpret_cast<const float4*>(bc + t * 2 * N + N);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // C·h in four partial sums, added in one order
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 bq = bt[q], cq = ct[q];
          const float bs[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cs[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * q + j;
            h[n] = fmaf(exp2f(a2[n] * dv), h[n], dx * bs[j]);
            acc[j] = fmaf(cs[j], h[n], acc[j]);
          }
        }
        const float zv = zs[t * kChannels + threadIdx.x];
        const float gate = __fdividef(zv, 1.f + __expf(-zv));  // silu(z)
        if (on) y[static_cast<size_t>(t0 + t) * E + e] = fmaf(d, xv, (acc[0] + acc[1]) + (acc[2] + acc[3])) * gate;
      } else {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 bq = bt[q];
          const float bs[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            h[4 * q + j] = fmaf(exp2f(a2[4 * q + j] * dv), h[4 * q + j], dx * bs[j]);
        }
        dt_sum += dv;
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
}

struct Args {
  const float *x, *dt, *bm, *cm, *z, *a_log, *d_skip;
  float *y, *h_last;
  float *run_h, *run_dt;  // the first kernel's: (B, chunks − 1, E, N) and (B, chunks − 1, E)
  int S, E, run_len, chunks;
};

// The channel's A·log2 e; the pointers moved to batch row b.  Whether the
// channel lies inside E.
template <int N>
__device__ __forceinline__ bool setup(Args& a, float (&a2)[N], int b, int e) {
  constexpr float kLog2e = 1.4426950408889634f;
  const bool on = e < a.E;
#pragma unroll
  for (int n = 0; n < N; ++n)
    a2[n] = on ? -expf(a.a_log[static_cast<size_t>(e) * N + n]) * kLog2e : 0.f;
  const size_t row = static_cast<size_t>(b) * a.S;
  a.x += row * a.E;
  a.dt += row * a.E;
  a.z += row * a.E;
  a.y += row * a.E;
  a.bm += row * N;
  a.cm += row * N;
  return on;
}

// Every run but the last, from h = 0: its last state and its Σ Δ.
template <int N>
__global__ void __launch_bounds__(kChannels) selective_scan_runs_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, c = blockIdx.z;
  const int e0 = blockIdx.x * kChannels, e = e0 + threadIdx.x;
  float a2[N], h[N];
  const bool on = setup<N>(a, a2, b, e);
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;
  float dt_sum = 0.f;
  const int t_begin = c * a.run_len;
  scan_run<N, false>(reinterpret_cast<float*>(smem4), a.x, a.dt, a.z, a.bm, a.cm, a.y, a2, 0.f, h,
                     dt_sum, t_begin, min(a.S, t_begin + a.run_len), a.E, e0, on);
  if (on) {
    const size_t i = (static_cast<size_t>(b) * (a.chunks - 1) + c) * a.E + e;
    a.run_dt[i] = dt_sum;
    float4* out = reinterpret_cast<float4*>(a.run_h + i * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) out[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

// Each run from the state it carries in: y, and the last run's last state.
template <int N>
__global__ void __launch_bounds__(kChannels) selective_scan_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, c = blockIdx.z;
  const int e0 = blockIdx.x * kChannels, e = e0 + threadIdx.x;
  float a2[N], h[N];
  const bool on = setup<N>(a, a2, b, e);
  const float d = on ? a.d_skip[e] : 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;
  if (on) {
    for (int r = 0; r < c; ++r) {  // fold the runs before this one, in order
      const size_t i = (static_cast<size_t>(b) * (a.chunks - 1) + r) * a.E + e;
      const float s = a.run_dt[i];
      const float4* hr = reinterpret_cast<const float4*>(a.run_h + i * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 v = hr[q];
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) h[4 * q + j] = fmaf(exp2f(a2[4 * q + j] * s), h[4 * q + j], vs[j]);
      }
    }
  }
  float unused = 0.f;
  const int t_begin = c * a.run_len;
  scan_run<N, true>(reinterpret_cast<float*>(smem4), a.x, a.dt, a.z, a.bm, a.cm, a.y, a2, d, h,
                    unused, t_begin, min(a.S, t_begin + a.run_len), a.E, e0, on);
  if (a.h_last != nullptr && on && c == a.chunks - 1) {
    float4* hl = reinterpret_cast<float4*>(a.h_last + (static_cast<size_t>(b) * a.E + e) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) hl[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <int N>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Layout<N>::shared_bytes();
  cudaError_t err = allow_shared_bytes(selective_scan_kernel<N>, smem);
  if (err == cudaSuccess) err = allow_shared_bytes(selective_scan_runs_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.E + kChannels - 1) / kChannels;
  if (a.chunks > 1) {
    selective_scan_runs_kernel<N><<<dim3(blocks, B, a.chunks - 1), kChannels, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  selective_scan_kernel<N><<<dim3(blocks, B, a.chunks), kChannels, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x, dt, z, y: (B, S, E); bm, cm: (B, S, N); a_log: (E, N); d_skip: (E,);
// h_last: (B, E, N) or null (not written); all float32, contiguous, on one
// device, 16-byte aligned; E a multiple of 4 and N = 16.  S is scanned as
// `chunks` runs of `run_len` positions (a multiple of 32; the last takes
// the rest); with chunks > 1, run_h: (B, chunks − 1, E, N) and run_dt: (B,
// chunks − 1, E) float32 scratch, else null.  Launches on `stream` and
// returns cudaGetLastError() (0 when the launches were accepted).
extern "C" int selective_scan_launch(const float* x, const float* dt, const float* bm,
                                     const float* cm, const float* z, const float* a_log,
                                     const float* d_skip, float* y, float* h_last, float* run_h,
                                     float* run_dt, int B, int S, int E, int N, int run_len,
                                     int chunks, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || E <= 0 || E % 4 != 0 || run_len <= 0 || run_len % kSteps != 0 ||
      chunks != (S + run_len - 1) / run_len ||
      (chunks > 1 && (run_h == nullptr || run_dt == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{x, dt, bm, cm, z, a_log, d_skip, y, h_last, run_h, run_dt, S, E, run_len, chunks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(a, B, s);
  return cudaErrorInvalidValue;
}
