// Flash attention (prefill) for Hopper (sm_90a): causal or full attention
// per (batch row, query head) with grouped-query KV heads, a per-row
// `lengths` mask and an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py, function
// flash_attention_pallas (body `_kernel`).  That kernel carried the
// online-softmax state (m, l, acc) across key blocks along the innermost,
// sequential grid axis.  Blocks on Hopper run in no order, so here one
// block owns a (batch row, head, 64-query tile) and loops over the key tiles
// itself; the state lives in registers.  The wrapper of the TPU kernel
// padded S up to the tile on the host; here the ragged tail of S is masked
// in the kernel and nothing is padded.
//
// What bounds it on the H100: operations.  At the serving path's shapes
// (S <= 256, hd = 64, float32) the kernel does ~S/2 multiply-adds per
// loaded element, above the ~20 float32 flops per byte at which the card
// stops waiting on memory; and float32 has no tensor-core path, so the
// ceiling is the 67 TFLOP/s of the SIMT cores.  What the design does about
// it: each K/V tile is loaded once into shared memory and reused by all 64
// query rows of the block, and the next tile's loads are in flight while
// the current one is computed on; each thread computes a 2-row by 8-key block of
// scores and a 2-row by hd/4 block of the output, so that one shared-memory
// load feeds four to eight multiply-adds (K is stored transposed and V in
// 16-byte chunks, read with 16-byte loads, without bank conflicts); four
// threads share a query row, so the row statistics need two warp shuffles
// and no barrier; and key tiles that the causal, window and length masks
// remove entirely are never visited.  Left for later: wgmma on bf16 tiles,
// TMA loads into a ring of shared-memory stages, and a persistent schedule.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;                 // query rows per block
constexpr int kBlockK = 32;                 // keys per tile
constexpr int kPerRow = 4;                  // threads sharing a query row
constexpr int kRowGroups = kThreads / kPerRow;  // 32: thread rows r and r + 32
constexpr int kCols = kBlockK / kPerRow;    // 8 consecutive keys per thread
constexpr int kKT = kBlockK + 4;            // row of the transposed K tile (16-byte aligned)
constexpr int kPS = kBlockK + 1;            // row of the probability tile

template <int HD>
constexpr size_t flash_shared_bytes() {
  return (static_cast<size_t>(kBlockQ) * (HD + 1)  // Q tile, padded rows
          + static_cast<size_t>(HD) * kKT          // K tile, transposed
          + static_cast<size_t>(kBlockK) * HD      // V tile
          + static_cast<size_t>(kBlockQ) * kPS) *  // probabilities
         sizeof(float);
}

struct Strides {
  long long b, h, s;  // the head dimension is contiguous
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q,  // (B, H, S, HD)
                           const T* __restrict__ k,  // (B, KV, S, HD)
                           const T* __restrict__ v,  // (B, KV, S, HD)
                           const int* __restrict__ lengths,  // (B,) or null: all S
                           T* __restrict__ out,       // (B, H, S, HD), contiguous
                           int H, int KV, int S, Strides sq, Strides sk, Strides sv,
                           int causal, int window, float sm_scale) {
  constexpr int QS = HD + 1;
  constexpr int NCH = HD / (4 * kPerRow);  // 16-byte chunks of the output each thread owns
  constexpr int LPT = kBlockK * HD / kThreads;  // K (and V) elements each thread loads per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                    // [kBlockQ][QS]
  float* kt_s = q_s + kBlockQ * QS;     // [HD][kKT]: kt_s[d * kKT + t] = K[t][d]
  float* v_s = kt_s + HD * kKT;         // [kBlockK][HD]
  float* p_s = v_s + kBlockK * HD;      // [kBlockQ][kPS]

  // Query tiles are rotated by head, so that neighbouring blocks, which the
  // block scheduler tends to deal to the same SM, walk causal key ranges
  // of different lengths.
  const int h = blockIdx.y;
  const int q0 = ((blockIdx.x + h) % gridDim.x) * kBlockQ;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int rg = tid / kPerRow;  // this thread's rows: rg and rg + kRowGroups
  const int sub = tid % kPerRow;
  const int qpos[2] = {q0 + rg, q0 + rg + kRowGroups};

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    q_s[r * QS + d] = q0 + r < S ? to_float(qb[(q0 + r) * sq.s + d]) : 0.f;
  }

  // Keys this tile of queries can see at all.
  int k_end = S;
  if (lengths != nullptr) k_end = min(k_end, max(lengths[b], 0));
  if (causal) k_end = min(k_end, min(q0 + kBlockQ, S));
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;

  float acc[2][NCH][4];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = acc[r][c][3] = 0.f;
  }

  // The next K/V tile is loaded into registers while this one is computed
  // on, so the loads' latency hides behind the multiply-adds.
  float k_next[LPT], v_next[LPT];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / HD;
      const int d = i - t * HD;
      const bool in = k0 + t < k_end;
      k_next[j] = in ? to_float(kb[(k0 + t) * sk.s + d]) : 0.f;
      v_next[j] = in ? to_float(vb[(k0 + t) * sv.s + d]) : 0.f;
    }
  };
  if (k_begin < k_end) load_tile(k_begin);

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed; q_s is ready
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / HD;
      const int d = i - t * HD;
      kt_s[d * kKT + t] = k_next[j];
      v_s[t * HD + d] = v_next[j];
    }
    __syncthreads();
    if (k0 + kBlockK < k_end) load_tile(k0 + kBlockK);

    // Scores of rows (rg, rg + 32) against keys sub*8 ... sub*8 + 7.
    float s[2][kCols];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < kCols; ++u) s[r][u] = 0.f;
    const float* q0r = q_s + rg * QS;
    const float* q1r = q_s + (rg + kRowGroups) * QS;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 ka = *reinterpret_cast<const float4*>(kt_s + d * kKT + sub * kCols);
      const float4 kb4 = *reinterpret_cast<const float4*>(kt_s + d * kKT + sub * kCols + 4);
      const float kd[kCols] = {ka.x, ka.y, ka.z, ka.w, kb4.x, kb4.y, kb4.z, kb4.w};
      const float a0 = q0r[d], a1 = q1r[d];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        s[0][u] = fmaf(a0, kd[u], s[0][u]);
        s[1][u] = fmaf(a1, kd[u], s[1][u]);
      }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int kpos = k0 + sub * kCols + u;
        bool ok = kpos < k_end;
        if (causal) ok = ok && kpos <= qpos[r];
        if (window > 0) ok = ok && kpos > qpos[r] - window;
        s[r][u] = ok ? s[r][u] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[r][u]);
      }
      // The row's kPerRow threads are neighbouring lanes of one warp.
#pragma unroll
      for (int o = 1; o < kPerRow; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
      float* pr = p_s + (rg + r * kRowGroups) * kPS + sub * kCols;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        // A masked key gives exactly 0, also while the whole row is masked
        // so far (m_new == kNegInf would make exp(0) = 1).
        const float p = s[r][u] > 0.5f * kNegInf ? expf(s[r][u] - m_new) : 0.f;
        pr[u] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < kPerRow; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[r] = expf(m[r] - m_new);
      l[r] = alpha[r] * l[r] + sum;
      m[r] = m_new;
    }
    __syncwarp();  // the rows' probabilities are in p_s

    // acc = alpha·acc + p·V over this thread's chunks sub, sub + 4, ...
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha[r];
    const float* p0r = p_s + rg * kPS;
    const float* p1r = p_s + (rg + kRowGroups) * kPS;
#pragma unroll 2
    for (int t = 0; t < kBlockK; ++t) {
      const float p0 = p0r[t], p1 = p1r[t];
      const float4* vr = reinterpret_cast<const float4*>(v_s + t * HD) + sub;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 vx = vr[c * kPerRow];
        acc[0][c][0] = fmaf(p0, vx.x, acc[0][c][0]);
        acc[0][c][1] = fmaf(p0, vx.y, acc[0][c][1]);
        acc[0][c][2] = fmaf(p0, vx.z, acc[0][c][2]);
        acc[0][c][3] = fmaf(p0, vx.w, acc[0][c][3]);
        acc[1][c][0] = fmaf(p1, vx.x, acc[1][c][0]);
        acc[1][c][1] = fmaf(p1, vx.y, acc[1][c][1]);
        acc[1][c][2] = fmaf(p1, vx.z, acc[1][c][2]);
        acc[1][c][3] = fmaf(p1, vx.w, acc[1][c][3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < S) {
      // A row with no valid key has l = 0 and acc = 0: it comes out as zeros.
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* orow = out + ((static_cast<size_t>(b) * H + h) * S + qpos[r]) * HD;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int d = (sub + c * kPerRow) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[d + e] = from_float<T>(acc[r][c][e] * inv);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int B, int H, int KV, int S, Strides sq, Strides sk, Strides sv, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = flash_shared_bytes<HD>();
  cudaError_t err = allow_shared_bytes(flash_attention_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), H, KV, S, sq, sk, sv, causal, window,
      1.f / std::sqrt(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* lengths,
                        void* out, int B, int H, int KV, int S, Strides sq, Strides sk,
                        Strides sv, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, B, H, KV, S, sq, sk, sv, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, B, H, KV, S, sq, sk, sv, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, B, H, KV, S, sq, sk, sv, causal, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, H, S, hd); k, v: (B, KV, S, hd), of the storage type `dtype`, with
// the head dimension contiguous and the other strides given in elements;
// lengths: (B,) int32 or null (every row has S keys); out: (B, H, S, hd),
// contiguous.  hd must be 32, 64 or 128.  Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const int* lengths, void* out, int dtype, int B, int H,
                                      int KV, int S, int hd, long long sqb, long long sqh,
                                      long long sqs, long long skb, long long skh,
                                      long long sks, long long svb, long long svh,
                                      long long svs, int causal, int window, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0) return cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs};
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k, v, lengths, out, B, H, KV, S, sq, sk, sv, causal, window,
                              st);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, lengths, out, B, H, KV, S, sq, sk, sv, causal,
                                      window, st);
  return cudaErrorInvalidValue;
}
