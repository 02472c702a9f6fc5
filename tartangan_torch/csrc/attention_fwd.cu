// Fused attention forward: o = softmax(q k^T) v, unscaled, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tartangan_tpu/ops/pallas/attention.py:41
// (_attn_kernel, launched by _fused_attention_fwd_impl at :278). Same
// function: logits in f32, exact row softmax, f32 accumulation, output in
// the input dtype. q (B, Lq, Ck), k (B, Lk, Ck), v (B, Lk, Cv), all
// contiguous, f32 or bf16.
//
// What bounds it on the card: the SA-GAN shapes have narrow heads (Ck 8,
// Cv 32 in the '512thin' generator) and long rows (Lq 4096, Lk 1024), so
// each (query, key) pair costs Ck + Cv FMAs and one exp while each input
// byte is read once: ~400 flop per byte, far right of the f32 ridge. It is
// bound by CUDA-core f32 FMA issue (67 TFLOP/s), not by memory. The plain
// PyTorch version instead writes and re-reads the (B, Lq, Lk) f32 logits
// and probabilities in device memory (~1.3 GB at B = 25).
//
// Design. The TPU kernel holds all of K/V for a batch row in VMEM next to
// a 512-row query tile, which caps Lk at 4096. A Hopper SM has 227 KB of
// shared memory and far fewer registers per row, so instead:
//   - one CTA owns kBlockQ query rows of one batch element and one chunk of
//     kChunkV output columns; each thread owns one query row, keeping q
//     (pre-scaled by log2 e) and its output accumulator in registers;
//   - K/V stream through shared memory in kBlockK-key tiles (converted to
//     f32 on load), with an online softmax (running max m and running sum
//     l, rescaled once per tile), so any Lk works and nothing of size Lk
//     is ever stored;
//   - all threads read the same K/V element at the same time, so shared
//     memory serves each read as one broadcast;
//   - ragged Lq rows are masked on load/store, ragged Lk keys get a -inf
//     score; Ck is zero-padded to the instantiated width (8..64).
// Plain FMA loops only: no tensor cores, TMA or warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 128;  // query rows per CTA, one per thread
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr int kChunkV = 32;   // output columns per CTA
constexpr int kMaxCk = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int CK>
__global__ void __launch_bounds__(kBlockQ)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int lq,
                     int lk, int ck, int cv) {
  __shared__ __align__(16) float ks[kBlockK][CK];
  __shared__ __align__(16) float vs[kBlockK][kChunkV];

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kChunkV;
  const int nv = min(kChunkV, cv - c0);
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < lq;

  const T* qb = q + static_cast<size_t>(b) * lq * ck;
  const T* kb = k + static_cast<size_t>(b) * lk * ck;
  const T* vb = v + static_cast<size_t>(b) * lk * cv;

  // scores live in the log2 domain: exp(s - m) == exp2(s*log2e - m*log2e)
  float qr[CK];
#pragma unroll
  for (int c = 0; c < CK; ++c) {
    qr[c] = (active && c < ck)
                ? to_float(qb[static_cast<size_t>(row) * ck + c]) * kLog2e
                : 0.f;
  }
  float acc[kChunkV];
#pragma unroll
  for (int c = 0; c < kChunkV; ++c) acc[c] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int j0 = 0; j0 < lk; j0 += kBlockK) {
    const int nk = min(kBlockK, lk - j0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * CK; i += kBlockQ) {
      const int r = i / CK, c = i % CK;
      ks[r][c] = (r < nk && c < ck)
                     ? to_float(kb[static_cast<size_t>(j0 + r) * ck + c])
                     : 0.f;
    }
    for (int i = threadIdx.x; i < kBlockK * kChunkV; i += kBlockQ) {
      const int r = i / kChunkV, c = i % kChunkV;
      vs[r][c] = (r < nk && c < nv)
                     ? to_float(vb[static_cast<size_t>(j0 + r) * cv + c0 + c])
                     : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      s[j] = j < nk ? dot : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kChunkV; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunkV; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / l;
    T* orow = o + (static_cast<size_t>(b) * lq + row) * cv + c0;
#pragma unroll
    for (int c = 0; c < kChunkV; ++c) {
      if (c < nv) orow[c] = from_float<T>(acc[c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int lq, int lk, int ck, int cv, cudaStream_t stream) {
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, (cv + kChunkV - 1) / kChunkV,
                  b);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (ck <= 8) {
    attention_fwd_kernel<T, 8><<<grid, kBlockQ, 0, stream>>>(qt, kt, vt, ot, lq, lk, ck, cv);
  } else if (ck <= 16) {
    attention_fwd_kernel<T, 16><<<grid, kBlockQ, 0, stream>>>(qt, kt, vt, ot, lq, lk, ck, cv);
  } else if (ck <= 32) {
    attention_fwd_kernel<T, 32><<<grid, kBlockQ, 0, stream>>>(qt, kt, vt, ot, lq, lk, ck, cv);
  } else {
    attention_fwd_kernel<T, kMaxCk><<<grid, kBlockQ, 0, stream>>>(qt, kt, vt, ot, lq, lk, ck, cv);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int tt_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, int b, int lq, int lk, int ck, int cv,
                                int dtype, void* stream) {
  if (b < 1 || b > 65535 || lq < 1 || lk < 1 || ck < 1 || ck > kMaxCk ||
      cv < 1 || (cv + kChunkV - 1) / kChunkV > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(q, k, v, o, b, lq, lk, ck, cv, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(q, k, v, o, b, lq, lk, ck, cv, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
