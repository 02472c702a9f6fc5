// Fused attention backward for Hopper (sm_90a): given q, k, v and the
// output cotangent do of o = softmax(q k^T) v (unscaled), compute dq, dk, dv.
//
// Replaces the Pallas TPU kernel tartangan_tpu/ops/pallas/attention.py:164
// (_attn_bwd_kernel, launched by _attn_bwd_impl at :223). Same function:
// exact row softmax recomputed from q and k, f32 math throughout,
// ds = p * (dp - sum_j dp p), outputs in the input dtype. q (B, Lq, Ck),
// k (B, Lk, Ck), v (B, Lk, Cv), do (B, Lq, Cv), all contiguous, f32 or bf16.
//
// What bounds it on the card: five products per (query, key) pair (s, dp,
// dq, dk, dv: 2 * (3 Ck + 2 Cv) flop) over Ck 8 / Cv 32 heads and long rows
// (Lq 4096, Lk 1024 in the '512thin' generator) while each input byte is
// read once: far right of the f32 ridge, so CUDA-core f32 FMA issue
// (67 TFLOP/s) bounds it, not memory. The plain PyTorch version writes and
// re-reads the (B, Lq, Lk) f32 p, dp and ds maps in device memory instead.
//
// Design. The TPU kernel holds all of K/V in VMEM beside a query tile and
// carries dk/dv in scratch from one q-tile grid step to the next, which
// works only because a TPU grid runs in order. CTAs run in parallel and in
// no order, so the work is split as FlashAttention-2 does, deterministic
// and without atomics, in four launches on one stream:
//   1. row pass: one thread per query row streams K/V with an online
//      softmax and writes lse (log2 domain, as the forward kernel) and
//      delta = sum_j p_ij dp_ij (= do_i . o_i);
//   2. dv pass: one thread per key row, one CTA per 128 keys and 32 output
//      columns, loops over every query tile: dv_j += p_ij do_i;
//   3. dk pass: one thread per key row loops over every query tile,
//      recomputes p and dp and accumulates dk_j += ds_ij q_i;
//   4. dq pass: one thread per query row loops over every key tile:
//      dq_i += ds_ij k_j.
// Each thread keeps its own row and accumulators in registers; the other
// operand streams through shared memory in 32-row tiles that every thread
// reads at the same address (a broadcast). Ragged Lq and Lk are masked (a
// padded key gets score -inf, a padded query lse +inf, so p = 0 there); Ck
// is zero-padded to the instantiated width (8..64), Cv to 32 or 128.
// Plain FMA loops only: no tensor cores, TMA or warp specialisation yet,
// and the row pass is work the bound does not count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // own rows per CTA, one per thread
constexpr int kTile = 32;      // streamed rows per shared-memory tile
constexpr int kChunkV = 32;    // v/do columns per chunk in passes 1 and 2
constexpr int kMaxCk = 64;
constexpr int kMaxCv = 128;
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

// rows [r0, r0 + kTile) x columns [c0, c0 + W) of a (rows, ld) matrix into
// shared memory as f32, zero past the ends
template <typename T, int W>
__device__ __forceinline__ void load_tile(float (*dst)[W], const T* src,
                                          int r0, int nrows, int c0,
                                          int ncols, int ld) {
  for (int i = threadIdx.x; i < kTile * W; i += kThreads) {
    const int r = i / W, c = i % W;
    dst[r][c] = (r0 + r < nrows && c0 + c < ncols)
                    ? to_float(src[static_cast<size_t>(r0 + r) * ld + c0 + c])
                    : 0.f;
  }
}

// own row of a (rows, ld) matrix, columns [c0, c0 + W), times scale
template <typename T, int W>
__device__ __forceinline__ void load_row(float* dst, const T* src, bool active,
                                         int row, int c0, int ncols, int ld,
                                         float scale) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    dst[c] = (active && c0 + c < ncols)
                 ? to_float(src[static_cast<size_t>(row) * ld + c0 + c]) * scale
                 : 0.f;
  }
}

// ---- pass 1: lse and delta per query row
template <typename T, int CK>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta, int lq,
                 int lk, int ck, int cv) {
  __shared__ __align__(16) float ks[kTile][CK];
  __shared__ __align__(16) float vs[kTile][kChunkV];
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < lq;
  const T* kb = k + static_cast<size_t>(b) * lk * ck;
  const T* vb = v + static_cast<size_t>(b) * lk * cv;

  float qr[CK];
  load_row<T, CK>(qr, q + static_cast<size_t>(b) * lq * ck, active, row, 0,
                  ck, ck, kLog2e);
  float lse2 = 0.f, dsum = 0.f;
  // every chunk of do columns sweeps all keys again with the same online
  // softmax (so the same m and l) and adds its share of delta
  for (int c0 = 0; c0 < cv; c0 += kChunkV) {
    float dr[kChunkV];
    load_row<T, kChunkV>(dr, dout + static_cast<size_t>(b) * lq * cv, active,
                         row, c0, cv, cv, 1.f);
    float m = -CUDART_INF_F, l = 0.f, acc = 0.f;
    for (int j0 = 0; j0 < lk; j0 += kTile) {
      const int nk = min(kTile, lk - j0);
      __syncthreads();
      load_tile<T, CK>(ks, kb, j0, lk, 0, ck, ck);
      load_tile<T, kChunkV>(vs, vb, j0, lk, c0, cv, cv);
      __syncthreads();
      float s[kTile];
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CK; ++c) dot = fmaf(qr[c], ks[j][c], dot);
        s[j] = j < nk ? dot : -CUDART_INF_F;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m, tile_max);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
      acc *= alpha;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float p = exp2f(s[j] - m_new);
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < kChunkV; ++c) dp = fmaf(dr[c], vs[j][c], dp);
        l += p;
        acc = fmaf(p, dp, acc);
      }
      m = m_new;
    }
    lse2 = m + log2f(l);
    dsum += acc / l;
  }
  if (active) {
    lse[static_cast<size_t>(b) * lq + row] = lse2;
    delta[static_cast<size_t>(b) * lq + row] = dsum;
  }
}

// ---- pass 2: dv_j = sum_i p_ij do_i, one chunk of 32 columns per CTA
template <typename T, int CK>
__global__ void __launch_bounds__(kThreads)
dv_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dv, int lq, int lk, int ck, int cv) {
  __shared__ __align__(16) float qs[kTile][CK];
  __shared__ __align__(16) float ds[kTile][kChunkV];
  __shared__ float ls[kTile];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kChunkV;
  const int row = blockIdx.x * kThreads + threadIdx.x;  // key row
  const bool active = row < lk;
  const T* qb = q + static_cast<size_t>(b) * lq * ck;
  const T* db = dout + static_cast<size_t>(b) * lq * cv;
  const float* lb = lse + static_cast<size_t>(b) * lq;

  float kr[CK];
  load_row<T, CK>(kr, k + static_cast<size_t>(b) * lk * ck, active, row, 0,
                  ck, ck, kLog2e);
  float acc[kChunkV];
#pragma unroll
  for (int c = 0; c < kChunkV; ++c) acc[c] = 0.f;

  for (int i0 = 0; i0 < lq; i0 += kTile) {
    __syncthreads();
    load_tile<T, CK>(qs, qb, i0, lq, 0, ck, ck);
    load_tile<T, kChunkV>(ds, db, i0, lq, c0, cv, cv);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      ls[threadIdx.x] = i < lq ? lb[i] : CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) s = fmaf(kr[c], qs[i][c], s);
      const float p = exp2f(s - ls[i]);
#pragma unroll
      for (int c = 0; c < kChunkV; ++c) acc[c] = fmaf(p, ds[i][c], acc[c]);
    }
  }
  if (active) {
    T* out = dv + (static_cast<size_t>(b) * lk + row) * cv;
#pragma unroll
    for (int c = 0; c < kChunkV; ++c) {
      if (c0 + c < cv) out[c0 + c] = from_float<T>(acc[c]);
    }
  }
}

// ---- pass 3: dk_j = sum_i ds_ij q_i, one thread per key row
template <typename T, int CK, int CV>
__global__ void __launch_bounds__(kThreads)
dk_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dk, int lq, int lk, int ck, int cv) {
  __shared__ __align__(16) float qs[kTile][CK];
  __shared__ __align__(16) float ds[kTile][CV];
  __shared__ float ls[kTile];
  __shared__ float dl[kTile];
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;  // key row
  const bool active = row < lk;
  const T* qb = q + static_cast<size_t>(b) * lq * ck;
  const T* db = dout + static_cast<size_t>(b) * lq * cv;
  const float* lb = lse + static_cast<size_t>(b) * lq;
  const float* deb = delta + static_cast<size_t>(b) * lq;

  float kr[CK], vr[CV], acc[CK];
  load_row<T, CK>(kr, k + static_cast<size_t>(b) * lk * ck, active, row, 0,
                  ck, ck, kLog2e);
  load_row<T, CV>(vr, v + static_cast<size_t>(b) * lk * cv, active, row, 0,
                  cv, cv, 1.f);
#pragma unroll
  for (int c = 0; c < CK; ++c) acc[c] = 0.f;

  for (int i0 = 0; i0 < lq; i0 += kTile) {
    __syncthreads();
    load_tile<T, CK>(qs, qb, i0, lq, 0, ck, ck);
    load_tile<T, CV>(ds, db, i0, lq, 0, cv, cv);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      ls[threadIdx.x] = i < lq ? lb[i] : CUDART_INF_F;
      dl[threadIdx.x] = i < lq ? deb[i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) s = fmaf(kr[c], qs[i][c], s);
      const float p = exp2f(s - ls[i]);
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < CV; ++c) dp = fmaf(vr[c], ds[i][c], dp);
      const float dsc = p * (dp - dl[i]);
#pragma unroll
      for (int c = 0; c < CK; ++c) acc[c] = fmaf(dsc, qs[i][c], acc[c]);
    }
  }
  if (active) {
    T* out = dk + (static_cast<size_t>(b) * lk + row) * ck;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      if (c < ck) out[c] = from_float<T>(acc[c]);
    }
  }
}

// ---- pass 4: dq_i = sum_j ds_ij k_j, one thread per query row
template <typename T, int CK, int CV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int lq, int lk, int ck, int cv) {
  __shared__ __align__(16) float ks[kTile][CK];
  __shared__ __align__(16) float vs[kTile][CV];
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < lq;
  const T* kb = k + static_cast<size_t>(b) * lk * ck;
  const T* vb = v + static_cast<size_t>(b) * lk * cv;

  float qr[CK], dr[CV], acc[CK];
  load_row<T, CK>(qr, q + static_cast<size_t>(b) * lq * ck, active, row, 0,
                  ck, ck, kLog2e);
  load_row<T, CV>(dr, dout + static_cast<size_t>(b) * lq * cv, active, row, 0,
                  cv, cv, 1.f);
  const size_t stat = static_cast<size_t>(b) * lq + row;
  const float lse2 = active ? lse[stat] : 0.f;
  const float dlt = active ? delta[stat] : 0.f;
#pragma unroll
  for (int c = 0; c < CK; ++c) acc[c] = 0.f;

  for (int j0 = 0; j0 < lk; j0 += kTile) {
    const int nk = min(kTile, lk - j0);
    __syncthreads();
    load_tile<T, CK>(ks, kb, j0, lk, 0, ck, ck);
    load_tile<T, CV>(vs, vb, j0, lk, 0, cv, cv);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) s = fmaf(qr[c], ks[j][c], s);
      const float p = j < nk ? exp2f(s - lse2) : 0.f;
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < CV; ++c) dp = fmaf(dr[c], vs[j][c], dp);
      const float dsc = p * (dp - dlt);
#pragma unroll
      for (int c = 0; c < CK; ++c) acc[c] = fmaf(dsc, ks[j][c], acc[c]);
    }
  }
  if (active) {
    T* out = dq + stat * ck;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      if (c < ck) out[c] = from_float<T>(acc[c]);
    }
  }
}

template <typename T, int CK, int CV>
cudaError_t launch_dk_dq(const T* q, const T* k, const T* v, const T* dout,
                         T* dq, T* dk, const float* lse, const float* delta,
                         int b, int lq, int lk, int ck, int cv,
                         cudaStream_t s) {
  dk_kernel<T, CK, CV><<<dim3((lk + kThreads - 1) / kThreads, b), kThreads, 0,
                         s>>>(q, k, v, dout, lse, delta, dk, lq, lk, ck, cv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, CK, CV><<<dim3((lq + kThreads - 1) / kThreads, b), kThreads, 0,
                         s>>>(q, k, v, dout, lse, delta, dq, lq, lk, ck, cv);
  return cudaGetLastError();
}

template <typename T, int CK>
cudaError_t launch_ck(const T* q, const T* k, const T* v, const T* dout,
                      T* dq, T* dk, T* dv, float* lse, float* delta, int b,
                      int lq, int lk, int ck, int cv, cudaStream_t s) {
  row_stats_kernel<T, CK><<<dim3((lq + kThreads - 1) / kThreads, b), kThreads,
                            0, s>>>(q, k, v, dout, lse, delta, lq, lk, ck, cv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dv_kernel<T, CK><<<dim3((lk + kThreads - 1) / kThreads,
                          (cv + kChunkV - 1) / kChunkV, b),
                     kThreads, 0, s>>>(q, k, dout, lse, dv, lq, lk, ck, cv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (cv <= 32) {
    return launch_dk_dq<T, CK, 32>(q, k, v, dout, dq, dk, lse, delta, b, lq,
                                   lk, ck, cv, s);
  }
  return launch_dk_dq<T, CK, kMaxCv>(q, k, v, dout, dq, dk, lse, delta, b, lq,
                                     lk, ck, cv, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                   float* delta, int b, int lq, int lk, int ck, int cv,
                   cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if (ck <= 8) {
    return launch_ck<T, 8>(qt, kt, vt, dt, dqt, dkt, dvt, lse, delta, b, lq,
                           lk, ck, cv, s);
  } else if (ck <= 16) {
    return launch_ck<T, 16>(qt, kt, vt, dt, dqt, dkt, dvt, lse, delta, b, lq,
                            lk, ck, cv, s);
  } else if (ck <= 32) {
    return launch_ck<T, 32>(qt, kt, vt, dt, dqt, dkt, dvt, lse, delta, b, lq,
                            lk, ck, cv, s);
  }
  return launch_ck<T, kMaxCk>(qt, kt, vt, dt, dqt, dkt, dvt, lse, delta, b,
                              lq, lk, ck, cv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are f32 scratch of
// B * Lq floats each, allocated by the caller. Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for shapes the kernels do not take.
extern "C" int tt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* dout, void* dq, void* dk, void* dv,
                                void* lse, void* delta, int b, int lq, int lk,
                                int ck, int cv, int dtype, void* stream) {
  if (b < 1 || b > 65535 || lq < 1 || lk < 1 || ck < 1 || ck > kMaxCk ||
      cv < 1 || cv > kMaxCv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(q, k, v, dout, dq, dk, dv, l, d, b,
                                            lq, lk, ck, cv, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          q, k, v, dout, dq, dk, dv, l, d, b, lq, lk, ck, cv, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
