// Fused attention forward for Hopper (sm_90a): o = softmax(q k^T) v,
// unscaled, and, where the caller passes an lse pointer (training), each
// row's log-sum-exp.
//
// Replaces the Pallas TPU kernel tartangan_tpu/ops/pallas/attention.py:41
// (_attn_kernel, launched by _fused_attention_fwd_impl at :278). Same
// function: logits in f32, exact row softmax, f32 accumulation, output in
// the input dtype. q (B, Lq, Ck), k (B, Lk, Ck), v (B, Lk, Cv), all
// contiguous, f32 or bf16; lse (B, Lq) f32 in the log2 domain, m + log2 l
// of the online softmax: the backward kernel (attention_bwd.cu) takes p
// from it instead of sweeping the keys again.
//
// What bounds it on the card: a (query, key) pair costs Ck + Cv FMAs (the
// score and p v) and one exp, and each input byte is read once. The
// '512thin' heads are narrow (Ck 8, Cv 32) and the rows long (G: B 64,
// Lq 4096, Lk 1024, 268 M pairs), so moving the bytes takes ~1/400 of the
// operations' time: CUDA-core f32 FMA issue (67 TFLOP/s at the 1980 MHz
// boost clock) bounds it, 0.32 ms at G. Float32 FMAs only, no TF32: the
// CLI's float32 is IEEE float32, and K1 is held to it.
//
// Design: as few instructions besides the FMAs as the registers allow.
//   - R query rows a thread (4 at the training shape G, 2 or 1 where fewer
//     rows must fill the card). Each K/V float read from shared memory, a
//     float4 broadcast (every lane of a warp reads one address), feeds R
//     rows' FMAs: a pair costs 40 FMAs, 10/R LDS.128, one max, one
//     ex2.approx.ftz (2 ulp; p under 2^-126 flushes to 0) and one add to l.
//     Each row's q (pre-scaled by log2 e), reference max m, sum l and 32
//     accumulators live in registers; keys are scored S at a time (8 at
//     R = 4: 254 registers, no spill).
//   - Lazy rescaling: the range's first key sets each row's m; a row
//     rescales (l and acc by 2^(m - m'), once per sub-tile of keys) only
//     when a score passes its m by more than kLazy, so p = 2^(s - m) stays
//     under 2^kLazy. o = acc / l and lse = m + log2 l do not depend on
//     which m was used, and -m starts each score's FMA chain. A build
//     without the max and the branch (unsafe: it never rescales) ran only
//     a few percent faster at G.
//   - K/V tiles of 64 keys (32 for Ck > 16) stream through a cp.async
//     double buffer: 16-byte copies, or 4-byte where Ck or Cv is not a
//     multiple of 4, zero fill past Lk, Ck and Cv; one barrier a tile, after
//     which the next tile's copy is issued, so it overlaps this tile's math.
//     A ragged last tile masks its keys' scores to -inf. bf16 stages
//     through registers (converted to f32).
//   - The CTA's shape is chosen at launch from B Lq (launch_ck): 512 rows
//     (R = 4) where that still gives three CTAs an SM (G), 128 rows (R = 2)
//     where that gives one CTA an SM (D, /grid), else 64 rows (R = 1) with
//     the keys split over a cluster of 2-8 CTAs until the CTAs outnumber
//     the SMs (/generate at B 1); the cluster merges its (m, l, acc)
//     through distributed shared memory in rank order. No atomics: repeats
//     are bit-identical. Cv above 32 takes more CTAs, 32 output columns
//     each, each scoring its keys again.
// What holds it at ~55 % of the FMA rate at G (device time from
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit) is not
// measured (no counters on the card): with 8 warps an SM, the latency of
// the shared-memory loads and of each sub-tile's max, branch and exp is the
// suspect.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunkV = 32;   // output columns per CTA
constexpr int kMaxCk = 64;
constexpr int kMaxSplit = 8;  // CTAs a cluster (the portable limit)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLazy = 8.f;  // rescale once a score passes m by this

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 2^x on the special-function unit; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + rows) of a matrix with row stride `stride`, its columns
// [0, ncols), into dst[rows][W] as f32, zero past nrows and ncols. f32:
// cp.async, 16 bytes a thread where vec (stride and ncols multiples of 4,
// src 16-byte aligned), else 4; bf16: loads converted to f32 and stored
template <typename T, int W, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int nrows, int stride,
                                           int ncols, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int C4 = W / 4;
      for (int i = threadIdx.x; i < rows * C4; i += NT) {
        const int r = i / C4, c = (i % C4) * 4;
        const bool ok = r0 + r < nrows && c < ncols;
        cp_async16(dst + r * W + c,
                   ok ? src + static_cast<size_t>(r0 + r) * stride + c : src,
                   ok);
      }
      return;
    }
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < nrows && c < ncols;
      cp_async4(dst + r * W + c,
                ok ? src + static_cast<size_t>(r0 + r) * stride + c : src,
                ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = i / W, c = i % W;
      dst[r * W + c] =
          (r0 + r < nrows && c < ncols)
              ? to_float(src[static_cast<size_t>(r0 + r) * stride + c])
              : 0.f;
    }
  }
}

// a CTA of NT threads, R query rows each, scoring S keys a sub-tile;
// SPLIT: the keys may be split over a cluster of CTAs that merge their
// partial rows
template <int CK, int R, int S_, int NT, bool SPLIT>
struct Cfg {
  static constexpr int TK = CK <= 16 ? 64 : 32;  // keys a tile
  static constexpr int S = S_;
  static constexpr int RB = R * NT;              // query rows a CTA
  static constexpr int STAGE = TK * (CK + kChunkV);
  static constexpr int PART = SPLIT ? RB * (kChunkV + 2) : 0;  // acc, m, l
  static constexpr int SMEM = 2 * STAGE > PART ? 2 * STAGE : PART;
  static_assert(TK % S == 0, "whole sub-tiles a tile");
  static_assert(SMEM * 4 <= 48 * 1024, "static shared memory");
  static_assert(!SPLIT || RB % kMaxSplit == 0, "rows split evenly");
};

// the keys [0, nk) of one staged tile against the thread's R rows: scores
// from -m, the lazy rescale, p = 2^s, l += p, acc += p v
template <int CK, int R, int S, int TK, bool RAGGED>
__device__ __forceinline__ void tile_math(const float* ks, const float* vs,
                                          int nk, const float (&qr)[R][CK],
                                          float (&m)[R], float (&l)[R],
                                          float (&acc)[R][kChunkV]) {
#pragma unroll 1
  for (int j0 = 0; j0 < TK; j0 += S) {
    if (RAGGED && j0 >= nk) break;
    float s[R][S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) s[r][u] = -m[r];
#pragma unroll
      for (int c = 0; c < CK; c += 4) {
        const float4 x = ld4(ks + (j0 + u) * CK + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][u] = fmaf(qr[r][c], x.x, s[r][u]);
          s[r][u] = fmaf(qr[r][c + 1], x.y, s[r][u]);
          s[r][u] = fmaf(qr[r][c + 2], x.z, s[r][u]);
          s[r][u] = fmaf(qr[r][c + 3], x.w, s[r][u]);
        }
      }
      if (RAGGED && j0 + u >= nk) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][u] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int u = 1; u < S; ++u) mx = fmaxf(mx, s[r][u]);
      if (mx > kLazy) {
        const float alpha = ex2(-mx);
        m[r] += mx;
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < kChunkV; ++c) acc[r][c] *= alpha;
#pragma unroll
        for (int u = 0; u < S; ++u) s[r][u] -= mx;
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = ex2(s[r][u]);
        l[r] += p[r];
      }
#pragma unroll
      for (int c = 0; c < kChunkV; c += 4) {
        const float4 x = ld4(vs + (j0 + u) * kChunkV + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][c] = fmaf(p[r], x.x, acc[r][c]);
          acc[r][c + 1] = fmaf(p[r], x.y, acc[r][c + 1]);
          acc[r][c + 2] = fmaf(p[r], x.z, acc[r][c + 2]);
          acc[r][c + 3] = fmaf(p[r], x.w, acc[r][c + 3]);
        }
      }
    }
  }
}

// o[row, c0 + c] = acc[c] * inv for c < nv: float4 stores where vec
template <typename T>
__device__ __forceinline__ void store_row(T* orow, const float* acc,
                                          float inv, int nv, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < kChunkV; c += 4) {
        if (c < nv) {
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv,
                          acc[c + 3] * inv);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < kChunkV; ++c) {
    if (c < nv) orow[c] = from_float<T>(acc[c] * inv);
  }
}

// grid: (row blocks x nsplit, Cv chunks, B); with nsplit > 1 the nsplit
// CTAs of a cluster take one row block and a share of the keys each
template <typename T, int CK, int R, int S_, int NT, int MINB, bool SPLIT>
__global__ void __launch_bounds__(NT, MINB)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int lq, int lk, int ck, int cv,
                     int nsplit, int vec_q, int vec_k, int vec_v, int vec_o) {
  using C = Cfg<CK, R, S_, NT, SPLIT>;
  constexpr int TK = C::TK, S = C::S;
  __shared__ __align__(16) float smem[C::SMEM];

  const int split = SPLIT ? blockIdx.x % nsplit : 0;
  const int rblock = SPLIT ? blockIdx.x / nsplit : blockIdx.x;
  const int c0 = blockIdx.y * kChunkV;
  const int nv = min(kChunkV, cv - c0);
  const int b = blockIdx.z;
  // this CTA's keys: whole tiles [t_beg, t_end), the last one maybe ragged
  const long long ntiles = (lk + TK - 1) / TK;
  const int t_beg = static_cast<int>(split * ntiles / nsplit);
  const int t_end = static_cast<int>((split + 1) * ntiles / nsplit);
  const int j_end =
      static_cast<int>(min(static_cast<long long>(lk), t_end * 1LL * TK));

  const T* qb = q + static_cast<size_t>(b) * lq * ck;
  const T* kb = k + static_cast<size_t>(b) * lk * ck;
  const T* vb = v + static_cast<size_t>(b) * lk * cv + c0;

  stage_rows<T, CK, NT>(smem, kb, t_beg * TK, TK, lk, ck, ck, vec_k);
  stage_rows<T, kChunkV, NT>(smem + TK * CK, vb, t_beg * TK, TK, lk, cv, nv,
                             vec_v);
  cp_async_commit();

  float qr[R][CK], acc[R][kChunkV], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = rblock * C::RB + r * NT + threadIdx.x;
    const bool active = row < lq;
    const T* qrow = qb + static_cast<size_t>(row) * ck;
    if constexpr (std::is_same<T, float>::value) {
      if (vec_q) {
#pragma unroll
        for (int c = 0; c < CK; c += 4) {
          const float4 x = (active && c < ck) ? ld4(qrow + c)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
          qr[r][c] = x.x * kLog2e;
          qr[r][c + 1] = x.y * kLog2e;
          qr[r][c + 2] = x.z * kLog2e;
          qr[r][c + 3] = x.w * kLog2e;
        }
      }
    }
    if (!std::is_same<T, float>::value || !vec_q) {
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        qr[r][c] = (active && c < ck) ? to_float(qrow[c]) * kLog2e : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunkV; ++c) acc[r][c] = 0.f;
    l[r] = 0.f;
  }

  for (int t = t_beg; t < t_end; ++t) {
    const int buf = (t - t_beg) & 1;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // everyone's; and tile t - 1's buffer is free
    if (t + 1 < t_end) {
      float* next = smem + (buf ^ 1) * C::STAGE;
      stage_rows<T, CK, NT>(next, kb, (t + 1) * TK, TK, lk, ck, ck, vec_k);
      stage_rows<T, kChunkV, NT>(next + TK * CK, vb, (t + 1) * TK, TK, lk, cv,
                                 nv, vec_v);
    }
    cp_async_commit();
    const float* ks = smem + buf * C::STAGE;
    const float* vs = ks + TK * CK;
    if (t == t_beg) {
      // the range's first key sets each row's reference max
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s0 = 0.f;
#pragma unroll
        for (int c = 0; c < CK; ++c) s0 = fmaf(qr[r][c], ks[c], s0);
        m[r] = s0;
      }
    }
    const int nk = min(TK, j_end - t * TK);
    if (nk == TK) {
      tile_math<CK, R, S, TK, false>(ks, vs, nk, qr, m, l, acc);
    } else {
      tile_math<CK, R, S, TK, true>(ks, vs, nk, qr, m, l, acc);
    }
  }

  if constexpr (SPLIT) {
    if (nsplit > 1) {
      // each CTA's partial rows into its shared memory; CTA `split` merges
      // its share of the block's rows from all nsplit, in rank order
      constexpr int W = kChunkV + 2;
      __syncthreads();  // every thread is done with the tiles
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* pr = smem + (r * NT + threadIdx.x) * W;
#pragma unroll
        for (int c = 0; c < kChunkV; ++c) pr[c] = acc[r][c];
        pr[kChunkV] = m[r];
        pr[kChunkV + 1] = l[r];
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const int per = C::RB / nsplit;
      for (int w = threadIdx.x; w < per * (kChunkV / 4); w += NT) {
        const int lr = split * per + w / (kChunkV / 4);
        const int c = (w % (kChunkV / 4)) * 4;
        const int row = rblock * C::RB + lr;
        if (row >= lq) continue;
        float mx = -CUDART_INF_F;
        for (int sr = 0; sr < nsplit; ++sr) {
          mx = fmaxf(mx, cluster.map_shared_rank(smem, sr)[lr * W + kChunkV]);
        }
        float lsum = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int sr = 0; sr < nsplit; ++sr) {
          const float* ps = cluster.map_shared_rank(smem, sr) + lr * W;
          const float sc = ex2(ps[kChunkV] - mx);
          lsum = fmaf(ps[kChunkV + 1], sc, lsum);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = fmaf(ps[c + i], sc, a[i]);
        }
        const float inv = 1.f / lsum;
        T* orow = o + (static_cast<size_t>(b) * lq + row) * cv + c0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c + i < nv) orow[c + i] = from_float<T>(a[i] * inv);
        }
        if (c == 0 && lse != nullptr && blockIdx.y == 0) {
          lse[static_cast<size_t>(b) * lq + row] = mx + log2f(lsum);
        }
      }
      cluster.sync();  // no CTA leaves while another reads its rows
      return;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = rblock * C::RB + r * NT + threadIdx.x;
    if (row < lq) {
      store_row<T>(o + (static_cast<size_t>(b) * lq + row) * cv + c0, acc[r],
                   1.f / l[r], nv, vec_o);
      // every column chunk has the same m and l; the first stores them
      if (lse != nullptr && blockIdx.y == 0) {
        lse[static_cast<size_t>(b) * lq + row] = m[r] + log2f(l[r]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int CK, int R, int S, int NT, int MINB, bool SPLIT>
cudaError_t launch_cfg(const T* q, const T* k, const T* v, T* o, float* lse,
                       int b, int lq, int lk, int ck, int cv, int nsplit,
                       cudaStream_t s) {
  constexpr int RB = R * NT;
  const bool f32 = std::is_same<T, float>::value;
  const int vec_q = f32 && ck % 4 == 0 && aligned16(q);
  const int vec_k = f32 && ck % 4 == 0 && aligned16(k);
  const int vec_v = f32 && cv % 4 == 0 && aligned16(v);
  const int vec_o = f32 && cv % 4 == 0 && aligned16(o);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((lq + RB - 1) / RB) * nsplit, (cv + kChunkV - 1) / kChunkV,
                     b);
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg,
                            attention_fwd_kernel<T, CK, R, S, NT, MINB, SPLIT>,
                            q, k, v, o, lse, lq, lk, ck, cv, nsplit, vec_q,
                            vec_k, vec_v, vec_o);
}

int sm_count() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename T, int CK>
cudaError_t launch_ck(const T* q, const T* k, const T* v, T* o, float* lse,
                      int b, int lq, int lk, int ck, int cv, cudaStream_t s) {
  const long long chunks = (cv + kChunkV - 1) / kChunkV;
  const long long sms = sm_count();
  auto ctas = [&](int rb) {
    return static_cast<long long>(b) * ((lq + rb - 1) / rb) * chunks;
  };
  if constexpr (CK <= 8) {
    // the SA-GAN heads. 4 rows a thread (254 registers, two CTAs an SM)
    // where that still makes three CTAs an SM's worth (G). Else 2 rows in
    // 64 threads (157 registers, six CTAs an SM) where that makes a CTA an
    // SM (D), but 4-key sub-tiles in 128 registers (eight CTAs an SM) where
    // six an SM would leave CTAs for a second round (/grid, B 25: 800)
    if (ctas(512) >= 3 * sms) {
      return launch_cfg<T, CK, 4, 8, 128, 2, false>(q, k, v, o, lse, b, lq,
                                                    lk, ck, cv, 1, s);
    }
    if (ctas(128) > 6 * sms) {
      return launch_cfg<T, CK, 2, 4, 64, 8, false>(q, k, v, o, lse, b, lq, lk,
                                                   ck, cv, 1, s);
    }
    if (ctas(128) >= sms) {
      return launch_cfg<T, CK, 2, 8, 64, 6, false>(q, k, v, o, lse, b, lq, lk,
                                                   ck, cv, 1, s);
    }
  }
  // one row a thread, 64 rows a CTA; the keys split over a cluster of CTAs
  // until the CTAs outnumber the SMs, each CTA keeping a tile or more
  using C = Cfg<CK, 1, 16, 64, true>;
  const long long ntiles = (lk + C::TK - 1) / C::TK;
  int nsplit = 1;
  while (nsplit < kMaxSplit && ctas(C::RB) * nsplit < sms &&
         2 * nsplit <= ntiles) {
    nsplit *= 2;
  }
  return launch_cfg<T, CK, 1, 16, 64, 4, true>(q, k, v, o, lse, b, lq, lk, ck,
                                               cv, nsplit, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int lq, int lk, int ck, int cv,
                   cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (ck <= 8) return launch_ck<T, 8>(qt, kt, vt, ot, lse, b, lq, lk, ck, cv, s);
  if (ck <= 16) {
    return launch_ck<T, 16>(qt, kt, vt, ot, lse, b, lq, lk, ck, cv, s);
  }
  if (ck <= 32) {
    return launch_ck<T, 32>(qt, kt, vt, ot, lse, b, lq, lk, ck, cv, s);
  }
  return launch_ck<T, kMaxCk>(qt, kt, vt, ot, lse, b, lq, lk, ck, cv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: (B, Lq) f32 output, or null to
// skip it. Returns a cudaError_t (0 on success); cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int tt_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int lq, int lk,
                                int ck, int cv, int dtype, void* stream) {
  if (b < 1 || b > 65535 || lq < 1 || lk < 1 || ck < 1 || ck > kMaxCk ||
      cv < 1 || (cv + kChunkV - 1) / kChunkV > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(q, k, v, o, l, b, lq, lk, ck, cv, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(q, k, v, o, l, b, lq, lk, ck, cv, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
