// Fused attention backward for Hopper (sm_90a): given q, k, v, the output
// cotangent do of o = softmax(q k^T) v (unscaled), and what the forward
// kernel (attention_fwd.cu) saved, o and lse, compute dq, dk, dv.
//
// Replaces the Pallas TPU kernel tartangan_tpu/ops/pallas/attention.py:164
// (_attn_bwd_kernel, launched by _attn_bwd_impl at :223). Same function:
// the exact row softmax, f32 math throughout, ds = p * (dp - delta),
// outputs in the input dtype. q (B, Lq, Ck), k (B, Lk, Ck), v (B, Lk, Cv),
// do and o (B, Lq, Cv), all contiguous, f32 or bf16; lse (B, Lq) f32 in the
// log2 domain (m + log2 l of the forward's online softmax).
//
// What bounds it on the card: per (query, key) pair the function needs
// five products (s, dp, dq, dk, dv: 3 Ck + 2 Cv FMAs) and each input byte
// once. The '512thin' shapes have narrow heads (Ck 8, Cv 32) and long rows:
// G B 64, Lq 4096, Lk 1024 (268 M pairs) and D B 64, Lq 1024, Lk 256
// (16.8 M pairs), ~100 FMAs a byte, so CUDA-core f32 FMA issue (67 TFLOP/s)
// bounds both, not memory: 0.705 ms at G, 0.044 ms at D. Float32 FMA only:
// TF32 mma would move the gradients by ~1e-3 of their max-abs.
//
// Design. The TPU kernel holds all of K/V in VMEM and carries dk/dv in
// scratch from one q-tile grid step to the next, which works only because
// a TPU grid runs in order. CTAs run in no order, so the work is split as
// FlashAttention-2's deterministic form does, with no atomics, in three
// launches on one stream:
//   1. delta pass: delta_i = do_i . o_i, Cv FMAs a row (one warp a row).
//      lse and o come from the forward kernel, so no pass sweeps the keys
//      to rebuild them.
//   2. dk/dv pass, 80 FMAs + 1 exp2 a pair: a thread keeps two keys' k
//      (scaled by log2 e), v, dk and dv in registers; four threads (one in
//      each of the CTA's four query groups) share a key. A CTA of 256
//      threads owns 128 keys where that still makes two CTAs an SM (G: 512
//      CTAs), else 128 threads own 64 (D, B 64 x Lk 256: 256 CTAs). Query
//      tiles (q, do, lse, delta) stream through shared memory, each group
//      taking a quarter of every tile. Per pair:
//      p = exp2(s - lse), dv += p do, dp = v . do, ds = p (dp - delta),
//      dk += ds q. The four partial dk/dv are summed in shared memory in a
//      fixed order at the end.
//   3. dq pass, 48 FMAs + 1 exp2 a pair: a thread keeps two query rows' q,
//      do, lse, delta and dq in registers and streams key tiles:
//      dq += ds k (256 rows a CTA, or 128 where that leaves fewer than two
//      CTAs an SM); for the narrow heads also sum ds, sum p and sum p k
//      (+Ck + 2), which replace delta with the one consistent with this
//      pass's p at the end (dq_kernel). A padded key carries a score bias
//      of -inf (p = 0). It
//      runs before the dk/dv pass, which may start on the SMs its last
//      wave leaves idle (programmatic dependent launch).
// 128 FMAs + 2 exp2 a pair in all, 138 with the narrow heads' delta fix
// (the bound counts 3 Ck + 2 Cv = 88: s and dp are computed in both
// passes). A thread takes 8 (dk/dv) or 4 (dq) (key, query) pairs a step
// and splits each Cv dot product into four partial sums, so a warp keeps
// 16 or more independent FMA chains in flight; the dk/dv pass also
// computes the next step's p during this step's FMAs. Staged rows are read
// as float4 broadcasts (every lane of a warp reads one address). Tiles are
// copied with cp.async (16 bytes a thread where a row is whole float4s and
// aligned, else 4) into a double buffer, so the next tile's copy overlaps
// this tile's math; copies past Lq, Lk, Ck or Cv zero-fill, and a padded
// query gets lse +inf (p = 0). bf16 inputs are staged through registers
// (converted to f32) instead: the main path is f32. Two keys or rows a
// thread halve the shared-memory reads a pair, at 255 (dk/dv) and ~170
// (dq) registers: 8 and 12 warps an SM. What holds the loops at ~55 % of
// the FMA rate with 80 % of their instructions FMAs is not measured (no
// profiler counters on the card): stalls on shared-memory reads with few
// warps are the suspect.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxCk = 64;
constexpr int kMaxCv = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRedW = 16;       // dk/dv pass: columns per reduction round
constexpr int kDeltaRows = 8;   // delta pass: rows per CTA, one a warp

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a (nrows, ncols) matrix into dst[rows][W] as f32,
// zero past nrows and ncols. f32: cp.async, 16 bytes a thread where vec
// (ncols a multiple of 4 and src 16-byte aligned), else 4; bf16: loads
// converted to f32 and stored
template <typename T, int W, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int nrows, int ncols,
                                           bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int C4 = W / 4;
      for (int i = threadIdx.x; i < rows * C4; i += NT) {
        const int r = i / C4, c = (i % C4) * 4;
        const bool ok = r0 + r < nrows && c < ncols;
        cp_async16(dst + r * W + c,
                   ok ? src + static_cast<size_t>(r0 + r) * ncols + c : src,
                   ok);
      }
      return;
    }
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = i / W, c = i % W;
      const bool ok = r0 + r < nrows && c < ncols;
      cp_async4(dst + r * W + c,
                ok ? src + static_cast<size_t>(r0 + r) * ncols + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = i / W, c = i % W;
      dst[r * W + c] =
          (r0 + r < nrows && c < ncols)
              ? to_float(src[static_cast<size_t>(r0 + r) * ncols + c])
              : 0.f;
    }
  }
}

// entries [r0, r0 + rows) of a length-n f32 vector, `fill` past n
template <int NT>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int rows, int n,
                                          float fill) {
  for (int i = threadIdx.x; i < rows; i += NT) {
    if (r0 + i < n) {
      cp_async4(dst + i, src + r0 + i, true);
    } else {
      dst[i] = fill;
    }
  }
}

// ---- pass 1: delta_i = do_i . o_i
template <typename T>
__global__ void __launch_bounds__(32 * kDeltaRows)
delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
             float* __restrict__ delta, int rows, int cv) {
  const int row = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp
  const size_t base = static_cast<size_t>(row) * cv;
  float s = 0.f;
  for (int c = lane; c < cv; c += 32) {
    s = fmaf(to_float(dout[base + c]), to_float(o[base + c]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) delta[row] = s;
}

// 2^x on the special-function unit; 2^-inf = 0, and results below 2^-126
// flush to 0 (they add nothing next to p's of order 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// programmatic dependent launch (sm_90): the dq pass lets the dk/dv pass,
// launched after it with programmatic stream serialization, start once
// every dq CTA has started, so dk/dv CTAs fill the SMs that dq's last wave
// leaves idle; the two passes read the same inputs and write disjoint
// outputs. The dk/dv pass waits for the dq pass's completion before it
// exits, so whatever follows on the stream sees both. No-ops in a launch
// without the attribute
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// four partial sums of a dot product, added in a fixed order
__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// ---- pass 2: dk and dv. A CTA of TPG x G threads owns TPG x NK keys: a
// thread owns NK of them, and G threads (one in each query group) share a
// key, each taking QS queries a step from its 1/G of every staged tile of
// TQ queries. PIPE: each step also computes the next step's p, so its
// loads and exp2 overlap this step's FMAs
template <int CK, int CV, int NK_, int QS_, int TPG_, int G_, int TQ_,
          bool PIPE_>
struct KV {
  static constexpr int NK = NK_, QS = QS_, TPG = TPG_, G = G_, TQ = TQ_;
  static constexpr bool PIPE = PIPE_;
  static constexpr int NT = TPG * G;        // threads per CTA
  static constexpr int KB = TPG * NK;       // keys per CTA
  static constexpr int QG = TQ / G;         // queries per thread per stage
  static constexpr int STAGE = TQ * (CK + CV + 2);  // q, do, lse, delta
  static constexpr int RED = NT * (kRedW + 1);
  static constexpr int SMEM = 2 * STAGE > RED ? 2 * STAGE : RED;
  static_assert(QG % QS == 0, "a thread takes whole steps");
  static_assert(TPG % 32 == 0, "a warp lies in one query group");
  static_assert(SMEM * 4 <= 48 * 1024, "static shared memory");
};

template <typename T, int CK, int CV, int TQ, int NT>
__device__ __forceinline__ void stage_q_tile(float* st, const T* qb,
                                             const T* db, const float* lb,
                                             const float* eb, int i0, int lq,
                                             int ck, int cv, bool vec_q,
                                             bool vec_do) {
  stage_rows<T, CK, NT>(st, qb, i0, TQ, lq, ck, vec_q);
  stage_rows<T, CV, NT>(st + TQ * CK, db, i0, TQ, lq, cv, vec_do);
  stage_vec<NT>(st + TQ * (CK + CV), lb, i0, TQ, lq, CUDART_INF_F);
  stage_vec<NT>(st + TQ * (CK + CV + 1), eb, i0, TQ, lq, 0.f);
}

// p = 2^(s - lse) of QS queries (rows of qs, entries of ls) against the
// thread's keys; -lse starts the sum
template <int CK, int NK, int QS>
__device__ __forceinline__ void kv_head(const float* qs, const float* ls,
                                        const float (&kr)[NK][CK],
                                        float (&p)[NK][QS]) {
#pragma unroll
  for (int u = 0; u < QS; ++u) {
    float s[NK][2];
    const float l = ls[u];
#pragma unroll
    for (int r = 0; r < NK; ++r) {
      s[r][0] = -l;
      s[r][1] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CK; c += 4) {
      const float4 x = ld4(qs + u * CK + c);
#pragma unroll
      for (int r = 0; r < NK; ++r) {
        s[r][0] = fmaf(kr[r][c], x.x, s[r][0]);
        s[r][1] = fmaf(kr[r][c + 1], x.y, s[r][1]);
        s[r][0] = fmaf(kr[r][c + 2], x.z, s[r][0]);
        s[r][1] = fmaf(kr[r][c + 3], x.w, s[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < NK; ++r) p[r][u] = ex2(s[r][0] + s[r][1]);
  }
}

// dv += p do, dp = v . do (four partial sums, -delta starting the first),
// ds = p (dp - delta), dk += ds q for QS queries
template <int CK, int CV, int NK, int QS>
__device__ __forceinline__ void kv_body(const float* qs, const float* dos,
                                        const float* es,
                                        const float (&p)[NK][QS],
                                        const float (&vr)[NK][CV],
                                        float (&dkr)[NK][CK],
                                        float (&dvr)[NK][CV]) {
  float dp[NK][QS][4];
#pragma unroll
  for (int u = 0; u < QS; ++u) {
    const float e = es[u];
#pragma unroll
    for (int r = 0; r < NK; ++r) {
      dp[r][u][0] = -e;
      dp[r][u][1] = dp[r][u][2] = dp[r][u][3] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < CV; c += 4) {
#pragma unroll
    for (int u = 0; u < QS; ++u) {
      const float4 x = ld4(dos + u * CV + c);
#pragma unroll
      for (int r = 0; r < NK; ++r) {
        dvr[r][c] = fmaf(p[r][u], x.x, dvr[r][c]);
        dvr[r][c + 1] = fmaf(p[r][u], x.y, dvr[r][c + 1]);
        dvr[r][c + 2] = fmaf(p[r][u], x.z, dvr[r][c + 2]);
        dvr[r][c + 3] = fmaf(p[r][u], x.w, dvr[r][c + 3]);
        dp[r][u][0] = fmaf(vr[r][c], x.x, dp[r][u][0]);
        dp[r][u][1] = fmaf(vr[r][c + 1], x.y, dp[r][u][1]);
        dp[r][u][2] = fmaf(vr[r][c + 2], x.z, dp[r][u][2]);
        dp[r][u][3] = fmaf(vr[r][c + 3], x.w, dp[r][u][3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QS; ++u) {
    float ds[NK];
#pragma unroll
    for (int r = 0; r < NK; ++r) ds[r] = p[r][u] * sum4(dp[r][u]);
#pragma unroll
    for (int c = 0; c < CK; c += 4) {
      const float4 x = ld4(qs + u * CK + c);
#pragma unroll
      for (int r = 0; r < NK; ++r) {
        dkr[r][c] = fmaf(ds[r], x.x, dkr[r][c]);
        dkr[r][c + 1] = fmaf(ds[r], x.y, dkr[r][c + 1]);
        dkr[r][c + 2] = fmaf(ds[r], x.z, dkr[r][c + 2]);
        dkr[r][c + 3] = fmaf(ds[r], x.w, dkr[r][c + 3]);
      }
    }
  }
}

// the G partial rows of TPG keys (one a thread of each group), summed in
// group order and stored: key r of the block is out row row0 + r, r < nrows
template <typename T, int W, int TPG, int G>
__device__ __forceinline__ void reduce_store(float* red, const float (&acc)[W],
                                             T* out, size_t row0, int nrows,
                                             int ncols, int kt, int grp) {
  constexpr int RW = W < kRedW ? W : kRedW;
  constexpr int RS = RW + 1;  // odd stride: a warp's 32 keys, 32 banks
#pragma unroll
  for (int c0 = 0; c0 < W; c0 += RW) {
#pragma unroll
    for (int e = 0; e < RW; ++e) red[(grp * TPG + kt) * RS + e] = acc[c0 + e];
    __syncthreads();
    for (int i = threadIdx.x; i < TPG * RW; i += TPG * G) {
      const int r = i / RW, e = i % RW;
      if (r < nrows && c0 + e < ncols) {
        float s = red[r * RS + e];
#pragma unroll
        for (int g = 1; g < G; ++g) s += red[(g * TPG + r) * RS + e];
        out[(row0 + r) * ncols + c0 + e] = from_float<T>(s);
      }
    }
    __syncthreads();
  }
}

template <typename T, int CK, int CV, class L>
__global__ void __launch_bounds__(L::NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int lq, int lk, int ck,
            int cv, int vec_q, int vec_do) {
  constexpr int NK = L::NK, QS = L::QS, G = L::G;
  __shared__ __align__(16) float smem[L::SMEM];
  const int grp = threadIdx.x / L::TPG, kt = threadIdx.x % L::TPG;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * L::KB;
  const T* qb = q + static_cast<size_t>(b) * lq * ck;
  const T* db = dout + static_cast<size_t>(b) * lq * cv;
  const float* lb = lse + static_cast<size_t>(b) * lq;
  const float* eb = delta + static_cast<size_t>(b) * lq;

  float kr[NK][CK], vr[NK][CV], dkr[NK][CK], dvr[NK][CV];
#pragma unroll
  for (int r = 0; r < NK; ++r) {
    const int j = j0 + kt + r * L::TPG;
    const bool active = j < lk;
    const T* kj = k + (static_cast<size_t>(b) * lk + j) * ck;
    const T* vj = v + (static_cast<size_t>(b) * lk + j) * cv;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      kr[r][c] = (active && c < ck) ? to_float(kj[c]) * kLog2e : 0.f;
      dkr[r][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      vr[r][c] = (active && c < cv) ? to_float(vj[c]) : 0.f;
      dvr[r][c] = 0.f;
    }
  }

  const int ntiles = (lq + L::TQ - 1) / L::TQ;
  const int i_beg = grp * L::QG, i_end = i_beg + L::QG;
  stage_q_tile<T, CK, CV, L::TQ, L::NT>(smem, qb, db, lb, eb, 0, lq, ck, cv, vec_q,
                                 vec_do);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_q_tile<T, CK, CV, L::TQ, L::NT>(smem + ((t + 1) & 1) * L::STAGE, qb, db,
                                     lb, eb, (t + 1) * L::TQ, lq, ck, cv,
                                     vec_q, vec_do);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // and everyone's
    const float* qs = smem + (t & 1) * L::STAGE;
    const float* dos = qs + L::TQ * CK;
    const float* ls = dos + L::TQ * CV;
    const float* es = ls + L::TQ;
    float p[NK][QS];
    if constexpr (L::PIPE) {
      kv_head<CK, NK, QS>(qs + i_beg * CK, ls + i_beg, kr, p);
    }
#pragma unroll 1
    for (int i = i_beg; i < i_end; i += QS) {
      if constexpr (L::PIPE) {
        // the next step's p (the last step recomputes its own)
        const int n = min(i + QS, i_end - QS);
        float pn[NK][QS];
        kv_head<CK, NK, QS>(qs + n * CK, ls + n, kr, pn);
        kv_body<CK, CV, NK, QS>(qs + i * CK, dos + i * CV, es + i, p, vr,
                                dkr, dvr);
#pragma unroll
        for (int r = 0; r < NK; ++r) {
#pragma unroll
          for (int u = 0; u < QS; ++u) p[r][u] = pn[r][u];
        }
      } else {
        kv_head<CK, NK, QS>(qs + i * CK, ls + i, kr, p);
        kv_body<CK, CV, NK, QS>(qs + i * CK, dos + i * CV, es + i, p, vr,
                                dkr, dvr);
      }
    }
    __syncthreads();  // tile t read: its buffer takes tile t + 2
  }

#pragma unroll
  for (int r = 0; r < NK; ++r) {
    const int r0 = j0 + r * L::TPG;
    const size_t row0 = static_cast<size_t>(b) * lk + r0;
    const int nrows = min(L::TPG, lk - r0);
    reduce_store<T, CK, L::TPG, G>(smem, dkr[r], dk, row0, nrows, ck, kt,
                                   grp);
    reduce_store<T, CV, L::TPG, G>(smem, dvr[r], dv, row0, nrows, cv, kt,
                                   grp);
  }
  griddep_wait();  // the dq pass is complete and visible
}

// ---- pass 3: dq. A CTA of NT threads owns NT x NQ query rows: a thread
// owns NQ of them and takes KS keys a step from every staged tile of TK
// keys
template <int CK, int CV, int NQ_, int KS_, int NT_, int TK_>
struct QT {
  static constexpr int NQ = NQ_, KS = KS_, NT = NT_, TK = TK_;
  static constexpr int STAGE = TK * (CK + CV + 1);  // k, v, score bias
  static_assert(TK % KS == 0, "whole steps a tile");
};

template <typename T, int CK, int CV, int TK, int NT>
__device__ __forceinline__ void stage_k_tile(float* st, const T* kb,
                                             const T* vb, int j0, int lk,
                                             int ck, int cv, bool vec_k,
                                             bool vec_v) {
  stage_rows<T, CK, NT>(st, kb, j0, TK, lk, ck, vec_k);
  stage_rows<T, CV, NT>(st + TK * CK, vb, j0, TK, lk, cv, vec_v);
  float* bias = st + TK * (CK + CV);
  for (int i = threadIdx.x; i < TK; i += NT) {
    bias[i] = j0 + i < lk ? 0.f : -CUDART_INF_F;
  }
}

// p = 2^(s - lse) of KS keys (rows of ks, entries of bias: -inf past Lk)
// against the thread's queries
template <int CK, int NQ, int KS>
__device__ __forceinline__ void q_head(const float* ks, const float* bias,
                                       const float (&qr)[NQ][CK],
                                       const float (&lse2)[NQ],
                                       float (&p)[NQ][KS]) {
#pragma unroll
  for (int u = 0; u < KS; ++u) {
    float s[NQ][2];
    const float bu = bias[u];
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      s[r][0] = -lse2[r];
      s[r][1] = bu;
    }
#pragma unroll
    for (int c = 0; c < CK; c += 4) {
      const float4 x = ld4(ks + u * CK + c);
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        s[r][0] = fmaf(qr[r][c], x.x, s[r][0]);
        s[r][1] = fmaf(qr[r][c + 1], x.y, s[r][1]);
        s[r][0] = fmaf(qr[r][c + 2], x.z, s[r][0]);
        s[r][1] = fmaf(qr[r][c + 3], x.w, s[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < NQ; ++r) p[r][u] = ex2(s[r][0] + s[r][1]);
  }
}

// dp = do . v (four partial sums, -delta starting the first),
// ds = p (dp - delta), dq += ds k for KS keys; with FIX, also the sums of
// ds, of p and of p k that correct delta at the end (dq_kernel)
template <int CK, int CV, int NQ, int KS, bool FIX>
__device__ __forceinline__ void q_body(const float* ks, const float* vs,
                                       const float (&p)[NQ][KS],
                                       const float (&dr)[NQ][CV],
                                       const float (&dlt)[NQ],
                                       float (&acc)[NQ][CK],
                                       float (&esum)[NQ], float (&psum)[NQ],
                                       float (&kbar)[NQ][CK]) {
  float dp[NQ][KS][4];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      dp[r][u][0] = -dlt[r];
      dp[r][u][1] = dp[r][u][2] = dp[r][u][3] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < CV; c += 4) {
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const float4 x = ld4(vs + u * CV + c);
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        dp[r][u][0] = fmaf(dr[r][c], x.x, dp[r][u][0]);
        dp[r][u][1] = fmaf(dr[r][c + 1], x.y, dp[r][u][1]);
        dp[r][u][2] = fmaf(dr[r][c + 2], x.z, dp[r][u][2]);
        dp[r][u][3] = fmaf(dr[r][c + 3], x.w, dp[r][u][3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KS; ++u) {
    float ds[NQ];
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      ds[r] = p[r][u] * sum4(dp[r][u]);
      if constexpr (FIX) {
        esum[r] += ds[r];
        psum[r] += p[r][u];
      }
    }
#pragma unroll
    for (int c = 0; c < CK; c += 4) {
      const float4 x = ld4(ks + u * CK + c);
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        acc[r][c] = fmaf(ds[r], x.x, acc[r][c]);
        acc[r][c + 1] = fmaf(ds[r], x.y, acc[r][c + 1]);
        acc[r][c + 2] = fmaf(ds[r], x.z, acc[r][c + 2]);
        acc[r][c + 3] = fmaf(ds[r], x.w, acc[r][c + 3]);
        if constexpr (FIX) {
          kbar[r][c] = fmaf(p[r][u], x.x, kbar[r][c]);
          kbar[r][c + 1] = fmaf(p[r][u], x.y, kbar[r][c + 1]);
          kbar[r][c + 2] = fmaf(p[r][u], x.z, kbar[r][c + 2]);
          kbar[r][c + 3] = fmaf(p[r][u], x.w, kbar[r][c + 3]);
        }
      }
    }
  }
}

// delta = do . o comes from the forward's o, which carries that kernel's
// rounding (its sums over the keys run in one order per row: at Lk 16384
// o is ~3e-5 of its max-abs off float64). dq = sum_j p (dp - delta) k
// cancels to a small value, so an error e in delta moves dq by e sum_j p k:
// 1.2e-4 of dq's max-abs at Lk 16384, against 4e-6 for the plain version,
// whose delta is sum_j p dp. With FIX (the narrow heads, whose rows run
// longest) the pass also sums ds, p and p k, and ends with
// dq -= (sum ds / sum p) sum p k: delta replaced by the one consistent with
// this pass's p, sum p dp / sum p. The dk/dv pass keeps do . o: there an
// error of one row's delta is one term of dk's sum over the rows.
template <typename T, int CK, int CV, class L>
__global__ void __launch_bounds__(L::NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int lq, int lk, int ck, int cv, int vec_k,
          int vec_v) {
  constexpr int NQ = L::NQ, KS = L::KS, TK = L::TK;
  constexpr bool FIX = CK + CV <= 64;
  __shared__ __align__(16) float smem[2 * L::STAGE];
  griddep_launch_dependents();
  const int b = blockIdx.y;
  const T* kb = k + static_cast<size_t>(b) * lk * ck;
  const T* vb = v + static_cast<size_t>(b) * lk * cv;

  float qr[NQ][CK], dr[NQ][CV], acc[NQ][CK], lse2[NQ], dlt[NQ];
  float esum[NQ], psum[NQ], kbar[NQ][CK];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    const int row = (blockIdx.x * NQ + r) * L::NT + threadIdx.x;
    const bool active = row < lq;
    const size_t qrow = static_cast<size_t>(b) * lq + row;
    esum[r] = psum[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      qr[r][c] =
          (active && c < ck) ? to_float(q[qrow * ck + c]) * kLog2e : 0.f;
      acc[r][c] = kbar[r][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      dr[r][c] = (active && c < cv) ? to_float(dout[qrow * cv + c]) : 0.f;
    }
    lse2[r] = active ? lse[qrow] : 0.f;
    dlt[r] = active ? delta[qrow] : 0.f;
  }

  const int ntiles = (lk + TK - 1) / TK;
  stage_k_tile<T, CK, CV, TK, L::NT>(smem, kb, vb, 0, lk, ck, cv, vec_k, vec_v);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage_k_tile<T, CK, CV, TK, L::NT>(smem + ((t + 1) & 1) * L::STAGE, kb, vb,
                                  (t + 1) * TK, lk, ck, cv, vec_k, vec_v);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = smem + (t & 1) * L::STAGE;
    const float* vs = ks + TK * CK;
    const float* bias = vs + TK * CV;
#pragma unroll 1
    for (int jj = 0; jj < TK; jj += KS) {
      float p[NQ][KS];
      q_head<CK, NQ, KS>(ks + jj * CK, bias + jj, qr, lse2, p);
      q_body<CK, CV, NQ, KS, FIX>(ks + jj * CK, vs + jj * CV, p, dr, dlt,
                                  acc, esum, psum, kbar);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    const int row = (blockIdx.x * NQ + r) * L::NT + threadIdx.x;
    if (FIX && psum[r] > 0.f) {
      const float fix = esum[r] / psum[r];
#pragma unroll
      for (int c = 0; c < CK; ++c) acc[r][c] = fmaf(-fix, kbar[r][c], acc[r][c]);
    }
    if (row < lq) {
      T* out = dq + (static_cast<size_t>(b) * lq + row) * ck;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        if (c < ck) out[c] = from_float<T>(acc[r][c]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int CK, int CV, class L>
cudaError_t launch_dkdv(const T* q, const T* k, const T* v, const T* dout,
                        const float* lse, const float* delta, T* dk, T* dv,
                        int b, int lq, int lk, int ck, int cv, int vec_q,
                        int vec_do, cudaStream_t s) {
  // launched after the dq pass, allowed to overlap its tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((lk + L::KB - 1) / L::KB, b);
  cfg.blockDim = dim3(L::NT);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dkdv_kernel<T, CK, CV, L>, q, k, v, dout,
                            lse, delta, dk, dv, lq, lk, ck, cv, vec_q,
                            vec_do);
}

template <typename T, int CK, int CV, class L>
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dq, int b,
                      int lq, int lk, int ck, int cv, int vec_k, int vec_v,
                      cudaStream_t s) {
  constexpr int RB = L::NT * L::NQ;
  dq_kernel<T, CK, CV, L><<<dim3((lq + RB - 1) / RB, b), L::NT, 0, s>>>(
      q, k, v, dout, lse, delta, dq, lq, lk, ck, cv, vec_k, vec_v);
  return cudaGetLastError();
}

template <typename T, int CK, int CV>
cudaError_t launch_passes(const T* q, const T* k, const T* v, const T* dout,
                          const float* lse, const float* delta, T* dq, T* dk,
                          T* dv, int b, int lq, int lk, int ck, int cv,
                          cudaStream_t s) {
  const int vec_q = ck % 4 == 0 && aligned16(q);
  const int vec_k = ck % 4 == 0 && aligned16(k);
  const int vec_v = cv % 4 == 0 && aligned16(v);
  const int vec_do = cv % 4 == 0 && aligned16(dout);
  // the SA-GAN heads (Ck 8, Cv 32): two keys a thread (255 registers: 8
  // warps an SM) and two query rows a thread (~170: 12 warps). A CTA takes
  // 128 keys (256 threads) or 256 query rows (128 threads) where that still
  // gives two CTAs an SM, else half: B 64 x Lk 256 gets 256 dk/dv CTAs of 64
  // keys. Wider heads: one key or row a thread, for the registers
  if constexpr (CK + CV <= 64) {
    constexpr int kTwoPerSM = 2 * 132;
    using KVBig = KV<CK, CV, 2, 4, 64, 4, 128, true>;
    using KVSmall = KV<CK, CV, 2, 4, 32, 4, 128, true>;
    using QBig = QT<CK, CV, 2, 2, 128, 32>;
    using QSmall = QT<CK, CV, 2, 2, 64, 32>;
    const bool kv_big =
        static_cast<long long>((lk + KVBig::KB - 1) / KVBig::KB) * b >=
        kTwoPerSM;
    const bool q_big =
        static_cast<long long>((lq + 2 * QBig::NT - 1) / (2 * QBig::NT)) * b >=
        kTwoPerSM;
    const cudaError_t err =
        q_big ? launch_dq<T, CK, CV, QBig>(q, k, v, dout, lse, delta, dq, b,
                                           lq, lk, ck, cv, vec_k, vec_v, s)
              : launch_dq<T, CK, CV, QSmall>(q, k, v, dout, lse, delta, dq, b,
                                             lq, lk, ck, cv, vec_k, vec_v, s);
    if (err != cudaSuccess) return err;
    return kv_big ? launch_dkdv<T, CK, CV, KVBig>(q, k, v, dout, lse, delta, dk,
                                                  dv, b, lq, lk, ck, cv, vec_q,
                                                  vec_do, s)
                  : launch_dkdv<T, CK, CV, KVSmall>(q, k, v, dout, lse, delta,
                                                    dk, dv, b, lq, lk, ck, cv,
                                                    vec_q, vec_do, s);
  } else {
    using KVL = KV<CK, CV, 1, 4, 64, 4, 16, false>;
    using QL = QT<CK, CV, 1, 4, 128, 16>;
    const cudaError_t err = launch_dq<T, CK, CV, QL>(
        q, k, v, dout, lse, delta, dq, b, lq, lk, ck, cv, vec_k, vec_v, s);
    if (err != cudaSuccess) return err;
    return launch_dkdv<T, CK, CV, KVL>(q, k, v, dout, lse, delta, dk, dv, b,
                                       lq, lk, ck, cv, vec_q, vec_do, s);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* o, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int b, int lq,
                   int lk, int ck, int cv, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  const int rows = b * lq;
  delta_kernel<T><<<(rows + kDeltaRows - 1) / kDeltaRows, 32 * kDeltaRows, 0,
                    s>>>(dt, static_cast<const T*>(o), delta, rows, cv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Cv 32 only beside Ck 8 (the SA-GAN heads); wider heads pad Cv to 128
  if (ck <= 8 && cv <= 32) {
    return launch_passes<T, 8, 32>(qt, kt, vt, dt, lse, delta, dqt, dkt, dvt,
                                   b, lq, lk, ck, cv, s);
  } else if (ck <= 8) {
    return launch_passes<T, 8, kMaxCv>(qt, kt, vt, dt, lse, delta, dqt, dkt,
                                       dvt, b, lq, lk, ck, cv, s);
  } else if (ck <= 16) {
    return launch_passes<T, 16, kMaxCv>(qt, kt, vt, dt, lse, delta, dqt, dkt,
                                        dvt, b, lq, lk, ck, cv, s);
  } else if (ck <= 32) {
    return launch_passes<T, 32, kMaxCv>(qt, kt, vt, dt, lse, delta, dqt, dkt,
                                        dvt, b, lq, lk, ck, cv, s);
  }
  return launch_passes<T, kMaxCk, kMaxCv>(qt, kt, vt, dt, lse, delta, dqt,
                                          dkt, dvt, b, lq, lk, ck, cv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. o is the forward's output (dtype of q)
// and lse its (B, Lq) f32 log-sum-exp in the log2 domain, both from
// tt_attention_fwd; delta is f32 scratch of B * Lq floats, allocated by the
// caller. Launches three kernels on `stream`. Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for shapes the kernels do not take.
extern "C" int tt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const void* o,
                                const void* lse, void* dq, void* dk, void* dv,
                                void* delta, int b, int lq, int lk, int ck,
                                int cv, int dtype, void* stream) {
  if (b < 1 || b > 65535 || lq < 1 || lk < 1 || ck < 1 || ck > kMaxCk ||
      cv < 1 || cv > kMaxCv ||
      static_cast<long long>(b) * lq > INT_MAX - kDeltaRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(q, k, v, dout, o, l, dq, dk, dv, d,
                                            b, lq, lk, ck, cv, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          q, k, v, dout, o, l, dq, dk, dv, d, b, lq, lk, ck, cv, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
