// Train-mode BatchNorm of a contiguous (N, C, spatial...) tensor in its own
// dtype (float32 or bfloat16): the statistics, the normalisation and the
// first-order backward. Wrapper and plain version: ops/batch_norm.py.
//
// It replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA.
// It was added because cuDNN's train-mode BatchNorm takes float32 NCHW
// (so every bfloat16 activation was cast to float32 and back, four casts a
// layer with the backward), and its spatial kernels reduce each channel on
// one or a few CTAs: at C = 8 over 64 x 512 x 512 values a channel most of
// the card's 132 SMs sit idle.
//
// Bound: the bytes. A forward reads x twice (statistics, normalisation) and
// writes y once; a backward reads dy and x twice and writes dx once. The
// design for this card:
// - every pass over the elements is a split grid: blockIdx.y is the channel,
//   blockIdx.x one of `splits` contiguous runs of the channel's N x HW values
//   (the wrapper picks `splits` so the grid fills the SMs whatever C is);
//   each thread reads 16 bytes at a time where the plane size and the
//   pointers allow it (else one element), four loads in flight;
// - a thread accumulates in float32; a CTA sums its threads in a fixed tree
//   and stores one partial a channel and run; a second, per-channel kernel
//   merges the runs' partials in float64, in order. No atomics: the results
//   repeat bit for bit;
// - the statistics are shifted sums: x - k, k the channel's first value, so
//   E[(x-k)^2] - E[x-k]^2 cancels only as far as k is from the mean;
// - the per-channel kernel of the forward also updates the running
//   statistics (ra = m ra + (1 - m) batch, the biased variance);
// - the normalisation and dx are computed in float32 and rounded once to the
//   activations' dtype as they are stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // CTAs of the passes over the elements
constexpr int kMergeThreads = 128;  // CTAs of the per-channel merges
constexpr int kUnroll = 4;          // vectors a thread has in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// V values of T, 16 bytes when V > 1, moved as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T t[V];
};

// V values of T at p as float32
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = to_float(pk.t[i]);
}

// V float32 values rounded to T, stored at p
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) store_float(v[i], &pk.t[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// The channel's shape: C channels, planes of hw values, M = N * hw values a
// channel, in runs of `chunk` (a multiple of 8) values.
struct Shape {
  int c;
  uint32_t hw, m, chunk;
};

// This thread's offsets into the tensor, kUnroll vectors of V at a time,
// over its CTA's run of channel blockIdx.y: body(off, ok) for each group,
// ok[u] false past the run's end.
template <int V, typename Body>
__device__ __forceinline__ void walk(const Shape& s, Body&& body) {
  constexpr uint32_t kStride = kThreads * V;
  const uint32_t m0 = blockIdx.x * s.chunk;
  const uint32_t m1 = min(s.m, m0 + s.chunk);
  uint32_t m = m0 + threadIdx.x * V;
  if (m >= m1) return;
  uint32_t plane = m / s.hw, at = m - plane * s.hw;
  const uint32_t dplane = kStride / s.hw, dat = kStride - dplane * s.hw;
  const size_t c = blockIdx.y;
  for (; m < m1; m += kUnroll * kStride) {
    size_t off[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = m + u * kStride < m1;
      off[u] = ((size_t)plane * s.c + c) * s.hw + at;
      plane += dplane;
      at += dat;
      if (at >= s.hw) {
        at -= s.hw;
        ++plane;
      }
    }
    body(off, ok);
  }
}

// (a, b) summed over the CTA in a fixed order; the sums in thread 0
__device__ __forceinline__ void block_sum(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.f;
    b = lane < kThreads / 32 ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

// The partials (a, b) of channel blockIdx.x's runs, summed in float64 in a
// fixed order; the sums in thread 0
__device__ __forceinline__ void merge_runs(const float* __restrict__ part,
                                           int c, int splits, double& a,
                                           double& b) {
  __shared__ double sa[kMergeThreads / 32], sb[kMergeThreads / 32];
  const float* pa = part + (size_t)blockIdx.x * splits;
  const float* pb = part + ((size_t)c + blockIdx.x) * splits;
  a = 0.0;
  b = 0.0;
  for (int j = threadIdx.x; j < splits; j += kMergeThreads) {
    a += pa[j];
    b += pb[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kMergeThreads / 32; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

// Forward, pass 1: each run's sums of (x - k) and (x - k)^2, k = x[0, c, 0]
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                 Shape s) {
  const float k = to_float(x[(size_t)blockIdx.y * s.hw]);
  float s1 = 0.f, s2 = 0.f;
  walk<V>(s, [&](const size_t (&off)[kUnroll], const bool (&ok)[kUnroll]) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) load<T, V>(x + off[u], v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[u][i] - k;
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
    }
  });
  block_sum(s1, s2);
  if (threadIdx.x == 0) {
    const size_t splits = gridDim.x;
    part[blockIdx.y * splits + blockIdx.x] = s1;
    part[(gridDim.y + blockIdx.y) * splits + blockIdx.x] = s2;
  }
}

// Forward, pass 2 (a CTA a channel): mean, biased variance, rstd, the scale
// w * rstd the normalisation takes, and the running statistics' update
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    stats_merge_kernel(const T* __restrict__ x, const float* __restrict__ part,
                       const float* __restrict__ w, float* __restrict__ mean,
                       float* __restrict__ var, float* __restrict__ rstd,
                       float* __restrict__ scale,
                       float* __restrict__ running_mean,
                       float* __restrict__ running_var, Shape s, int splits,
                       float eps, float momentum) {
  double s1, s2;
  merge_runs(part, s.c, splits, s1, s2);
  if (threadIdx.x != 0) return;
  const int c = blockIdx.x;
  const double d = s1 / s.m;
  const float mu = (float)(to_float(x[(size_t)c * s.hw]) + d);
  const float v = (float)fmax(s2 / s.m - d * d, 0.0);
  const float r = 1.f / sqrtf(v + eps);
  mean[c] = mu;
  var[c] = v;
  rstd[c] = r;
  scale[c] = w[c] * r;
  if (running_mean != nullptr) {
    running_mean[c] = momentum * running_mean[c] + (1.f - momentum) * mu;
    running_var[c] = momentum * running_var[c] + (1.f - momentum) * v;
  }
}

// Forward, pass 3: y = (x - mean) * (w * rstd) + b, rounded once to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ scale,
                     const float* __restrict__ b, T* __restrict__ y,
                     Shape s) {
  const float mu = mean[blockIdx.y], sc = scale[blockIdx.y],
              sh = b[blockIdx.y];
  walk<V>(s, [&](const size_t (&off)[kUnroll], const bool (&ok)[kUnroll]) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) load<T, V>(x + off[u], v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) v[u][i] = fmaf(v[u][i] - mu, sc, sh);
      store<T, V>(y + off[u], v[u]);
    }
  });
}

// Backward, pass 1: each run's sums of dy and dy (x - mean)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_sums_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ mean, float* __restrict__ part,
                     Shape s) {
  const float mu = mean[blockIdx.y];
  float sg = 0.f, sgx = 0.f;
  walk<V>(s, [&](const size_t (&off)[kUnroll], const bool (&ok)[kUnroll]) {
    float g[kUnroll][V], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      load<T, V>(dy + off[u], g[u]);
      load<T, V>(x + off[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sg += g[u][i];
        sgx = fmaf(g[u][i], v[u][i] - mu, sgx);
      }
    }
  });
  block_sum(sg, sgx);
  if (threadIdx.x == 0) {
    const size_t splits = gridDim.x;
    part[blockIdx.y * splits + blockIdx.x] = sg;
    part[(gridDim.y + blockIdx.y) * splits + blockIdx.x] = sgx;
  }
}

// Backward, pass 2 (a CTA a channel): db = sum dy, dw = rstd sum dy (x -
// mean), and dx's coefficients: dx = a ((dy - mdy) - k (x - mean)) with
// a = w rstd, mdy = db / M, k = rstd dw / M (ATen's form: dy is centred
// before the products, so a large mean of dy does not cancel in float32)
__global__ void __launch_bounds__(kMergeThreads)
    grad_merge_kernel(const float* __restrict__ part,
                      const float* __restrict__ w,
                      const float* __restrict__ rstd, float* __restrict__ dw,
                      float* __restrict__ db, float* __restrict__ coef,
                      Shape s, int splits) {
  double sg, sgx;
  merge_runs(part, s.c, splits, sg, sgx);
  if (threadIdx.x != 0) return;
  const int c = blockIdx.x;
  const float r = rstd[c];
  const float gw = (float)(sgx * r), gb = (float)sg;
  dw[c] = gw;
  db[c] = gb;
  coef[c] = w[c] * r;
  coef[s.c + c] = (float)(sg / s.m);
  coef[2 * s.c + c] = (float)(sgx * r * r / s.m);
}

// Backward, pass 3: dx = a ((dy - mdy) - k (x - mean)), rounded once to T
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    grad_input_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ coef, T* __restrict__ dx,
                      Shape s) {
  const int c = blockIdx.y;
  const float mu = mean[c], a = coef[c], mdy = coef[s.c + c],
              k = coef[2 * s.c + c];
  walk<V>(s, [&](const size_t (&off)[kUnroll], const bool (&ok)[kUnroll]) {
    float g[kUnroll][V], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      load<T, V>(dy + off[u], g[u]);
      load<T, V>(x + off[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i)
        v[u][i] = a * fmaf(mu - v[u][i], k, g[u][i] - mdy);
      store<T, V>(dx + off[u], v[u]);
    }
  });
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

Shape make_shape(long long n, int c, long long hw, int splits) {
  const uint32_t m = (uint32_t)(n * hw);
  uint32_t chunk = (m + splits - 1) / splits;
  chunk = (chunk + 7) / 8 * 8;  // a whole number of 16-byte vectors
  return Shape{c, (uint32_t)hw, m, chunk};
}

template <typename T>
int forward(const T* x, const float* w, const float* b, T* y, float* mean,
            float* var, float* rstd, float* running_mean, float* running_var,
            float* work, long long n, int c, long long hw, int splits,
            float eps, float momentum, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const Shape s = make_shape(n, c, hw, splits);
  const bool vec = hw % V == 0 && aligned(x) && aligned(y);
  float* scale = work + 2 * (size_t)c * splits;
  const dim3 grid(splits, c);
  if (vec)
    stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(x, work, s);
  else
    stats_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, work, s);
  stats_merge_kernel<T><<<c, kMergeThreads, 0, stream>>>(
      x, work, w, mean, var, rstd, scale, running_mean, running_var, s,
      splits, eps, momentum);
  if (vec)
    normalize_kernel<T, V><<<grid, kThreads, 0, stream>>>(x, mean, scale, b,
                                                           y, s);
  else
    normalize_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, mean, scale, b,
                                                           y, s);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const T* dy, const T* x, const float* w, const float* mean,
             const float* rstd, T* dx, float* dw, float* db, float* work,
             long long n, int c, long long hw, int splits,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const Shape s = make_shape(n, c, hw, splits);
  const bool vec = hw % V == 0 && aligned(dy) && aligned(x) && aligned(dx);
  float* coef = work + 2 * (size_t)c * splits;
  const dim3 grid(splits, c);
  if (vec)
    grad_sums_kernel<T, V><<<grid, kThreads, 0, stream>>>(dy, x, mean, work,
                                                           s);
  else
    grad_sums_kernel<T, 1><<<grid, kThreads, 0, stream>>>(dy, x, mean, work,
                                                           s);
  grad_merge_kernel<<<c, kMergeThreads, 0, stream>>>(work, w, rstd, dw, db,
                                                      coef, s, splits);
  if (vec)
    grad_input_kernel<T, V><<<grid, kThreads, 0, stream>>>(dy, x, mean, coef,
                                                            dx, s);
  else
    grad_input_kernel<T, 1><<<grid, kThreads, 0, stream>>>(dy, x, mean, coef,
                                                            dx, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (n, c, hw) contiguous, dtype 0 float32, 1 bfloat16; w, b, mean, var,
// rstd and the running statistics (both null: no update) float32 (c,);
// work: 2 c splits + 3 c floats of scratch (each run's two partial sums a
// channel, then three floats a channel). 0 or the launch's cudaError.
extern "C" int tt_batch_norm_fwd(const void* x, const void* w, const void* b,
                                 void* y, void* mean, void* var, void* rstd,
                                 void* running_mean, void* running_var,
                                 void* work, long long n, int c, long long hw,
                                 int splits, float eps, float momentum,
                                 int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    return forward(static_cast<const __nv_bfloat16*>(x), f(w), f(b),
                   static_cast<__nv_bfloat16*>(y), g(mean), g(var), g(rstd),
                   g(running_mean), g(running_var), g(work), n, c, hw, splits,
                   eps, momentum, st);
  return forward(static_cast<const float*>(x), f(w), f(b),
                 static_cast<float*>(y), g(mean), g(var), g(rstd),
                 g(running_mean), g(running_var), g(work), n, c, hw, splits,
                 eps, momentum, st);
}

// dy, x, dx as x above; w, mean, rstd, dw, db float32
// (c,). 0 or the launch's cudaError.
extern "C" int tt_batch_norm_bwd(const void* dy, const void* x, const void* w,
                                 const void* mean, const void* rstd, void* dx,
                                 void* dw, void* db, void* work, long long n,
                                 int c, long long hw, int splits, int dtype,
                                 void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 1)
    return backward(static_cast<const __nv_bfloat16*>(dy),
                    static_cast<const __nv_bfloat16*>(x), f(w), f(mean),
                    f(rstd), static_cast<__nv_bfloat16*>(dx), g(dw), g(db),
                    g(work), n, c, hw, splits, st);
  return backward(static_cast<const float*>(dy), static_cast<const float*>(x),
                  f(w), f(mean), f(rstd), static_cast<float*>(dx), g(dw),
                  g(db), g(work), n, c, hw, splits, st);
}
