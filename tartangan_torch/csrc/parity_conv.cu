// K3: fused merged-tap parity convolution for Hopper (sm_90a), float32 or
// bfloat16 x and out.
//
// Replaces the Pallas TPU kernel tartangan_tpu/ops/pallas/parity_conv.py:99
// (_kernel, built by _make_kernel at :75, launched by _fused_conv_impl at
// :130). Same function: x (B, H, W, Ci) NHWC, w2 (2, 2, Ci, 4*co) merged-tap
// weights (ops/parity.py::pack_up_conv2 or pack_full_conv2), bias (co) or
// null ->
//   out[b, i, j, q*co + c] = bias[c] + sum_{ay, ax} x[b, i+qy+ay-1, j+qx+ax-1, :]
//                                                   . w2[ay, ax, :, q*co + c]
// (zero outside the image), f32 accumulation, q = 2*qy + qx the parity.
// 'full' (Ci = 4*cin, the parity stack) multiplies only the 9 of 16
// (tap, input parity) blocks that are not structurally zero: per dimension,
// the pairs (tap a, input parity p) with d = 2a + p + q - 2 in {-1, 0, 1}
// are those with g = 2a + p = i + 1 - q for i = 0..2, so the nine non-zero
// blocks of parity q are (iy, ix) in 3x3, at offset d = q + (g >> 1) - 1.
//
// The TPU kernel builds the (H+1, W+1) over-produced grid in VMEM and rolls
// each parity into place; it batches whole images per program and falls
// back to XLA where one image does not fit VMEM (256x256 inputs). Here a
// CTA owns a TH x 32 tile of one image and a BN-wide slice of co, and
// computes all four parities of it: every parity's 2x2 window lies in the
// tile's 3x3 neighbourhood, so the (TH+2) x 34 halo tile of x is staged in
// shared memory once and each staged value feeds up to 16*BN products.
//
// What bounds it on the card. Every '512thin' shape does ~17-19 GFLOP of
// float32 FMA (0.26-0.29 ms at 67 TFLOP/s). At 32x32..128x128 (Ci >= 32)
// the bytes are 4-30x below that, so the FMA pipe is the limit; at 256x256
// (Ci 16/32, co 8) the bytes (x once, 4*co outputs a position) take about
// as long as the FMAs, so loads, FMAs and stores must overlap. The design:
// - Channels are staged in chunks (8 of x for 'up'; 4 of each of the four
//   input parities for 'full'), double-buffered with cp.async (16 bytes a
//   thread, neighbouring threads on neighbouring channel quads of a pixel,
//   zero-filled outside the image and past the last channel), so the next
//   chunk's loads overlap this chunk's FMAs.
// - The halo tile keeps NHWC with a pixel stride of KS + 4 floats (an odd
//   multiple of 4): a warp's lanes read one channel quad of 32 neighbouring
//   pixels as float4s without bank conflicts. Weights are staged as
//   [channel][parity][block][BN] and read as float4 broadcasts.
// - A thread owns 4 rows x 1 column x 4 channels x 4 parities (64
//   accumulators): per staged column it loads the 5-6 rows that its taps
//   need once and reuses them for every parity and tap, so the inner loop
//   is ~8 % shared-memory load instructions to 92 % FMAs. 256 threads,
//   <= 128 registers, so two CTAs share an SM. The thread's coordinates
//   and the tile's origin are recomputed from the thread and block index
//   in each phase, which keeps ptxas from spilling them around the FMA
//   loop.
// - Epilogue: the bias is added in registers, the tile goes through shared
//   memory and leaves as float4 rows, consecutive threads on consecutive
//   16 bytes of the output (a tile row of 32 positions x 4*co is one
//   contiguous run when BN covers co).
// - bfloat16 (--dtype bf16, the TPU kernel's production form): x is staged
//   as bfloat16 (cp.async of 4 channels, 8 bytes; a plain load where the
//   channels are not whole quads) and widened to float32 as a thread loads
//   it from shared memory; the FMAs and the accumulators stay float32. The
//   weights come as float32 holding the merged taps rounded to bfloat16
//   (summed in float32 and rounded once, parity_conv.py:190). The epilogue
//   rounds where the TPU kernel does: the float32 sum to bfloat16 as it is
//   stored (:126), then the bias rounded to bfloat16 added in bfloat16
//   (:193). A simple instantiation of the float32 design: bf16 tensor-core
//   products are later work.
// Plain FMA loops: no tensor cores (TF32 would move the output by ~1e-3 of
// its max-abs), TMA or warp specialisation yet. Measured on an H100
// (chip_smoke.py, numbers in PERF.md): about a third of the FMA bound at
// every '512thin' shape, 256x256 included, so the bytes do not hold it
// back there; what does is not measured yet (no profiler counters on the
// card). Each FMA still pairs one x value and one weight read from shared
// memory at about 3 FMAs per float loaded, which makes shared-memory
// bandwidth the first suspect; 3xTF32 tensor-core products are the way
// past the FMA pipe.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRM = 4;   // output rows per thread
constexpr int kTN = 4;   // output channels per thread and parity
constexpr int kTW = 32;  // tile width: one warp's lanes, one column each

template <int BN, bool FULL>
struct Cfg {
  static constexpr int G = BN / kTN;            // channel groups
  static constexpr int P = kThreads / G;        // threads per group
  static constexpr int TH = kRM * P / kTW;      // tile height
  static constexpr int HR = TH + 2, HC = kTW + 2;  // halo tile
  static constexpr int KC = FULL ? 4 : 8;       // channels per chunk (per input parity for FULL)
  static constexpr int KS = FULL ? 4 * KC : KC;  // staged channels per pixel
  static constexpr int LDC = KS + 4;            // padded pixel stride
  static constexpr int T = FULL ? 9 : 4;        // weight blocks per parity
  static constexpr int XS = HR * HC * LDC;      // floats per halo buffer
  static constexpr int WS = KC * 4 * T * BN;    // floats per weight buffer
  static constexpr int LDO = 4 * BN + 4;        // output staging row
  static constexpr int OS = TH * kTW * LDO;
  static_assert(P % 32 == 0, "a warp must lie in one channel group");
  static_assert(LDC % 8 == 4 && LDO % 8 == 4, "odd multiple of 4 floats");
  // [2][XS] of x as T, then [2][WS] floats of weights; the epilogue reuses
  // the start as OS floats
  template <class T>
  static constexpr int smem_bytes() {
    return 2 * (XS * static_cast<int>(sizeof(T)) + WS * 4) > OS * 4
               ? 2 * (XS * static_cast<int>(sizeof(T)) + WS * 4)
               : OS * 4;
  }
  static_assert(XS * 2 % 16 == 0, "the weights start 16-byte aligned");
};

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

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

using bf16 = __nv_bfloat16;

// the element type of this library's instances: ops/build.py builds this
// source once a dtype, bfloat16 with -DTT_BFLOAT16
#ifdef TT_BFLOAT16
using Elem = bf16;
constexpr int kBfloat16 = 1;
#else
using Elem = float;
constexpr int kBfloat16 = 0;
#endif

// What differs between the float32 and the bfloat16 instantiation: how x is
// staged (a channel quad, or one channel) and read back as float32, and how
// a float32 result is rounded and stored.
template <class T>
struct Io;

template <>
struct Io<float> {
  __device__ static void stage4(float* dst, const float* src, bool valid) {
    cp_async16(dst, src, valid);
  }
  __device__ static void stage1(float* dst, const float* src, bool valid) {
    cp_async4(dst, src, valid);
  }
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float round(float v) { return v; }
  __device__ static void store4(float* dst, const float4& v) {
    *reinterpret_cast<float4*>(dst) = v;
  }
  __device__ static void store1(float* dst, float v) { *dst = v; }
};

template <>
struct Io<bf16> {
  __device__ static void stage4(bf16* dst, const bf16* src, bool valid) {
    cp_async8(dst, src, valid);
  }
  // cp.async has no 2-byte copy: a plain load, visible after the barrier
  // that precedes the chunk's products
  __device__ static void stage1(bf16* dst, const bf16* src, bool valid) {
    *dst = valid ? *src : __float2bfloat16(0.f);
  }
  __device__ static float4 load4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static void store4(bf16* dst, const float4& v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  }
  __device__ static void store1(bf16* dst, float v) {
    *dst = __float2bfloat16(v);
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

struct Args {
  const void* x;  // float or bf16, as the kernel's T
  const float* w2;
  const float* bias;
  void* out;      // T
  int b, h, w, ci, co;
  int vec;  // quad loads and stores: channel quads whole and aligned
  int tiles_w, tiles_h;
};

// weight block t of parity q in the 'full' form: the (tap, input parity)
// pair (ay, ax, p) of non-zero block (iy, ix) = (t / 3, t % 3), and its
// offset (dy, dx). 'up': tap t = 2*ay + ax over all channels.
struct Block {
  int tap, p, dy, dx;
};

__host__ __device__ constexpr Block full_block(int q, int t) {
  const int qy = q >> 1, qx = q & 1;
  const int gy = t / 3 + 1 - qy, gx = t % 3 + 1 - qx;
  return Block{2 * (gy >> 1) + (gx >> 1), 2 * (gy & 1) + (gx & 1),
               qy + (gy >> 1) - 1, qx + (gx >> 1) - 1};
}

// this CTA's image, tile origin and first channel, from the block index
// (recomputed where needed rather than held in registers)
struct Tile {
  int b, i0, j0, n0;
};

template <int BN, bool FULL>
__device__ __forceinline__ Tile tile_of(const Args& a) {
  const int bx = static_cast<int>(blockIdx.x);
  const int by = static_cast<int>(blockIdx.y);
  const int t = bx / a.tiles_w;
  return Tile{t / a.tiles_h, (t % a.tiles_h) * Cfg<BN, FULL>::TH,
              (bx % a.tiles_w) * kTW, by * BN};
}

// stage chunk c0 (channels c0.. of x for 'up'; c0.. of each input parity
// for 'full') of the halo tile and of the weights into xs, ws
template <int BN, bool FULL, class T>
__device__ __forceinline__ void load_chunk(const Args& a, T* xs,
                                           float* ws, int c0) {
  using C = Cfg<BN, FULL>;
  const Tile tl = tile_of<BN, FULL>(a);
  const int bimg = tl.b, i0 = tl.i0, j0 = tl.j0, n0 = tl.n0;
  const int tid = threadIdx.x;
  const int cin = FULL ? a.ci / 4 : a.ci;
  const long long img = static_cast<long long>(bimg) * a.h;
  const T* x = static_cast<const T*>(a.x);
  if (a.vec) {
    constexpr int NQ = C::KS / 4;  // channel quads a pixel
#pragma unroll 1
    for (int e = tid; e < C::HR * C::HC * NQ; e += kThreads) {
      const int v = e % NQ, pix = e / NQ;
      const int gi = i0 - 1 + pix / C::HC, gj = j0 - 1 + pix % C::HC;
      // 'full': quad v is quad v % (KC / 4) of input parity v / (KC / 4)
      const int kq = FULL ? 4 * (v % (C::KC / 4)) : 4 * v;
      const int ch = FULL ? (v / (C::KC / 4)) * cin + c0 + kq : c0 + kq;
      const bool ok = gi >= 0 && gi < a.h && gj >= 0 && gj < a.w &&
                      c0 + kq < cin;
      const T* src = ok ? x + ((img + gi) * a.w + gj) * a.ci + ch : x;
      Io<T>::stage4(xs + pix * C::LDC + 4 * v, src, ok);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < C::HR * C::HC * C::KS; e += kThreads) {
      const int s = e % C::KS, pix = e / C::KS;
      const int gi = i0 - 1 + pix / C::HC, gj = j0 - 1 + pix % C::HC;
      const int k = FULL ? s % C::KC : s;
      const int ch = FULL ? (s / C::KC) * cin + c0 + k : c0 + k;
      const bool ok = gi >= 0 && gi < a.h && gj >= 0 && gj < a.w &&
                      c0 + k < cin;
      const T* src = ok ? x + ((img + gi) * a.w + gj) * a.ci + ch : x;
      Io<T>::stage1(xs + pix * C::LDC + s, src, ok);
    }
  }
  // weights: ws[((k * 4 + q) * T + t) * BN + n]
  const int c4 = 4 * a.co;
  const int nv = a.vec ? 4 : 1;
#pragma unroll 1
  for (int e = tid; e < C::WS / nv; e += kThreads) {
    const int n = (e % (BN / nv)) * nv;
    const int r = e / (BN / nv);
    const int t = r % C::T, q = (r / C::T) % 4, k = r / (C::T * 4);
    int tap, row;
    if (FULL) {
      const Block blk = full_block(q, t);
      tap = blk.tap;
      row = blk.p * cin + c0 + k;
    } else {
      tap = t;
      row = c0 + k;
    }
    const bool ok = c0 + k < cin && n0 + n < a.co;
    const float* src =
        ok ? a.w2 + (static_cast<long long>(tap) * a.ci + row) * c4 + q * a.co +
                 n0 + n
           : a.w2;
    if (a.vec) {
      cp_async16(ws + r * BN + n, src, ok);
    } else {
      cp_async4(ws + r * BN + n, src, ok);
    }
  }
}

// acc[q][r][:] += a[off + r][k] * w for the thread's rows r
template <int N>
__device__ __forceinline__ void fma_rows(float (&acc)[4][kRM][kTN], int q,
                                         const float4 (&a)[N], int off,
                                         int k, const float4& w) {
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const float v = comp(a[off + r], k);
    acc[q][r][0] = fmaf(v, w.x, acc[q][r][0]);
    acc[q][r][1] = fmaf(v, w.y, acc[q][r][1]);
    acc[q][r][2] = fmaf(v, w.z, acc[q][r][2]);
    acc[q][r][3] = fmaf(v, w.w, acc[q][r][3]);
  }
}

// the thread's channel group g (channels 4g..4g+3 of the slice), column
// col and first row r0 of the tile, from the thread index (recomputed where
// needed rather than held in registers across the FMA loop)
template <int BN, bool FULL>
__device__ __forceinline__ void thread_pos(int& g, int& col, int& r0) {
  const int tid = threadIdx.x, pt = tid % Cfg<BN, FULL>::P;
  g = tid / Cfg<BN, FULL>::P;
  col = pt % kTW;
  r0 = (pt / kTW) * kRM;
}

// all of one staged chunk into acc: the thread's rows r0..r0+3 of column
// col, channels 4g..4g+3 of the slice
template <int BN, bool FULL, class T>
__device__ __forceinline__ void compute_chunk(float (&acc)[4][kRM][kTN],
                                              const T* xs,
                                              const float* ws) {
  using C = Cfg<BN, FULL>;
  int g, col, r0;
  thread_pos<BN, FULL>(g, col, r0);
  if (!FULL) {
#pragma unroll
    for (int k4 = 0; k4 < C::KC / 4; ++k4) {
#pragma unroll
      for (int dxi = 0; dxi < 3; ++dxi) {  // dx = dxi - 1
        // halo rows r0..r0+5 of halo column col + dxi (dy = -1..1)
        float4 av[kRM + 2];
#pragma unroll
        for (int m = 0; m < kRM + 2; ++m) {
          av[m] = Io<T>::load4(xs + ((r0 + m) * C::HC + col + dxi) * C::LDC +
                               4 * k4);
        }
#pragma unroll
        for (int qx = 0; qx < 2; ++qx) {
          const int ax = dxi - qx;
          if (ax < 0 || ax > 1) continue;
#pragma unroll
          for (int qy = 0; qy < 2; ++qy) {
#pragma unroll
            for (int ay = 0; ay < 2; ++ay) {
              const int q = 2 * qy + qx, t = 2 * ay + ax;
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float4 w = *reinterpret_cast<const float4*>(
                    ws + (((4 * k4 + kk) * 4 + q) * 4 + t) * BN + kTN * g);
                fma_rows(acc, q, av, qy + ay, kk, w);
              }
            }
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int k4 = 0; k4 < C::KC / 4; ++k4) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int py = p >> 1, px = p & 1;
        // input parity py is read at dy in {dyb, dyb + 1}, px at dx in
        // {dxb, dxb + 1}
        const int dyb = py ? -1 : 0, dxb = px ? -1 : 0;
#pragma unroll
        for (int dx = dxb; dx < dxb + 2; ++dx) {
          float4 av[kRM + 1];
#pragma unroll
          for (int m = 0; m < kRM + 1; ++m) {
            av[m] = Io<T>::load4(
                xs + ((r0 + m + 1 + dyb) * C::HC + col + 1 + dx) * C::LDC +
                p * C::KC + 4 * k4);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const Block blk = full_block(q, t);
              if (blk.p != p || blk.dx != dx) continue;
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float4 w = *reinterpret_cast<const float4*>(
                    ws + (((4 * k4 + kk) * 4 + q) * 9 + t) * BN + kTN * g);
                fma_rows(acc, q, av, blk.dy - dyb, kk, w);
              }
            }
          }
        }
      }
    }
  }
}

template <int BN, bool FULL, class T>
__global__ void __launch_bounds__(kThreads, 2) tile_kernel(const Args a) {
  using C = Cfg<BN, FULL>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [2][XS]
  float* ws = reinterpret_cast<float*>(smem + 2 * C::XS * sizeof(T));

  const int nch = ((FULL ? a.ci / 4 : a.ci) + C::KC - 1) / C::KC;

  float acc[4][kRM][kTN];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int n = 0; n < kTN; ++n) acc[q][r][n] = 0.f;

  load_chunk<BN, FULL, T>(a, xs, ws, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int buf = c & 1;
    if (c + 1 < nch) {
      load_chunk<BN, FULL, T>(a, xs + (buf ^ 1) * C::XS,
                              ws + (buf ^ 1) * C::WS, (c + 1) * C::KC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute_chunk<BN, FULL, T>(acc, xs + buf * C::XS, ws + buf * C::WS);
    __syncthreads();
  }

  // epilogue: bias in registers, the tile through shared memory, then
  // coalesced rows out. bfloat16: the sum rounded, then the rounded bias
  // added and the result rounded (Io<float>::round is the identity)
  const Tile tl = tile_of<BN, FULL>(a);
  const int bimg = tl.b, i0 = tl.i0, j0 = tl.j0, n0 = tl.n0;
  const int tid = threadIdx.x;
  int g, col, r0;
  thread_pos<BN, FULL>(g, col, r0);
  float bv[kTN];
#pragma unroll
  for (int n = 0; n < kTN; ++n) {
    const int ch = n0 + kTN * g + n;
    bv[n] = a.bias != nullptr && ch < a.co ? Io<T>::round(a.bias[ch]) : 0.f;
  }
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      *reinterpret_cast<float4*>(
          os + ((r0 + r) * kTW + col) * C::LDO + q * BN + kTN * g) =
          make_float4(Io<T>::round(Io<T>::round(acc[q][r][0]) + bv[0]),
                      Io<T>::round(Io<T>::round(acc[q][r][1]) + bv[1]),
                      Io<T>::round(Io<T>::round(acc[q][r][2]) + bv[2]),
                      Io<T>::round(Io<T>::round(acc[q][r][3]) + bv[3]));
    }
  __syncthreads();
  const int c4 = 4 * a.co;
  const long long img = static_cast<long long>(bimg) * a.h;
  const int nv = a.vec ? 4 : 1;
  T* out = static_cast<T*>(a.out);
#pragma unroll 1
  for (int e = tid; e < C::TH * kTW * 4 * BN / nv; e += kThreads) {
    const int n = (e % (BN / nv)) * nv;
    const int q = (e / (BN / nv)) % 4;
    const int pos = e / (4 * BN / nv);
    const int i = i0 + pos / kTW, j = j0 + pos % kTW;
    if (i >= a.h || j >= a.w || n0 + n >= a.co) continue;
    T* dst = out + ((img + i) * a.w + j) * c4 + q * a.co + n0 + n;
    const float* s = os + pos * C::LDO + q * BN + n;
    if (a.vec) {
      Io<T>::store4(dst, *reinterpret_cast<const float4*>(s));
    } else {
      Io<T>::store1(dst, *s);
    }
  }
}

template <int BN, bool FULL, class T>
cudaError_t launch_t(Args a, cudaStream_t stream) {
  using C = Cfg<BN, FULL>;
  const size_t smem = C::template smem_bytes<T>();
  // above 48 KB of dynamic shared memory, on the current device
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<BN, FULL, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  a.tiles_w = (a.w + kTW - 1) / kTW;
  a.tiles_h = (a.h + C::TH - 1) / C::TH;
  const long long gx = static_cast<long long>(a.tiles_w) * a.tiles_h * a.b;
  const long long gy = (a.co + BN - 1) / BN;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidValue;
  tile_kernel<BN, FULL, T>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool FULL, class T>
cudaError_t launch_bn(const Args& a, cudaStream_t stream) {
  if (a.co <= 8) return launch_t<8, FULL, T>(a, stream);
  if (a.co <= 16) return launch_t<16, FULL, T>(a, stream);
  return launch_t<32, FULL, T>(a, stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// full: 0 = 'up' (conv3x3 over nearest-up2 of x), 1 = 'full' (full-res
// conv3x3 over the parity stack x, Ci = 4*cin). x and out float32
// (bfloat16 = 0) or bfloat16 (1), the library's own type (cudaError
// InvalidValue otherwise); w2 and bias ((co) or null) float32.
// Returns a cudaError_t.
extern "C" int tt_parity_conv(const void* x, const float* w2,
                              const float* bias, void* out, int b, int h,
                              int w, int ci, int co, int full, int bfloat16,
                              void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || (full && ci % 4) ||
      bfloat16 != kBfloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cin = full ? ci / 4 : ci;
  const int quad = bfloat16 ? 8 : 16;  // bytes of a channel quad
  const int vec = cin % 4 == 0 && co % 4 == 0 && aligned(x, quad) &&
                  aligned(w2, 16) && aligned(out, quad);
  const Args a{x, w2, bias, out, b, h, w, ci, co, vec, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(full ? launch_bn<true, Elem>(a, s)
                               : launch_bn<false, Elem>(a, s));
}
