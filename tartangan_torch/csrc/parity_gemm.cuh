// Merged-tap parity convolution as an implicit GEMM, float32, for Hopper
// (sm_90a). Shared by csrc/parity_conv.cu (K3) and csrc/gblock.cu (K4, K5).
//
// The function: for an NHWC input x (B, H, W, Cx), output parity
// q = 2*qy + qx and channel n < co,
//
//   out[b, i, j, q*co + n] = sum over the segments s of parity q of
//       sum_{c < s.cn} src_s[b, i + s.dy, j + s.dx, s.c0 + c] * s.w[c*s.ldw + n]
//
// with src_s[...] = 0 outside the image. A segment is one 2x2 window tap
// (ay, ax) of the merged-tap kernel, at offset (qy + ay - 1, qx + ax - 1),
// over one channel range: for the 'up' form (ops/parity.py::pack_up_conv2)
// the four taps over all Cx channels; for the 'full' form
// (pack_full_conv2) the nine (tap, input parity p) pairs whose weights are
// not structurally zero, each over the cin = Cx/4 channels of parity p (the
// seven zero blocks are never multiplied); for K5 also the shortcut, a
// segment over a second input at offset (0, 0). Optionally the primary
// input goes through BatchNorm with given statistics and leaky-relu(0.2)
// as it is loaded (zero padding applies after it, as in the reference),
// a bias is added per output channel, and per-CTA sums and sums of squares
// of the stored outputs are written for a deterministic reduction.
//
// What bounds it on the card: at the '512thin' shapes each output costs
// 4*Cx (up) or 9*Cx/4 (full) FMAs against one read of x and one write of
// the output, i.e. 16..150 flop per byte: compute-bound on CUDA-core f32
// (67 TFLOP/s) at the 32x32..128x128 shapes, near the ridge at 256x256.
// The design is the classic register-tiled SGEMM: M = B*H*W output
// positions, N = one parity's co channels, K = the segments' channels in
// chunks of 8. A CTA of 256 threads owns BM positions x BN channels of one
// parity (so every segment's offset is uniform over the CTA); each thread
// accumulates an 8 x 4 tile; the A tile is gathered from global memory
// through the segment's offset (the im2col never exists in device memory)
// and staged in shared memory with the next chunk prefetched into
// registers. BN follows co (8..64) so narrow layers do not waste threads.
// Plain FMA loops: no tensor cores (TF32 would change the numbers), TMA or
// warp specialisation yet.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace parity_gemm {

constexpr int kThreads = 256;
constexpr int kBK = 8;   // K chunk
constexpr int kTM = 8;   // positions per thread
constexpr int kTN = 4;   // channels per thread

struct Args {
  const float* x0;  // primary input, NHWC (B, H, W, cx0)
  const float* x1;  // shortcut input, NHWC (B, H, W, cx1), or null
  int cx0, cx1;
  int full;         // merged-tap form: 0 'up', 1 'full'
  const float* w2;  // (2, 2, cx0, 4*co) merged-tap weights
  const float* wp;  // (cx1, co) shortcut weights, or null (no shortcut)
  // prologue on x0, per channel of x0: act((v - mean) * mul + add)
  const float* pre_mean;
  const float* pre_mul;
  const float* pre_add;
  const float* bias;  // (4*co) or null
  float* out;         // NHWC (B, H, W, 4*co)
  float* partial;     // (gridDim.x, 2, 4*co) or null
  int b, h, w, co;
};

struct Seg {
  int src;         // 0: x0, 1: x1
  int dy, dx;      // offset of the input window
  int c0, cn;      // channel range of the source
  int ldw;         // row stride of the weight slab, in floats
  const float* w;  // row 0 of the slab, at this parity's column 0
};

__host__ __device__ inline int num_segments(const Args& a) {
  return (a.full ? 9 : 4) + (a.wp != nullptr ? 1 : 0);
}

// Segment idx of output parity q = 2*qy + qx. 'up': the four taps (ay, ax)
// over all cx0 channels. 'full': per dimension, the (tap a, input parity p)
// pairs with d = 2a + p + q - 2 in {-1, 0, 1} are the pairs g = 2a + p with
// g = i + 1 - q, i = 0..2, so the nine non-zero blocks are (iy, ix) in 3x3.
// Then the shortcut, if any.
__host__ __device__ inline Seg segment(const Args& a, int q, int idx) {
  const int qy = q / 2, qx = q % 2;
  const int ld = 4 * a.co;
  Seg s;
  if (idx == (a.full ? 9 : 4)) {
    s.src = 1;
    s.dy = s.dx = 0;
    s.c0 = 0;
    s.cn = a.cx1;
    s.ldw = a.co;
    s.w = a.wp;
    return s;
  }
  int ay, ax;
  s.src = 0;
  s.ldw = ld;
  if (a.full) {
    const int gy = idx / 3 + 1 - qy, gx = idx % 3 + 1 - qx;
    ay = gy / 2;
    ax = gx / 2;
    s.cn = a.cx0 / 4;
    s.c0 = (2 * (gy % 2) + gx % 2) * s.cn;
  } else {
    ay = idx / 2;
    ax = idx % 2;
    s.cn = a.cx0;
    s.c0 = 0;
  }
  s.dy = qy + ay - 1;
  s.dx = qx + ax - 1;
  s.w = a.w2 + (static_cast<long long>(2 * ay + ax) * a.cx0 + s.c0) * ld +
        q * a.co;
  return s;
}

__device__ __forceinline__ float leaky_relu(float v) {
  return v >= 0.f ? v : v * 0.2f;
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const Args a) {
  constexpr int TX = BN / kTN;           // threads along N
  constexpr int TY = kThreads / TX;      // threads along M
  constexpr int BM = TY * kTM;           // positions per CTA
  constexpr int RA = BM * kBK / kThreads;  // A elements loaded per thread
  constexpr int RB = (BN * kBK + kThreads - 1) / kThreads;
  constexpr int LDA = BM + 4;            // padded: conflict-free stores
  __shared__ __align__(16) float As[kBK][LDA];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int nblk = (a.co + BN - 1) / BN;
  const int q = blockIdx.y / nblk;
  const int n0 = (blockIdx.y % nblk) * BN;
  const int hw = a.h * a.w;
  const long long M = static_cast<long long>(a.b) * hw;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int nseg = num_segments(a);

  // this thread loads channel kA of positions mA + 32 r; their (i, j)
  const int kA = tid % kBK;
  const int mA = tid / kBK;
  int pos_i[RA], pos_j[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const long long m = m0 + mA + r * (kThreads / kBK);
    const int p = static_cast<int>(m % hw);
    pos_i[r] = m < M ? p / a.w : -(1 << 20);  // out of range for any dy
    pos_j[r] = p % a.w;
  }

  float ra[RA], rb[RB];
  auto load = [&](const Seg s, int c) {
    const int ci = c + kA;
    const bool cok = ci < s.cn;
    const float* src = s.src == 0 ? a.x0 : a.x1;
    const int cx = s.src == 0 ? a.cx0 : a.cx1;
    const bool pro = s.src == 0 && a.pre_mean != nullptr;
    float mean = 0.f, mul = 1.f, add = 0.f;
    if (pro && cok) {
      mean = a.pre_mean[s.c0 + ci];
      mul = a.pre_mul[s.c0 + ci];
      add = a.pre_add[s.c0 + ci];
    }
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int ii = pos_i[r] + s.dy, jj = pos_j[r] + s.dx;
      float v = 0.f;
      if (cok && ii >= 0 && ii < a.h && jj >= 0 && jj < a.w) {
        const long long m = m0 + mA + r * (kThreads / kBK);
        const long long pix = m + static_cast<long long>(s.dy) * a.w + s.dx;
        v = src[pix * cx + s.c0 + ci];
        if (pro) v = leaky_relu((v - mean) * mul + add);
      }
      ra[r] = v;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / BN, n = e % BN;
      float v = 0.f;
      if (e < BN * kBK && c + k < s.cn && n0 + n < a.co) {
        v = s.w[static_cast<long long>(c + k) * s.ldw + n0 + n];
      }
      rb[r] = v;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < RA; ++r) As[kA][mA + r * (kThreads / kBK)] = ra[r];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int e = tid + r * kThreads;
      if (e < BN * kBK) Bs[e / BN][e % BN] = rb[r];
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  int seg = 0, c = 0;
  Seg cur = segment(a, q, 0);
  load(cur, 0);
  store();
  __syncthreads();
  while (seg < nseg) {
    // the next chunk: the next 8 channels of this segment, or the next one
    Seg next = cur;
    int nseg_i = seg, nc = c + kBK;
    if (nc >= cur.cn) {
      ++nseg_i;
      nc = 0;
      if (nseg_i < nseg) next = segment(a, q, nseg_i);
    }
    const bool more = nseg_i < nseg;
    if (more) load(next, nc);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[kTM], bv[kTN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) store();
    __syncthreads();
    seg = nseg_i;
    c = nc;
    cur = next;
  }

  // epilogue: bias, store, per-CTA moments of the stored values
  const int c4 = 4 * a.co;
  float s1[kTN], s2[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (m < M && n < a.co) {
        const int col = q * a.co + n;
        float v = acc[i][j];
        if (a.bias != nullptr) v += a.bias[col];
        a.out[m * c4 + col] = v;
        s1[j] += v;
        s2[j] += v * v;
      }
    }
  }
  if (a.partial == nullptr) return;
  // fixed-order reduction over the TY threads of each column: no atomics,
  // so the sums are the same in every run
  float* red = &As[0][0];  // TY * BN floats <= kBK * LDA
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTN; ++j) red[ty * BN + tx * kTN + j] = pass ? s2[j] : s1[j];
    __syncthreads();
    if (tid < BN && n0 + tid < a.co) {
      float t = 0.f;
      for (int y = 0; y < TY; ++y) t += red[y * BN + tid];
      a.partial[(static_cast<long long>(blockIdx.x) * 2 + pass) * c4 +
                q * a.co + n0 + tid] = t;
    }
  }
}

// stats[k][c] = sum over the rows g of partial[g][k][c], in a fixed order
// and in double, k = 0 (sum), 1 (sum of squares)
__global__ void reduce_partials(const float* partial, int rows, int c4,
                                float* stats) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c4) return;
  double t0 = 0.0, t1 = 0.0;
  for (int g = 0; g < rows; ++g) {
    t0 += partial[(static_cast<long long>(g) * 2) * c4 + c];
    t1 += partial[(static_cast<long long>(g) * 2 + 1) * c4 + c];
  }
  stats[c] = static_cast<float>(t0);
  stats[c4 + c] = static_cast<float>(t1);
}

// BN (channels per CTA) for co output channels per parity
inline int block_n(int co) {
  return co <= 8 ? 8 : co <= 16 ? 16 : co <= 32 ? 32 : 64;
}

// CTAs along M for B*H*W positions at this co (the rows of `partial`)
inline long long grid_m(long long positions, int co) {
  const int bm = (kThreads / (block_n(co) / kTN)) * kTM;
  return (positions + bm - 1) / bm;
}

inline cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long positions = static_cast<long long>(a.b) * a.h * a.w;
  const int bn = block_n(a.co);
  const long long gx = grid_m(positions, a.co);
  const long long gy = 4LL * ((a.co + bn - 1) / bn);
  if (positions < 1 || a.co < 1 || a.cx0 < 1 || (a.full && a.cx0 % 4) ||
      (a.wp != nullptr && (a.x1 == nullptr || a.cx1 < 1)) ||
      gx > 2147483647LL || gy > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  switch (bn) {
    case 8: gemm_kernel<8><<<grid, kThreads, 0, stream>>>(a); break;
    case 16: gemm_kernel<16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: gemm_kernel<32><<<grid, kThreads, 0, stream>>>(a); break;
    default: gemm_kernel<64><<<grid, kThreads, 0, stream>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace parity_gemm
