// K4 and K5: the fused residual generator block's two convolutions, for
// Hopper (sm_90a), float32.
//
// Replace the Pallas TPU kernels tartangan_tpu/ops/pallas/gblock.py:196
// (_kernel_a) and :234 (_kernel_b), launched by _fused_gblock_fwd_impl
// (:275, calls :292 and :333). Same functions, in the parity domain:
//
//   K4: y1p = parity-up conv1(act(bn1(x))) + b1, x (B, H, W, Cin) NHWC,
//       bn1 from the precomputed moments of x, act = leaky-relu(0.2);
//       y1p (B, H, W, 4*co); plus the per-channel sum and sum of squares of
//       the stored y1p, (2, 4*co), for bn2.
//   K5: out_p = full-res parity conv2(act(bn2(y1p))) + b2 + x . tile(wp, 4)
//       + bp, (B, H, W, 4*co); depth-to-space runs outside.
//
// The TPU kernels run one image per program of a sequential grid: they pack
// the convs as 9 tap-grouped matmuls, zero a padded scratch once at program
// 0 and carry bn2's sums across programs in scratch, flushed by the last.
// Here both are the merged-tap implicit GEMM of parity_gemm.cuh (2x2 taps,
// structural zeros of conv2 skipped): BatchNorm + act are applied as the
// input tile is gathered, so the normalized tensor never exists; each
// CTA zero-fills its own halo (out-of-image taps load 0 after the
// prologue); the shortcut is one more GEMM segment over x at offset (0, 0)
// with wp's rows; biases are added in the epilogue. bn2's moments: each CTA
// writes its partial sums of the stored float32 values, and a second
// launch from this file reduces them in a fixed order, in double, so the
// statistics do not change from run to run (no float atomics).
#include "parity_gemm.cuh"

namespace {

cudaError_t reduce(const float* partial, long long rows, int c4,
                   float* stats, cudaStream_t stream) {
  const int threads = 128;
  parity_gemm::reduce_partials<<<(c4 + threads - 1) / threads, threads, 0,
                                 stream>>>(partial, static_cast<int>(rows),
                                           c4, stats);
  return cudaGetLastError();
}

}  // namespace

// The rows of tt_gblock_a's partial-sum scratch for these shapes: one per
// CTA along the GEMM's positions.
extern "C" long long tt_gblock_partial_rows(int b, int h, int w, int co) {
  return parity_gemm::grid_m(static_cast<long long>(b) * h * w, co);
}

// x (b, h, w, cin); w1 (2, 2, cin, 4*co) = pack_up_conv2(w1) in HWIO order;
// bias1 (4*co) = tile(b1, 4); mean1/mul1/add1 (cin): bn1 as
// (x - mean) * mul + add; y1p (b, h, w, 4*co); partial (partial_rows, 2,
// 4*co) scratch, partial_rows from tt_gblock_partial_rows; stats (2, 4*co).
// Returns a cudaError_t.
extern "C" int tt_gblock_a(const float* x, const float* w1, const float* bias1,
                           const float* mean1, const float* mul1,
                           const float* add1, float* y1p, float* partial,
                           long long partial_rows, float* stats, int b, int h,
                           int w, int cin, int co, void* stream) {
  if (b < 1 || h < 1 || w < 1 || cin < 1 || co < 1 ||
      parity_gemm::grid_m(static_cast<long long>(b) * h * w, co) !=
          partial_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  parity_gemm::Args a{};
  a.x0 = x;
  a.cx0 = cin;
  a.w2 = w1;
  a.pre_mean = mean1;
  a.pre_mul = mul1;
  a.pre_add = add1;
  a.bias = bias1;
  a.out = y1p;
  a.partial = partial;
  a.b = b;
  a.h = h;
  a.w = w;
  a.co = co;
  cudaError_t err = parity_gemm::launch(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce(partial, partial_rows, 4 * co, stats, s));
}

// y1p (b, h, w, 4*co); x (b, h, w, cin); w2 (2, 2, 4*co, 4*co) =
// pack_full_conv2(w2) in HWIO order; wp (cin, co) the shortcut projection
// (the identity for cin == co); bias (4*co) = tile(b2 + bp, 4);
// mean2/mul2/add2 (4*co): bn2 tiled over the parities; out_p (b, h, w,
// 4*co). Returns a cudaError_t.
extern "C" int tt_gblock_b(const float* y1p, const float* x, const float* w2,
                           const float* wp, const float* bias,
                           const float* mean2, const float* mul2,
                           const float* add2, float* out_p, int b, int h,
                           int w, int cin, int co, void* stream) {
  if (b < 1 || h < 1 || w < 1 || cin < 1 || co < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  parity_gemm::Args a{};
  a.x0 = y1p;
  a.cx0 = 4 * co;
  a.x1 = x;
  a.cx1 = cin;
  a.full = 1;
  a.w2 = w2;
  a.wp = wp;  // the shortcut x . wp, one more segment for every parity
  a.pre_mean = mean2;
  a.pre_mul = mul2;
  a.pre_add = add2;
  a.bias = bias;
  a.out = out_p;
  a.b = b;
  a.h = h;
  a.w = w;
  a.co = co;
  return static_cast<int>(
      parity_gemm::launch(a, static_cast<cudaStream_t>(stream)));
}
