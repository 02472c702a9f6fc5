// K3: fused merged-tap parity convolution for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel tartangan_tpu/ops/pallas/parity_conv.py:99
// (_kernel, built by _make_kernel at :75, launched by _fused_conv_impl at
// :130). Same function: x (B, H, W, Ci) NHWC, w2 (2, 2, Ci, 4*co) merged-tap
// weights (ops/parity.py::pack_up_conv2 or pack_full_conv2) ->
//   out[b, i, j, q*co + c] = sum_{ay, ax} x[b, i+qy+ay-1, j+qx+ax-1, :]
//                                          . w2[ay, ax, :, q*co + c]
// (zero outside the image), f32 accumulation, bias added by the caller.
//
// The TPU kernel builds the (H+1, W+1) over-produced grid in VMEM and rolls
// each parity into place; it batches whole images per program and falls
// back to XLA where one image does not fit VMEM (256x256 inputs). Here each
// output is written in place from the formula above, space is tiled (any
// shape, no fallback), and in the 'full' form only the 9 of 16
// (tap, input parity) weight blocks that are not structurally zero are
// multiplied. The GEMM core and what bounds it: parity_gemm.cuh.
#include "parity_gemm.cuh"

// full: 0 = 'up' (conv3x3 over nearest-up2 of x), 1 = 'full' (full-res
// conv3x3 over the parity stack x, Ci = 4*cin). Returns a cudaError_t.
extern "C" int tt_parity_conv(const float* x, const float* w2, float* out,
                              int b, int h, int w, int ci, int co, int full,
                              void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || (full && ci % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  parity_gemm::Args a{};
  a.x0 = x;
  a.cx0 = ci;
  a.full = full != 0;
  a.w2 = w2;
  a.out = out;
  a.b = b;
  a.h = h;
  a.w = w;
  a.co = co;
  return static_cast<int>(
      parity_gemm::launch(a, static_cast<cudaStream_t>(stream)));
}
