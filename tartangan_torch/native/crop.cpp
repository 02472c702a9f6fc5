// The host's batch assembly for the input pipeline: gather a shuffled
// batch of uint8 images from the archive and take each one's random crop
// (data/image_bytes.py::ImageBytesDataset.batch). numpy gathers in one
// call but crops row by row in Python; this does the whole batch with one
// memcpy per image row, images split over OpenMP threads.
//
// The port's copy of tartangan_tpu/native/crop.cpp: the same two C entry
// points, built into its own library (tartangan_torch/native/__init__.py)
// and loaded with ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// images:  (n_total, H, W, C) uint8, C-contiguous
// indices: (n,) int64 rows to gather
// ys, xs:  (n,) int32 crop offsets
// out:     (n, size, size, C) uint8, preallocated
void crop_batch_u8(const uint8_t* images, int64_t h, int64_t w, int64_t c,
                   const int64_t* indices, int64_t n,
                   const int32_t* ys, const int32_t* xs, int64_t size,
                   uint8_t* out) {
  const int64_t img_stride = h * w * c;
  const int64_t row_stride = w * c;
  const int64_t out_row = size * c;
  const int64_t out_img = size * out_row;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src =
        images + indices[i] * img_stride + ys[i] * row_stride + xs[i] * c;
    uint8_t* dst = out + i * out_img;
    for (int64_t r = 0; r < size; ++r) {
      std::memcpy(dst + r * out_row, src + r * row_stride, out_row);
    }
  }
}

// Whole images, no crop.
void gather_batch_u8(const uint8_t* images, int64_t img_bytes,
                     const int64_t* indices, int64_t n, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * img_bytes, images + indices[i] * img_bytes,
                img_bytes);
  }
}

}  // extern "C"
