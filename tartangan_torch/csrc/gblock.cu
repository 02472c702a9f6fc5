// K4 and K5: the fused residual generator block's two convolutions, for
// Hopper (sm_90a), float32 or bfloat16 in and out.
//
// Replace the Pallas TPU kernels tartangan_tpu/ops/pallas/gblock.py:196
// (_kernel_a) and :234 (_kernel_b), launched by _fused_gblock_fwd_impl
// (:275, calls :292 and :333). Same functions, in the parity domain:
//
//   K4: y1p = parity-up conv1(act(bn1(x))) + b1, x (B, H, W, Cin) NHWC,
//       bn1 from the given moments of x, act = leaky-relu(0.2); y1p
//       (B, H, W, 4*co); plus the per-channel sum and sum of squares of the
//       stored y1p, (2, 4*co), for bn2, in a fixed order (no float atomics:
//       two launches give the same bits).
//   K5: out_p = full-res parity conv2(act(bn2(y1p))) + b2 + shortcut(x)
//       + bp, (B, H, W, 4*co); the shortcut is x itself (Cin == co, wp
//       null) or x . wp; depth-to-space runs outside.
//
// The TPU kernels run one image per program of a sequential grid and carry
// bn2's sums across programs in scratch. Here one core serves both, a
// halo-tile implicit GEMM on the tensor cores.
//
// What bounds it: at the '512thin' fused blocks (x 8x8 and 16x16, B 64,
// Cin = co = 128) a position costs 16*Cin*co MACs (K4) or 36*co*co (K5)
// against ~2 KB of input and output: compute-bound by far. On the float32
// FMA pipe (67 TFLOP/s) K4 and K5 take at least 0.160 and 0.361 ms a G
// forward (both shapes); as 3xTF32 on the tensor cores (495 / 3 = 165
// TFLOP/s) 0.065 and 0.146 ms. mma.sync itself, which this core uses
// (wgmma is Hopper's way to the full rate), ran at ~300 TFLOP/s TF32 on
// an H100 (chip_smoke.py --gblock-ab). The design, against what held the
// FMA core (parity_gemm) back:
//
// 1. A gathered from device memory at every K-chunk, scalar, once per
//    segment and N-block: a CTA owns an 8 x 8 tile of positions of one
//    image (ragged tiles masked) and 64 channels of all four output
//    parities. Per chunk of 8 input channels (8 of each of the four input
//    parities for K5) it stages the 10 x 10 halo once, 16-byte loads, with
//    BatchNorm + leaky-relu applied as it is staged and zero padding after
//    the prologue, as in the reference. Every tap and every output parity
//    of the CTA reads that one copy: the 4 taps of each parity's merged
//    2x2 kernel for K4, and for K5 the 9 (tap, input parity) blocks of each
//    parity that are not structurally zero (tap (ky, kx) of parity q reads
//    input parity ((qy+ky-1) & 1, (qx+kx-1) & 1) at offset
//    ((qy+ky-1) >> 1, ...)). At Cout 128 an input element is normalized
//    twice (two channel slices), against ~18 times before. (8 x 16 tiles
//    with 32 channels normalize each element 4 times and were 20 % slower
//    for K5 at 16x16.)
// 2. A shallow pipeline: the next chunk's halo is loaded into registers
//    and its weights copied by cp.async into the other buffer before this
//    chunk's products, and its prologue is spread among them (see
//    compute_chunk); one barrier a chunk of 144 (K4) or 324 (K5)
//    tensor-core products a warp.
// 3. The identity shortcut multiplied by I: here an add of x in the
//    epilogue, with the biases (a projection, Cin != co, is a dot product
//    over x's channels there: no '512thin' fused block has one).
// 4. Packing in Python at every call: each entry point takes the raw OIHW
//    weights and BatchNorm vectors (mean, var, scale, offset) and
//    launches, on the caller's stream, a pack kernel (merged taps summed
//    for K4, the TF32 hi/lo split, the swizzled layout that the main
//    kernel copies as it is; bn's per-channel constants), the main kernel
//    and, for K4, the fixed-order reduce of its partial sums (no float
//    atomics: two launches give the same bits). The caller gives one
//    scratch buffer of tt_gblock_workspace() floats.
// 5. Only the FMA pipe: the products run as 3xTF32 mma.sync.m16n8k8
//    (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi): A is split into (hi, lo) once, as
//    it is staged, the weights by the pack launch. Each chunk's products
//    are summed in a fresh accumulator and added to the running sums in
//    float32 (the tensor cores round their own accumulation toward zero:
//    summed over all of K, that was 4-6x the FMA core's error). A warp
//    computes 64 positions x 32 channels of one parity, so each A
//    fragment feeds 4 n-tiles and each B fragment 4 m-tiles; both come
//    from shared memory by ldmatrix (the halo's pixel stride and B's row
//    swizzle make both conflict-free).
//
// bfloat16 (--dtype bf16, the TPU kernels' production form): src, x and out
// are bfloat16; the statistics, the scratch and the weights' packing are
// float32. It rounds where the TPU kernels do: BatchNorm in float32, its
// result rounded to bfloat16 before leaky-relu, whose product by 0.2 is
// taken in bfloat16 (_act_from_f32, gblock.py:82-87); the packed weights
// rounded to bfloat16 once (:289, :326); K4 adds b1 in float32 and rounds
// y1 once as it stores it, and takes bn2's sums of the rounded values in
// float32 (:219-227); K5 adds b2, the shortcut and bp in float32 and rounds
// once (:260-261). Both operands of every product are then bfloat16, exact
// in TF32 (8 of its 11 significant bits), so the 3xTF32 split collapses to
// its hi*hi product with no loss: one TF32 mma a product, no lo operands.
// The per-chunk float32 summation stays (the tensor cores' own
// accumulation rounds toward zero). bf16 mma (m16n8k16) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gb {

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

constexpr int kThreads = 256;  // 8 warps: 4 output parities x 2
constexpr int kT = 8;          // tile rows and columns: 64 positions
constexpr int kBK = 8;         // channels a chunk (a k-step of the mma)
constexpr int kWN = 4;         // n-tiles of 8 channels a warp
constexpr int kNC = 2 * 8 * kWN;  // channels of a parity a CTA (2 warps)
constexpr float kEps = 1e-5f;

// FULL: K5 ('full' form over the parity stack), else K4 ('up' form)
template <bool FULL>
struct Cfg {
  static constexpr int NC = kNC;
  static constexpr int HX = kT + 2, HP = HX * HX;  // halo
  static constexpr int SLOTS = FULL ? 4 * kBK : kBK;  // staged channels
  static constexpr int LDA = SLOTS + 4;     // pixel stride: 16 B mod 128
  static constexpr int AS = HP * LDA;       // floats of one A buffer
  static constexpr int NBLK = FULL ? 9 : 16;  // weight blocks a chunk
  static constexpr int BS = NBLK * NC * kBK;  // floats of one B buffer
  static constexpr int SMEM = 4 * (AS + BS) * 4;  // (hi, lo) x 2 buffers
  static constexpr int GP = SLOTS / 4;      // float4 groups a pixel
  static constexpr int RA = (HP * GP + kThreads - 1) / kThreads;
  static_assert(kWN % 2 == 0, "ldmatrix.x4 loads two n-tiles");
};

// T: float or bf16, the type of src, x and out
struct Args {
  const void* src;     // x (K4) or y1p (K5), NHWC, T
  const void* x;       // K5: the shortcut's input (B, H, W, cin), T
  const float* whi;    // packed weights, hi and lo parts
  const float* wlo;
  const float* bn;     // [3][cpad]: mean, mul, offset of src's channels
  const float* bias;   // (co)
  const float* bias2;  // (co) or null: K5's bp
  const float* wp;     // (cin, co) or null: K5's projection
  void* out;           // (B, H, W, 4*co), T
  float* partial;      // K4: (rows, 2, 4*co)
  int b, h, w, cin, co;
  int cpp;             // channels of each input parity (K4 cin, K5 co)
  int cpad;
  int nch;             // chunks
  int vec;             // quad loads of src (16 or 8 bytes)
  int tiles_h, tiles_w;  // tiles an image
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float leaky_relu(float v) {
  return v >= 0.f ? v : v * 0.2f;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// what the activation stages: float32, leaky-relu(bn(v)) as above;
// bfloat16, _act_from_f32: the sign from float32, the product by
// bfloat16(0.2) = 0.2001953125 rounded to bfloat16
template <class T>
__device__ __forceinline__ float act_of(float t);

template <>
__device__ __forceinline__ float act_of<float>(float t) {
  return leaky_relu(t);
}

template <>
__device__ __forceinline__ float act_of<bf16>(float t) {
  const float c = round_bf16(t);
  return t >= 0.f ? c : round_bf16(c * 0.2001953125f);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// a quad of src's channels as float32 (p aligned for the quad)
__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_quad(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two neighbouring outputs (p aligned for the pair)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }
__device__ __forceinline__ void store_one(bf16* p, float a) {
  *p = __float2bfloat16(a);
}

// B's smem (and packed) layout: row r = block * NC + n of 8 floats, its two
// 16-byte halves swapped when bit 2 of r is set, so that ldmatrix's eight
// rows of one half fall in eight different bank quads
__host__ __device__ __forceinline__ int b_offset(int row, int k) {
  return row * kBK + 4 * ((k >> 2) ^ ((row >> 2) & 1)) + (k & 3);
}

// weight block t of output parity q: its slot in the staged halo, its
// offset (dy, dx) and its B block
struct Block {
  int slot, dy, dx, blk;
};

template <bool FULL>
__device__ __forceinline__ Block block_of(int q, int t) {
  const int qy = q >> 1, qx = q & 1;
  if (FULL) {
    const int sy = qy + t / 3 - 1, sx = qx + t % 3 - 1;
    return Block{(2 * (sy & 1) + (sx & 1)) * kBK, sy >> 1, sx >> 1, t};
  }
  const int ay = t >> 1, ax = t & 1;
  return Block{0, qy + ay - 1, qx + ax - 1, 4 * q + t};
}

struct Tile {
  int b, i0, j0;
};

__device__ __forceinline__ Tile tile_of(const Args& a) {
  const int t = static_cast<int>(blockIdx.x);
  const int per_img = a.tiles_h * a.tiles_w;
  const int r = t % per_img;
  return Tile{t / per_img, (r / a.tiles_w) * kT, (r % a.tiles_w) * kT};
}

// Bit r: this thread's halo group r lies in the image (the halo does not
// move from chunk to chunk). A thread's groups share one channel offset:
// group e = tid + r * kThreads, and GP divides kThreads.
template <bool FULL>
__device__ __forceinline__ uint32_t halo_mask(const Args& a, const Tile& tl) {
  using C = Cfg<FULL>;
  static_assert(kThreads % C::GP == 0, "one channel offset a thread");
  uint32_t m = 0;
#pragma unroll
  for (int r = 0; r < C::RA; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int pix = e / C::GP;
    const int gi = tl.i0 - 1 + pix / C::HX, gj = tl.j0 - 1 + pix % C::HX;
    if (e < C::HP * C::GP && gi >= 0 && gi < a.h && gj >= 0 && gj < a.w) {
      m |= 1u << r;
    }
  }
  return m;
}

// the thread's channel offset in the staged pixel (4 * g) and in the
// source's channels of one input parity
template <bool FULL>
__device__ __forceinline__ int group_of_thread() {
  return static_cast<int>(threadIdx.x) % Cfg<FULL>::GP;
}

// this thread's share of chunk c's halo, raw, into registers as float32
template <bool FULL, class T>
__device__ __forceinline__ void load_a(const Args& a, const Tile& tl, int c,
                                       uint32_t mask,
                                       float4 (&ra)[Cfg<FULL>::RA]) {
  using C = Cfg<FULL>;
  const T* src = static_cast<const T*>(a.src);
  const int cx = FULL ? 4 * a.co : a.cin;
  const long long img = static_cast<long long>(tl.b) * a.h;
  const int g = group_of_thread<FULL>();
  const int k = c * kBK + 4 * (FULL ? g % 2 : g);
  const int ch = (FULL ? (g / 2) * a.cpp : 0) + k;
#pragma unroll
  for (int r = 0; r < C::RA; ++r) {
    const int pix = (threadIdx.x + r * kThreads) / C::GP;
    const int gi = tl.i0 - 1 + pix / C::HX, gj = tl.j0 - 1 + pix % C::HX;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (((mask >> r) & 1) && k < a.cpp) {
      const T* p = src + ((img + gi) * a.w + gj) * cx + ch;
      if (a.vec) {
        v = load_quad(p);
      } else {
        v.x = to_float(p[0]);
        if (k + 1 < a.cpp) v.y = to_float(p[1]);
        if (k + 2 < a.cpp) v.z = to_float(p[2]);
        if (k + 3 < a.cpp) v.w = to_float(p[3]);
      }
    }
    ra[r] = v;
  }
}

// group r of load_a's registers through the prologue (BatchNorm's
// constants from shared memory, rows padded with zeros to cpad), split,
// into (hi, lo); zero outside the image and past the last channel.
// bfloat16: the activation is bfloat16, exact in TF32: hi only
template <bool FULL, class T>
__device__ __forceinline__ void store_a(const Args& a, int c, uint32_t mask,
                                        int r, const float4& raw,
                                        const float* sbn, float* hi,
                                        float* lo) {
  using C = Cfg<FULL>;
  const int e = threadIdx.x + r * kThreads;
  if (e >= C::HP * C::GP) return;
  const int g = group_of_thread<FULL>();
  const int k = c * kBK + 4 * (FULL ? g % 2 : g);
  const bool in = (mask >> r) & 1;
  const float4 mean = *reinterpret_cast<const float4*>(sbn + k);
  const float4 mul = *reinterpret_cast<const float4*>(sbn + a.cpad + k);
  const float4 off = *reinterpret_cast<const float4*>(sbn + 2 * a.cpad + k);
  const float v[4] = {raw.x, raw.y, raw.z, raw.w};
  const float mv[4] = {mean.x, mean.y, mean.z, mean.w};
  const float uv[4] = {mul.x, mul.y, mul.z, mul.w};
  const float ov[4] = {off.x, off.y, off.z, off.w};
  constexpr bool split = sizeof(T) == 4;
  float h4[4], l4[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float t = in && k + u < a.cpp
                        ? act_of<T>(fmaf(v[u] - mv[u], uv[u], ov[u]))
                        : 0.f;
    h4[u] = split ? to_tf32(t) : t;
    l4[u] = to_tf32(t - h4[u]);
  }
  const int o = (e / C::GP) * C::LDA + 4 * g;
  *reinterpret_cast<float4*>(hi + o) = make_float4(h4[0], h4[1], h4[2], h4[3]);
  if (split) {
    *reinterpret_cast<float4*>(lo + o) =
        make_float4(l4[0], l4[1], l4[2], l4[3]);
  }
}

// chunk c's weights (hi, and lo if split) of this CTA's channel slice, as
// packed
template <bool FULL, bool SPLIT>
__device__ __forceinline__ void load_b(const Args& a, int c, float* hi,
                                       float* lo) {
  using C = Cfg<FULL>;
  const long long base =
      (static_cast<long long>(blockIdx.y) * a.nch + c) * C::BS;
  for (int e = threadIdx.x; e < C::BS / 4; e += kThreads) {
    cp_async16(hi + 4 * e, a.whi + base + 4 * e);
    if (SPLIT) cp_async16(lo + 4 * e, a.wlo + base + 4 * e);
  }
}

// One staged chunk into acc. Its products (8 channels x the parity's
// weight blocks) are summed apart into a fresh accumulator that a float32
// add (round to nearest) moves into acc: the tensor cores round their own
// accumulation toward zero, and summed over all of K that cost 4-6x the
// float32 FMA loop's error; summed over one chunk it does not. stage(r)
// stages the next chunk's halo group r: the calls are spread over the
// blocks, so that their ALU work issues between the tensor-core products.
// SPLIT false (bfloat16 operands): the hi*hi products only.
template <bool FULL, bool SPLIT, class Stage>
__device__ __forceinline__ void compute_chunk(float (&acc)[4][kWN][4],
                                              const float* ahi,
                                              const float* alo,
                                              const float* bhi,
                                              const float* blo,
                                              const Stage& stage) {
  constexpr int NB = FULL ? 9 : 4;
  using C = Cfg<FULL>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp >> 1, sub = warp & 1;
  // ldmatrix rows: A, position r = lane & 15 of each m-tile, k half
  // lane >> 4; B, channel lane & 7 of n-tile lane >> 4, k half
  // (lane >> 3) & 1
  const int ar = lane & 15, akh = lane >> 4;
  const int bn = sub * kWN * 8 + 8 * (lane >> 4) + (lane & 7);
  const int bkh = (lane >> 3) & 1;
  float t[4][kWN][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < kWN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) t[j][n][i] = 0.f;
#pragma unroll
  for (int tb = 0; tb < NB; ++tb) {
    const Block blk = block_of<FULL>(q, tb);
    uint32_t bh[kWN][2], bl[kWN][2];
#pragma unroll
    for (int np = 0; np < kWN / 2; ++np) {
      const int row = blk.blk * C::NC + bn + 16 * np;
      const int off = b_offset(row, 4 * bkh);
      uint32_t r[4];
      ldmatrix_x4(r, bhi + off);
      bh[2 * np][0] = r[0];
      bh[2 * np][1] = r[1];
      bh[2 * np + 1][0] = r[2];
      bh[2 * np + 1][1] = r[3];
      if (!SPLIT) continue;
      ldmatrix_x4(r, blo + off);
      bl[2 * np][0] = r[0];
      bl[2 * np][1] = r[1];
      bl[2 * np + 1][0] = r[2];
      bl[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = 16 * j + ar;
      const int pix = (pos / kT + 1 + blk.dy) * C::HX + pos % kT + 1 + blk.dx;
      const int off = pix * C::LDA + blk.slot + 4 * akh;
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, ahi + off);
      if (SPLIT) {
        ldmatrix_x4(al, alo + off);
        // the small terms first, then hi*hi
#pragma unroll
        for (int n = 0; n < kWN; ++n) {
          mma_tf32(t[j][n], al, bh[n][0], bh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kWN; ++n) {
          mma_tf32(t[j][n], ah, bl[n][0], bl[n][1]);
        }
      }
#pragma unroll
      for (int n = 0; n < kWN; ++n) mma_tf32(t[j][n], ah, bh[n][0], bh[n][1]);
    }
#pragma unroll
    for (int r = tb * C::RA / NB; r < (tb + 1) * C::RA / NB; ++r) stage(r);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < kWN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] += t[j][n][i];
}

template <bool FULL, class T>
__global__ void __launch_bounds__(kThreads, 1) conv_kernel(const Args a) {
  using C = Cfg<FULL>;
  constexpr bool split = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;               // [buffer][hi, lo][AS]
  float* sb = smem + 4 * C::AS;   // [buffer][hi, lo][BS]
  const Tile tl = tile_of(a);

  float acc[4][kWN][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < kWN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;

  // BatchNorm's constants, [3][cpad], for every chunk
  float* sbn = sb + 4 * C::BS;
  for (int e = threadIdx.x; e < 3 * a.cpad; e += kThreads) sbn[e] = a.bn[e];
  const uint32_t mask = halo_mask<FULL>(a, tl);
  float4 ra[C::RA];
  load_a<FULL, T>(a, tl, 0, mask, ra);
  load_b<FULL, split>(a, 0, sb, sb + C::BS);
  cp_async_commit();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < C::RA; ++r) {
    store_a<FULL, T>(a, 0, mask, r, ra[r], sbn, sa, sa + C::AS);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < a.nch; ++c) {
    const int cur = c & 1, nxt = cur ^ 1;
    const bool more = c + 1 < a.nch;
    if (more) {
      load_a<FULL, T>(a, tl, c + 1, mask, ra);
      load_b<FULL, split>(a, c + 1, sb + 2 * nxt * C::BS,
                          sb + (2 * nxt + 1) * C::BS);
      cp_async_commit();
    }
    float* nhi = sa + 2 * nxt * C::AS;
    float* nlo = sa + (2 * nxt + 1) * C::AS;
    compute_chunk<FULL, split>(
        acc, sa + 2 * cur * C::AS, sa + (2 * cur + 1) * C::AS,
        sb + 2 * cur * C::BS, sb + (2 * cur + 1) * C::BS, [&](int r) {
          if (more) {
            store_a<FULL, T>(a, c + 1, mask, r, ra[r], sbn, nhi, nlo);
          }
        });
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: fragment c0, c1 at (row g, columns 2*t4, 2*t4 + 1), c2, c3
  // at row g + 8. The biases and the shortcut in float32, the result
  // rounded once to T as it is stored; K4's sums of the stored values
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* xs = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int q = warp >> 1, sub = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int c4 = 4 * a.co;
  const long long img = static_cast<long long>(tl.b) * a.h;
  float s1[kWN][2], s2[kWN][2];
#pragma unroll
  for (int n = 0; n < kWN; ++n) s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int pos = 16 * j + g + 8 * hrow;
      const int i = tl.i0 + pos / kT, jj = tl.j0 + pos % kT;
      if (i >= a.h || jj >= a.w) continue;
      const long long pix = (img + i) * a.w + jj;
#pragma unroll
      for (int n = 0; n < kWN; ++n) {
        const int ch = blockIdx.y * C::NC + sub * kWN * 8 + 8 * n + 2 * t4;
        float v[2] = {acc[j][n][2 * hrow], acc[j][n][2 * hrow + 1]};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (ch + u >= a.co) continue;
          float t = v[u] + a.bias[ch + u];
          if (FULL) {
            if (a.bias2 != nullptr) t += a.bias2[ch + u];
            const T* xr = xs + pix * a.cin;
            if (a.wp == nullptr) {
              t += to_float(xr[ch + u]);
            } else {
              // the projection's weights rounded to T, as the reference
              // casts tile(wp, 4) to the compute dtype
              float s = 0.f;
              for (int cc = 0; cc < a.cin; ++cc) {
                const float wv =
                    a.wp[static_cast<long long>(cc) * a.co + ch + u];
                s = fmaf(to_float(xr[cc]), split ? wv : round_bf16(wv), s);
              }
              t += s;
            }
            t = split ? t : round_bf16(t);
          } else {
            t = split ? t : round_bf16(t);
            s1[n][u] += t;
            s2[n][u] += t * t;
          }
          v[u] = t;
        }
        T* dst = out + pix * c4 + q * a.co + ch;
        if (ch + 1 < a.co && (a.co & 1) == 0) {
          store_pair(dst, v[0], v[1]);
        } else if (ch < a.co) {
          store_one(dst, v[0]);
          if (ch + 1 < a.co) store_one(dst + 1, v[1]);
        }
      }
    }
  }
  if (FULL) return;
  // the column sums over the warp's rows: the eight lanes of one t4, in a
  // fixed order, into this warp's partial row
#pragma unroll
  for (int n = 0; n < kWN; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        s1[n][u] += __shfl_xor_sync(0xffffffffu, s1[n][u], d);
        s2[n][u] += __shfl_xor_sync(0xffffffffu, s2[n][u], d);
      }
  if (g != 0) return;
  const long long row = blockIdx.x;
#pragma unroll
  for (int n = 0; n < kWN; ++n) {
    const int ch = blockIdx.y * C::NC + sub * kWN * 8 + 8 * n + 2 * t4;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (ch + u >= a.co) continue;
      a.partial[(row * 2) * c4 + q * a.co + ch + u] = s1[n][u];
      a.partial[(row * 2 + 1) * c4 + q * a.co + ch + u] = s2[n][u];
    }
  }
}

struct PackArgs {
  const float* w;  // (co, ci, 3, 3) OIHW
  const float* mean;
  const float* var;
  const float* scale;
  const float* offset;
  float* whi;
  float* wlo;
  float* bn;
  int full, ci, co, nc, nch, ny, cpp, cpad;
  int bf16;  // round to bfloat16 (lo = 0) instead of the TF32 split
};

// the weights of every CTA slice and chunk in the main kernel's layout,
// split into (hi, lo), or for bfloat16 rounded to it (hi; lo = 0), after
// the merged taps are summed in float32; bn's per-channel mean, multiplier
// (rsqrt(var + eps) * scale) and offset, zero past cpp
__global__ void pack_weights(const PackArgs p) {
  const int nblk = p.full ? 9 : 16;
  const long long per = static_cast<long long>(nblk) * p.nc * kBK;
  const long long total = per * p.nch * p.ny;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total + p.cpad; e += stride) {
    if (e >= total) {
      const int c = static_cast<int>(e - total);
      float m = 0.f, u = 0.f, o = 0.f;
      if (c < p.cpp) {
        m = p.mean[c];
        u = rsqrtf(p.var[c] + kEps) * p.scale[c];
        o = p.offset[c];
      }
      p.bn[c] = m;
      p.bn[p.cpad + c] = u;
      p.bn[2 * p.cpad + c] = o;
      continue;
    }
    const int slab = static_cast<int>(e / per);  // ny * nch + chunk
    const int r = static_cast<int>(e % per);
    const int row = r / kBK, pk = r % kBK;
    // invert b_offset: physical half pk >> 2 holds logical half
    // (pk >> 2) ^ ((row >> 2) & 1)
    const int k = 4 * ((pk >> 2) ^ ((row >> 2) & 1)) + (pk & 3);
    const int blk = row / p.nc, nl = row % p.nc;
    const int n = (slab / p.nch) * p.nc + nl;
    const int c = (slab % p.nch) * kBK + k;
    float v = 0.f;
    if (n < p.co && c < p.ci) {
      const float* wk = p.w + (static_cast<long long>(n) * p.ci + c) * 9;
      if (p.full) {
        v = wk[blk];  // the raw tap (ky, kx) = (blk / 3, blk % 3)
      } else {
        // merged tap (ay, ax) of parity (qy, qx): the 3x3 taps whose
        // source row (qy + ky - 1) >> 1 is the tap's offset qy + ay - 1
        const int q = blk >> 2, t = blk & 3;
        const int qy = q >> 1, qx = q & 1, ay = t >> 1, ax = t & 1;
        for (int ky = 0; ky < 3; ++ky) {
          if (((qy + ky - 1) >> 1) != qy + ay - 1) continue;
          for (int kx = 0; kx < 3; ++kx) {
            if (((qx + kx - 1) >> 1) != qx + ax - 1) continue;
            v += wk[3 * ky + kx];
          }
        }
      }
    }
    const float hi = p.bf16 ? round_bf16(v) : to_tf32(v);
    p.whi[e] = hi;
    p.wlo[e] = p.bf16 ? 0.f : to_tf32(v - hi);
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

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Layout {
  long long tiles, ny, nch, per, wfloats, bn, rows, total;
};

// the scratch the caller gives: packed weights (hi, lo), bn constants and,
// for K4, the partial sums
inline Layout layout(int full, int b, int h, int w, int cin, int co) {
  Layout l{};
  const int ci = full ? co : cin;  // the conv's input channels
  l.tiles = static_cast<long long>(b) * ((h + kT - 1) / kT) *
            ((w + kT - 1) / kT);
  l.ny = (co + kNC - 1) / kNC;
  l.nch = (ci + kBK - 1) / kBK;
  l.per = static_cast<long long>(full ? 9 : 16) * kNC * kBK;
  l.wfloats = l.per * l.nch * l.ny;
  l.bn = 3LL * round_up(ci, kBK);
  l.rows = full ? 0 : l.tiles;
  l.total = 2 * l.wfloats + l.bn + l.rows * 2 * 4LL * co;
  return l;
}

template <bool FULL, class T>
cudaError_t launch_conv(const Args& a, long long tiles, long long ny,
                        cudaStream_t s) {
  using C = Cfg<FULL>;
  const int smem = C::SMEM + 3 * a.cpad * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<FULL, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  conv_kernel<FULL, T>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(ny)),
         kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// pack, then the main kernel (and K4's reduce), on stream s; src, x and
// out float32 (bfloat16 = 0) or bfloat16 (1), the library's own type
cudaError_t run(int full, const void* src, const void* x, const float* w,
                const float* bias, const float* bias2, const float* wp,
                const float* mean, const float* var, const float* scale,
                const float* offset, void* out, float* stats, float* work,
                long long work_floats, int b, int h, int wd, int cin, int co,
                int bfloat16, cudaStream_t s) {
  if (b < 1 || h < 1 || wd < 1 || cin < 1 || co < 1 ||
      (full && wp == nullptr && cin != co) || bfloat16 != kBfloat16) {
    return cudaErrorInvalidValue;
  }
  const Layout l = layout(full, b, h, wd, cin, co);
  if (work_floats != l.total || l.tiles > 2147483647LL || l.ny > 65535 ||
      reinterpret_cast<uintptr_t>(work) % 16) {
    return cudaErrorInvalidValue;
  }
  const int ci = full ? co : cin;
  PackArgs p{w, mean, var, scale, offset, work, work + l.wfloats,
             work + 2 * l.wfloats, full, ci, co, kNC,
             static_cast<int>(l.nch), static_cast<int>(l.ny), ci,
             round_up(ci, kBK), bfloat16};
  const long long n = l.wfloats + p.cpad;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  pack_weights<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024),
                 threads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args a{};
  a.src = src;
  a.x = x;
  a.whi = p.whi;
  a.wlo = p.wlo;
  a.bn = p.bn;
  a.bias = bias;
  a.bias2 = bias2;
  a.wp = wp;
  a.out = out;
  a.partial = p.bn + l.bn;
  a.b = b;
  a.h = h;
  a.w = wd;
  a.cin = cin;
  a.co = co;
  a.cpp = ci;
  a.cpad = p.cpad;
  a.nch = static_cast<int>(l.nch);
  a.vec = ci % 4 == 0 &&
          reinterpret_cast<uintptr_t>(src) % (bfloat16 ? 8 : 16) == 0;
  a.tiles_h = (h + kT - 1) / kT;
  a.tiles_w = (wd + kT - 1) / kT;
  err = full ? launch_conv<true, Elem>(a, l.tiles, l.ny, s)
             : launch_conv<false, Elem>(a, l.tiles, l.ny, s);
  if (err != cudaSuccess || full) return err;
  const int c4 = 4 * co;
  reduce_partials<<<(c4 + 127) / 128, 128, 0, s>>>(
      a.partial, static_cast<int>(l.rows), c4, stats);
  return cudaGetLastError();
}

}  // namespace gb

// The floats of scratch that tt_gblock_a (full = 0) or tt_gblock_b
// (full = 1) takes at these shapes (ops/gblock.py::workspace_floats
// computes the same from its mirror of the tile policy).
extern "C" long long tt_gblock_workspace(int full, int b, int h, int w,
                                         int cin, int co) {
  return gb::layout(full, b, h, w, cin, co).total;
}

// K4. x (b, h, w, cin) NHWC; w1 (co, cin, 3, 3) OIHW; b1 (co); bn1 as the
// per-channel mean, var, scale, offset (cin); y1p (b, h, w, 4*co); stats
// (2, 4*co); work: tt_gblock_workspace(0, ...) floats, 16-byte aligned.
// x and y1p float32 (bfloat16 = 0) or bfloat16 (1), the rest float32; all
// contiguous. Returns a cudaError_t.
extern "C" int tt_gblock_a(const void* x, const float* w1, const float* b1,
                           const float* mean1, const float* var1,
                           const float* scale1, const float* offset1,
                           void* y1p, float* stats, float* work,
                           long long work_floats, int b, int h, int w,
                           int cin, int co, int bfloat16, void* stream) {
  return static_cast<int>(gb::run(
      0, x, nullptr, w1, b1, nullptr, nullptr, mean1, var1, scale1, offset1,
      y1p, stats, work, work_floats, b, h, w, cin, co, bfloat16,
      static_cast<cudaStream_t>(stream)));
}

// K5. y1p (b, h, w, 4*co); x (b, h, w, cin); w2 (co, co, 3, 3) OIHW; b2
// (co); wp (cin, co) and bp (co), or both null for the identity shortcut
// (cin == co); bn2 as mean, var, scale, offset (co), the same for the four
// parities; out_p (b, h, w, 4*co); work: tt_gblock_workspace(1, ...)
// floats. y1p, x and out_p float32 (bfloat16 = 0) or bfloat16 (1), the
// rest float32. Returns a cudaError_t.
extern "C" int tt_gblock_b(const void* y1p, const void* x, const float* w2,
                           const float* b2, const float* wp, const float* bp,
                           const float* mean2, const float* var2,
                           const float* scale2, const float* offset2,
                           void* out_p, float* work, long long work_floats,
                           int b, int h, int w, int cin, int co, int bfloat16,
                           void* stream) {
  return static_cast<int>(gb::run(
      1, y1p, x, w2, b2, bp, wp, mean2, var2, scale2, offset2, out_p,
      nullptr, work, work_floats, b, h, w, cin, co, bfloat16,
      static_cast<cudaStream_t>(stream)));
}
