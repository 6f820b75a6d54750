// Grayscale, normalise and zero-pad a batch of raw uint8 images: the
// stream's input preparation (parallel/sharded.py:pad_batch) on the card.
//
// Replaces no TPU kernel: the JAX package grayscales and pads on the host
// (oracle/reference.py:to_grayscale_f32, parallel/sharded.py:pad_batch).
// It was added because the stream spent most of a batch doing that in
// NumPy and then copied in float32 padded planes, 55% more bytes than the
// raw colour pixels.
// In: (n, H, W) or (n, H, W, C) uint8, C = 3 or 4 (channels 0-2 read).
// Out: (n, Hp, Wp) float32, bitwise oracle.to_grayscale_f32 followed by
// a zero pad (oracle.pad_image):
//   g = 0.299 r + 0.587 g + 0.114 b, left to right, each product and each
//   sum rounded once (__fmul_rn, __fadd_rn: nvcc contracts a * b + c to
//   an FMA otherwise); the weights are the float32 values nearest the
//   decimals, as np.float32 rounds them; a grayscale image's g is its byte;
//   an image whose largest g exceeds 1.5 is divided by 255 with IEEE
//   division (__fdiv_rn), a darker one is left undivided; 0 outside
//   (H, W).
//
// Two launches on the caller's stream; nothing is read back to the host:
//   1. bright_kernel: (slices, n) blocks.  Block j of image b walks its
//      slice of the image's pixels 256 at a time and stops at the first
//      step where any thread met g > 1.5 (__syncthreads_or).  It writes
//      its one flag, so the flags need no clearing before the launch.  On
//      a lit image every block stops after its first 256 pixels, and the
//      pass reads slices * 256 pixels an image, not the image; on a dark
//      image it reads every pixel.
//   2. gray_pad_kernel: a block per (512-column strip, padded row, image),
//      a thread per 4 output columns.  A block of a real row ORs the
//      image's flags (one a thread), computes g for its pixels and divides
//      where the image is lit; every block stores its 4 floats a thread as
//      one 16-byte store (Wp % 4 == 0), else as four.
// The /255 decision needs every pixel of an image before its first output
// is written.  One launch could take it with a cross-block reduction (a
// last-block counter that rewrites dark images), but that needs zeroed
// state kept between calls; two launches write every buffer before they
// read it.
//
// Bound by bytes: n H W C read, n Hp Wp 4 written (work.py:gray_pad); at
// the stream's 32 images of 450 x 375 x 3 into 384 x 512, 16.2 + 25.2 MB,
// 12.4 us at 3.35 TB/s.  The loads are byte loads: a row of 450 RGB
// pixels is 1,350 bytes, so rows and images start 2-byte aligned at best
// and no wider load is aligned in general.  Neighbouring threads take
// neighbouring pixels, so the 12 byte loads of a warp's 128 pixels cover
// the same 384 consecutive bytes, which the L1 serves after the first
// touch: device memory sees each byte once.  The stores are whole 16-byte
// words, neighbouring threads on neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBrightThreads = 256;
constexpr int kPadThreads = 128;
constexpr int kCols = 4;                          // output columns a thread
constexpr int kStrip = kPadThreads * kCols;       // output columns a block

template <int C>
__device__ __forceinline__ float gray(const uint8_t* __restrict__ px) {
  if (C == 1) return (float)__ldg(px);
  const float r = (float)__ldg(px), g = (float)__ldg(px + 1),
              b = (float)__ldg(px + 2);
  return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                   __fmul_rn(0.114f, b));
}

// flags[b * slices + j]: 1 where slice j of image b holds a pixel with
// g > 1.5, else 0.
template <int C>
__global__ void __launch_bounds__(kBrightThreads)
bright_kernel(const uint8_t* __restrict__ src, int* __restrict__ flags,
              long long npix, long long slice, int slices) {
  const int b = blockIdx.y, j = blockIdx.x;
  const uint8_t* img = src + (long long)b * npix * C;
  const long long lo = (long long)j * slice;
  const long long hi = lo + slice < npix ? lo + slice : npix;
  int lit = 0;
  for (long long p = lo;; p += kBrightThreads) {  // lo, hi: block-uniform
    const long long q = p + threadIdx.x;
    lit = __syncthreads_or(q < hi && gray<C>(img + q * C) > 1.5f);
    if (lit || p + kBrightThreads >= hi) break;
  }
  if (threadIdx.x == 0) flags[b * slices + j] = lit;
}

template <int C>
__global__ void __launch_bounds__(kPadThreads)
gray_pad_kernel(const uint8_t* __restrict__ src,
                const int* __restrict__ flags, float* __restrict__ out,
                int h, int w, int hp, int wp, int slices, int vec) {
  const int b = blockIdx.z, y = blockIdx.y;
  const int x0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  float v[kCols] = {0.f, 0.f, 0.f, 0.f};
  if (y < h) {                                    // block-uniform
    const int lit = __syncthreads_or(
        threadIdx.x < slices && flags[b * slices + threadIdx.x]);
    const uint8_t* row = src + ((long long)b * h + y) * w * C;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int x = x0 + k;
      if (x < w) {
        const float g = gray<C>(row + (long long)x * C);
        v[k] = lit ? __fdiv_rn(g, 255.0f) : g;
      }
    }
  }
  if (x0 >= wp) return;
  float* o = out + ((long long)b * hp + y) * wp + x0;
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (x0 + k < wp) o[k] = v[k];
  }
}

template <int C>
int launch(const uint8_t* src, int* flags, float* out, int n, int h, int w,
           int hp, int wp, int slices, cudaStream_t stream) {
  const long long npix = (long long)h * w;
  const long long slice = (npix + slices - 1) / slices;
  bright_kernel<C><<<dim3(slices, n), kBrightThreads, 0, stream>>>(
      src, flags, npix, slice, slices);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = wp % kCols == 0 && (uintptr_t)out % 16 == 0;
  gray_pad_kernel<C><<<dim3((wp + kStrip - 1) / kStrip, hp, n), kPadThreads,
                       0, stream>>>(src, flags, out, h, w, hp, wp, slices,
                                    vec);
  return (int)cudaGetLastError();
}

}  // namespace

// src: (n, h, w, c) uint8, c = 1 for (n, h, w); flags: n * slices int32
// scratch (1 <= slices <= 128); out: (n, hp, wp) float32.  Two launches.
extern "C" int dm_gray_pad(const void* src, int* flags, float* out, int n,
                           int h, int w, int c, int hp, int wp, int slices,
                           void* stream) {
  if (slices < 1 || slices > kPadThreads || hp < h || wp < w)
    return (int)cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1: return launch<1>(s, flags, out, n, h, w, hp, wp, slices, st);
    case 3: return launch<3>(s, flags, out, n, h, w, hp, wp, slices, st);
    case 4: return launch<4>(s, flags, out, n, h, w, hp, wp, slices, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
