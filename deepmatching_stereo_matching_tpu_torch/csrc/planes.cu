// PLANES: grad_hist's (magnitude, bin) planes from a stack of float32
// images, in one launch: what K1b and K4b take in place of the 8-bin
// orientation histograms (models/descriptors.py:grad_hist_magbin).
//
// Replaces no TPU kernel: the JAX package builds these planes in XLA
// (deepmatching_stereo_matching_tpu/models/descriptors.py,
// magbin_from_gradients after np.gradient's central differences).  It was
// added because the port built them from ~36 torch operations an image
// stack, each a pass through device memory with int64 octants between
// them: 0.91 of a 1.62 ms grad_hist KITTI step at 4 pairs.
// In: (n, H, W) float32 images, H, W >= 2.  Out: two (n, H, W) float32
// planes, bitwise the plain version (descriptors.grad_hist_magbin_torch):
//   gx along W and gy along H as np.gradient takes them: x[1] - x[0] at
//   the first index, x[n-1] - x[n-2] at the last (both, for n = 2), and
//   (x[i+1] - x[i-1]) * 0.5 between, a subtraction rounded, then a
//   multiply by 0.5 rounded (__fsub_rn, __fmul_rn; a product of a
//   difference has no add to contract into an FMA, and the intrinsics
//   keep it so);
//   mag = |gx| + |gy| (__fadd_rn);
//   the octant from the exact comparisons of magbin_from_gradients, in
//   its order and with its ties: gy >= 0 (so -0.0 counts as up), then
//   gx > 0 up and gx >= 0 down, then ay >= ax or ay > ax as each branch
//   has it; written as a float 0.0-7.0.
//
// Bound by bytes: 4 B a pixel read, 8 B written (work.py:magbin_planes);
// at the grad_hist KITTI step's two stacks of 64 images of 384 x 1536,
// 905,969,664 B, 0.2704 ms at 3.35 TB/s.  A block takes a strip of 512
// columns over a band of kBand rows of one image, a thread 4 columns.
// Walking down its band, a thread keeps the rows above, at and below in
// registers and loads one new row a step (16-byte loads where W % 4 == 0
// and the planes are 16-byte aligned, else 4-byte ones), the load of the
// row after next issued before the current row's arithmetic.  The column
// neighbours at a quad's ends come from the next lane by a shuffle, and
// at a warp's ends by a load the L1 serves.  The stores are 16-byte
// words, neighbouring threads on neighbouring words.  Device memory sees
// each input row about once whatever the band: the halo rows a band
// reads again come from the L2, which holds the rows that neighbouring
// blocks are reading.  So the band trades halo loads for blocks in
// flight; on an H100 at that shape, bands of 2 and 4 rows took 0.314 and
// 0.318 ms, of 1 and 8 rows 0.343, a whole image 0.431.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                          // columns a thread
constexpr int kStrip = kThreads * kCols;          // columns a block
constexpr int kBand = 2;                          // rows a block walks
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

struct Quad {
  float v[kCols];
};

// Columns x0..x0+3 of a row; 0 past w.
template <bool VEC>
__device__ __forceinline__ Quad load_quad(const float* __restrict__ row,
                                          int x0, int w) {
  Quad q = {{0.f, 0.f, 0.f, 0.f}};
  if (VEC) {
    if (x0 < w) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row + x0));
      q.v[0] = f.x; q.v[1] = f.y; q.v[2] = f.z; q.v[3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (x0 + k < w) q.v[k] = __ldg(row + x0 + k);
  }
  return q;
}

// np.gradient at index i of a line of n >= 2 samples.
__device__ __forceinline__ float gradient(float prev, float cur, float next,
                                          int i, int n) {
  if (i == 0) return __fsub_rn(next, cur);
  if (i == n - 1) return __fsub_rn(cur, prev);
  return __fmul_rn(__fsub_rn(next, prev), 0.5f);
}

// descriptors.magbin_from_gradients' octant, its comparisons in its order.
__device__ __forceinline__ float octant(float gx, float gy) {
  const float ax = fabsf(gx), ay = fabsf(gy);
  int b;
  if (gy >= 0.f)
    b = gx > 0.f ? (ay >= ax ? 5 : 4) : (ay > ax ? 6 : 7);
  else
    b = gx >= 0.f ? (ay > ax ? 2 : 3) : (ay >= ax ? 1 : 0);
  return (float)b;
}

// grid (ceil(w / kStrip), min(n * ceil(h / kBand), kMaxGridY)); blockIdx.y
// strides over (image, band) pairs.  Every lane of a warp runs every step,
// so the shuffles see the whole warp; lanes past w load and store nothing.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
magbin_planes_kernel(const float* __restrict__ img, float* __restrict__ mag,
                     float* __restrict__ bin, int n, int h, int w) {
  const int x0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  const int lane = threadIdx.x & 31;
  const int bands = (h + kBand - 1) / kBand;
  const long long items = (long long)n * bands;
  for (long long it = blockIdx.y; it < items; it += gridDim.y) {
    const long long b = it / bands;
    const int y0 = (int)(it - b * bands) * kBand;
    const int y1 = min(y0 + kBand, h);
    const float* base = img + b * h * (long long)w;
    const long long out0 = b * h * (long long)w;
    Quad cur = load_quad<VEC>(base + (long long)y0 * w, x0, w);
    Quad up = y0 > 0 ? load_quad<VEC>(base + (long long)(y0 - 1) * w, x0, w)
                     : cur;
    Quad dn = y0 + 1 < h
                  ? load_quad<VEC>(base + (long long)(y0 + 1) * w, x0, w)
                  : cur;
    for (int y = y0; y < y1; ++y) {
      const Quad nxt =
          y + 2 < h && y + 1 < y1
              ? load_quad<VEC>(base + (long long)(y + 2) * w, x0, w)
              : dn;
      const float* row = base + (long long)y * w;
      float left = __shfl_up_sync(kFull, cur.v[kCols - 1], 1);
      float right = __shfl_down_sync(kFull, cur.v[0], 1);
      if (lane == 0) left = x0 > 0 && x0 - 1 < w ? __ldg(row + x0 - 1) : 0.f;
      if (lane == 31) right = x0 + kCols < w ? __ldg(row + x0 + kCols) : 0.f;
      Quad m, o;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float prev = k == 0 ? left : cur.v[k - 1];
        const float next = k == kCols - 1 ? right : cur.v[k + 1];
        const float gx = gradient(prev, cur.v[k], next, x0 + k, w);
        const float gy = gradient(up.v[k], cur.v[k], dn.v[k], y, h);
        m.v[k] = __fadd_rn(fabsf(gx), fabsf(gy));
        o.v[k] = octant(gx, gy);
      }
      const long long at = out0 + (long long)y * w + x0;
      if (VEC) {
        if (x0 < w) {
          *reinterpret_cast<float4*>(mag + at) =
              make_float4(m.v[0], m.v[1], m.v[2], m.v[3]);
          *reinterpret_cast<float4*>(bin + at) =
              make_float4(o.v[0], o.v[1], o.v[2], o.v[3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (x0 + k < w) {
            mag[at + k] = m.v[k];
            bin[at + k] = o.v[k];
          }
      }
      up = cur;
      cur = dn;
      dn = nxt;
    }
  }
}

}  // namespace

// img: (n, h, w) float32; mag, bin: (n, h, w) float32.  One launch.
extern "C" int dm_magbin_planes(const float* img, float* mag, float* bin,
                                int n, int h, int w, void* stream) {
  if (n < 0 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long items = (long long)n * ((h + kBand - 1) / kBand);
  const dim3 grid((w + kStrip - 1) / kStrip,
                  (unsigned)(items < kMaxGridY ? items : kMaxGridY));
  const cudaStream_t st = (cudaStream_t)stream;
  const int vec = w % kCols == 0 && (uintptr_t)img % 16 == 0 &&
                  (uintptr_t)mag % 16 == 0 && (uintptr_t)bin % 16 == 0;
  if (vec)
    magbin_planes_kernel<true><<<grid, kThreads, 0, st>>>(img, mag, bin, n,
                                                          h, w);
  else
    magbin_planes_kernel<false><<<grid, kThreads, 0, st>>>(img, mag, bin, n,
                                                           h, w);
  return (int)cudaGetLastError();
}
