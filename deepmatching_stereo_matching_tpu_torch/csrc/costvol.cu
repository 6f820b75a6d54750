// K2 and K6: level-0 correlation cost volume, in two layouts.
//
// K2 (D-major, (b, d, i, j)) replaces deepmatching_stereo_matching_tpu/
// ops/costvol_pallas.py:_kernel_dmajor (via _cost_volume_rows(dmajor=True)
// / cost_volume_dmajor).  K6 (row layout, (b, i, d, j)) replaces
// costvol_pallas.py:_kernel (via _cost_volume_rows(dmajor=False),
// cost_volume and cost_volume_slab): the volume of the sharded strategies,
// where one patch row's planes are contiguous and so are the H-chunks
// that dslab's all_to_all moves.
// out[b, .., d, .., j] = relu(<src[b, i, j, :], tgt[b, i, x0, :]>), with
// x0 = p*(j + origin_offset) -+ (d_offset + d) (minus forward, plus
// reverse); 0 where x0 falls outside [0, wt) or d_offset + d >= max_d.
// d_offset makes the volume one disparity slab [d_offset, d_offset + d0)
// of a larger one.  The TPU kernel shifted the target by whole patch
// columns instead, because its schedule could not depend on a traced
// offset; here it is a plain argument, so any slab size runs the kernel.
//
// One kernel, the layout a template flag (as the magbin form is on the
// fused kernel), and every dot product the same `dot` in the same order:
// a slab of K6 is bitwise equal to the same bins of K2, and the sharded
// strategies to the unsharded pipeline.
//
// A thread owns one (b, i, j) and loops over d (the source descriptor is
// re-read from L1 for every d); consecutive threads write consecutive j,
// so every store is coalesced.  The TPU kernel's phase decomposition of
// the target columns existed only to avoid strided lane gathers; here a
// thread reads its target descriptor directly.  Bound on this card by
// device memory: the volume write (4 B per output) and the target reads,
// which L1/L2 serve (neighbouring j read overlapping target columns); 2*C
// flops per output is far below the compute roof.  What the write pattern
// costs depends on the blocks resident together: in the D-major layout
// they are neighbouring rows i of one plane, so they write one contiguous
// stretch.  In the row layout the same grid would put their writes
// d0 * w0 floats apart and ran 2.5x slower on the H100, so there the
// grid splits d into chunks of kRowsChunk, j-blocks fastest, then
// d-chunks, then rows: resident blocks write neighbouring rows of one
// (b, i) instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsChunk = 8;

__device__ __forceinline__ float dot(const float* __restrict__ a,
                                     const float* __restrict__ b, int c) {
  float acc = 0.0f;
  for (int k = 0; k < c; ++k) acc += a[k] * b[k];
  return acc;
}

template <bool ROWS>
__global__ void __launch_bounds__(kThreads)
costvol_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
               float* __restrict__ out, int h0, int w0, int wt, int c, int d0,
               int p, int max_d, int reverse, int origin_offset,
               int d_offset) {
  int j, i, b, d_lo, d_hi;
  if (ROWS) {
    const unsigned nj = (w0 + kThreads - 1) / kThreads;
    const unsigned nd = (d0 + kRowsChunk - 1) / kRowsChunk;
    const unsigned t = blockIdx.x / nj;
    const unsigned row = t / nd;
    j = (blockIdx.x % nj) * kThreads + threadIdx.x;
    i = row % h0;
    b = row / h0;
    d_lo = (t % nd) * kRowsChunk;
    d_hi = min(d0, d_lo + kRowsChunk);
  } else {
    j = blockIdx.x * kThreads + threadIdx.x;
    i = blockIdx.y;
    b = blockIdx.z;
    d_lo = 0;
    d_hi = d0;
  }
  if (j >= w0) return;
  const float* sp = src + (((size_t)b * h0 + i) * w0 + j) * c;
  const float* trow = tgt + ((size_t)b * h0 + i) * wt * c;
  const size_t i_stride = ROWS ? (size_t)d0 * w0 : (size_t)w0;
  const size_t d_stride = ROWS ? (size_t)w0 : (size_t)h0 * w0;
  float* o = out + (size_t)b * d0 * h0 * w0 + i * i_stride + j;
  const int xs = p * (j + origin_offset);
  for (int d = d_lo; d < d_hi; ++d) {
    const int dg = d_offset + d;
    const int x0 = reverse ? xs + dg : xs - dg;
    float v = 0.0f;
    if (dg < max_d && x0 >= 0 && x0 < wt)
      v = fmaxf(dot(sp, trow + (size_t)x0 * c, c), 0.0f);
    o[d * d_stride] = v;
  }
}

}  // namespace

// K2: out is (n, d0, h0, w0).
extern "C" int dm_costvol_dmajor(const float* src, const float* tgt,
                                 float* out, int n, int h0, int w0, int wt,
                                 int c, int d0, int p, int max_d, int reverse,
                                 int origin_offset, void* stream) {
  const dim3 grid((w0 + kThreads - 1) / kThreads, h0, n);
  costvol_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, tgt, out, h0, w0, wt, c, d0, p, max_d, reverse, origin_offset, 0);
  return (int)cudaGetLastError();
}

// K6: out is (n, h0, d0, w0), global bins [d_offset, d_offset + d0).
extern "C" int dm_costvol_rows(const float* src, const float* tgt, float* out,
                               int n, int h0, int w0, int wt, int c, int d0,
                               int p, int max_d, int reverse,
                               int origin_offset, int d_offset, void* stream) {
  const long long blocks = (long long)((w0 + kThreads - 1) / kThreads) *
                           ((d0 + kRowsChunk - 1) / kRowsChunk) * n * h0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  costvol_kernel<true><<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      src, tgt, out, h0, w0, wt, c, d0, p, max_d, reverse, origin_offset,
      d_offset);
  return (int)cudaGetLastError();
}
