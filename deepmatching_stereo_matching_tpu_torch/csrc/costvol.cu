// K2: level-0 correlation cost volume in the D-major layout.
//
// Replaces deepmatching_stereo_matching_tpu/ops/costvol_pallas.py:
// _kernel_dmajor (via _cost_volume_rows(dmajor=True) / cost_volume_dmajor).
// out[b, d, i, j] = relu(<src[b, i, j, :], tgt[b, i, x0, :]>), with
// x0 = p*(j + origin_offset) -+ d (minus forward, plus reverse); 0 where
// x0 falls outside [0, wt) or d >= max_d.
//
// One thread per (b, i, j), looping over d (the source descriptor is
// re-read from L1 for every d); consecutive threads write consecutive j
// of each d plane (coalesced stores).  The TPU kernel's phase decomposition of the target
// columns existed only to avoid strided lane gathers; here a thread reads
// its target descriptor directly.  Bound on this card by device memory:
// the volume write (4 B per output) and the target reads, which L1/L2
// serve (neighbouring j read overlapping target columns); 2*C flops per
// output is far below the compute roof.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
costvol_dmajor_kernel(const float* __restrict__ src,
                      const float* __restrict__ tgt, float* __restrict__ out,
                      int h0, int w0, int wt, int c, int d0, int p, int max_d,
                      int reverse, int origin_offset) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= w0) return;
  const float* sp = src + (((size_t)b * h0 + i) * w0 + j) * c;
  const float* trow = tgt + ((size_t)b * h0 + i) * wt * c;
  float* o = out + (size_t)b * d0 * h0 * w0 + (size_t)i * w0 + j;
  const size_t plane = (size_t)h0 * w0;
  const int xs = p * (j + origin_offset);
  for (int d = 0; d < d0; ++d) {
    const int x0 = reverse ? xs + d : xs - d;
    float v = 0.0f;
    if (d < max_d && x0 >= 0 && x0 < wt) {
      const float* tp = trow + (size_t)x0 * c;
      float acc = 0.0f;
      for (int k = 0; k < c; ++k) acc += sp[k] * tp[k];
      v = fmaxf(acc, 0.0f);
    }
    o[d * plane] = v;
  }
}

}  // namespace

extern "C" int dm_costvol_dmajor(const float* src, const float* tgt,
                                 float* out, int n, int h0, int w0, int wt,
                                 int c, int d0, int p, int max_d, int reverse,
                                 int origin_offset, void* stream) {
  const dim3 grid((w0 + kThreads - 1) / kThreads, h0, n);
  costvol_dmajor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, tgt, out, h0, w0, wt, c, d0, p, max_d, reverse, origin_offset);
  return (int)cudaGetLastError();
}
