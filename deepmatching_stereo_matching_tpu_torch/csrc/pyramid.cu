// K3: pyramid + dense backtracking on a D-major cost volume.
//
// Replaces deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:_kernel
// (pyramid_body(fast=False) via _pyramid_backtrack / pyramid_backtrack).
// In: (n, D0, H0, W0) f32.  Out: (n, H0, W0) int32 disparity bins and
// f32 level-0 scores.  Exact mode: powf after every merge, so decisions
// equal the oracle's up to powf's own rounding.
//
// One block per (instance, 2^L x 2^L-patch tile).  The block copies its
// (D0, T, T) tile into shared memory and runs the shrinking pyramid there
// (pyramid.cuh); nothing but the volume read and the two (T, T) output
// tiles touches device memory.  Bound on this card by the volume read
// (4 bytes per cost element, ~12 flops each) and by the block's shared
// memory (84 KB at D0 = 64, T = 16), which allows two blocks per SM;
// the design keeps every level's map and offsets on chip.

#include "pyramid.cuh"

namespace {

__global__ void __launch_bounds__(dm::kThreads)
pyramid_kernel(const float* __restrict__ cost, int32_t* __restrict__ disp,
               float* __restrict__ score, int d0, int h0, int w0, int levels,
               float lam) {
  extern __shared__ float4 smem4[];
  float* cost0 = reinterpret_cast<float*>(smem4);
  const int t = 1 << levels;
  const int tiles_w = w0 / t;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * t, x0 = tx * t;
  const float* src = cost + (size_t)n * d0 * h0 * w0;
  for (int e = threadIdx.x; e < d0 * t * t; e += blockDim.x) {
    const int d = e / (t * t), r = e - d * t * t;
    const int y = r / t, x = r - y * t;
    cost0[e] = src[((size_t)d * h0 + y0 + y) * w0 + x0 + x];
  }
  __syncthreads();
  dm::pyramid_tile(cost0, cost0 + d0 * t * t, d0, t, levels, lam,
                   disp + (size_t)n * h0 * w0, score + (size_t)n * h0 * w0,
                   w0, y0, x0);
}

}  // namespace

extern "C" int dm_pyramid_backtrack(const float* cost, int32_t* disp,
                                    float* score, int n, int d0, int h0,
                                    int w0, int levels, float lam,
                                    void* stream) {
  const int t = 1 << levels;
  const int smem = 4 * d0 * t * t + dm::pyramid_scratch_bytes(d0, t, levels);
  cudaError_t err = cudaFuncSetAttribute(
      pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h0 / t) * (w0 / t), n);
  pyramid_kernel<<<grid, dm::kThreads, smem, (cudaStream_t)stream>>>(
      cost, disp, score, d0, h0, w0, levels, lam);
  return (int)cudaGetLastError();
}

extern "C" const char* dm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
