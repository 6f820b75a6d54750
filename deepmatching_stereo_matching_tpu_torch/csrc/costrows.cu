// K4: padded image rows -> the D-major level-0 cost volume.
//
// Replaces deepmatching_stereo_matching_tpu/ops/fused_pallas.py:
// _cost_only_kernel (via _cost_volume_rows / cost_volume_rows): the cost
// block of cost.cuh (K1's numerics) with the volume written to device
// memory instead of a pyramid run on it, for volumes whose quadtree tile
// does not fit one block's shared memory (KITTI at D0 = 128 and 256).
// In: (n, Hp, Wp) f32 left and right images, patch form.  Out:
// (n, D0, H0, W0) f32.
//
// One block per (instance, kTh x kTw-patch tile).  The tile is fixed and
// does not depend on the pyramid depth: no merge happens here.  A block
// stages p*kTh rows of p*kTw left pixels and p*kTw + max_d - 1 right
// pixels (~77 KB at p = 4, max_d = 256, so two blocks fit an SM), then
// each thread owns one patch and walks d, and a warp's 32 threads store
// 32 consecutive j of one d plane: 128-byte coalesced stores.  Ragged
// edges are masked, so any (H0, W0) is covered.
//
// Bound on this card by the volume write (4 B per cost, ~0.09 ms for the
// 302 MB of 16 KITTI instances at D0 = 128 at 3.35 TB/s) and by the
// shared-memory reads of the correlation (two per multiply-add, with
// 4-way bank conflicts between neighbouring patches); keeping the left
// patch in registers and staging the strip with TMA are left for later.

#include "cost.cuh"

namespace {

constexpr int kTh = 8, kTw = 32;
constexpr int kThreads = kTh * kTw;  // one thread per tile patch

__global__ void __launch_bounds__(kThreads)
costrows_kernel(const float* __restrict__ left,
                const float* __restrict__ right, float* __restrict__ out,
                int hp, int wp, int p, int d0, int max_d) {
  extern __shared__ float4 smem4[];
  dm::CostTile c = dm::cost_tile(p, kTh, kTw, max_d);
  dm::carve(c, reinterpret_cast<float*>(smem4));
  const int h0 = hp / p, w0 = wp / p;
  const int tiles_w = (w0 + kTw - 1) / kTw;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * kTh, x0 = tx * kTw;
  const size_t img = (size_t)n * hp * wp;
  dm::stage_tile(c, left + img, right + img, hp, wp, y0, x0);

  const int e = threadIdx.x;
  const int i = e / kTw, j = e - i * kTw;
  if (y0 + i >= h0 || x0 + j >= w0) return;
  const size_t plane = (size_t)h0 * w0;
  float* o = out + (size_t)n * d0 * plane + (size_t)(y0 + i) * w0 + x0 + j;
  const float il = c.invl[e];
  for (int d = 0; d < d0; ++d)
    o[d * plane] = dm::patch_cost(c, i, j, x0 + j, d, il);
}

}  // namespace

// Shared memory of one block (mirrored by ops/fused_cuda.py:cost_smem_bytes,
// which routes on it).
extern "C" int dm_cost_rows_smem(int p, int max_d) {
  return 4 * dm::cost_tile_floats(dm::cost_tile(p, kTh, kTw, max_d));
}

extern "C" int dm_cost_rows(const float* left, const float* right,
                            float* out, int n, int hp, int wp, int p, int d0,
                            int max_d, void* stream) {
  const int smem = dm_cost_rows_smem(p, max_d);
  cudaError_t err = cudaFuncSetAttribute(
      costrows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int h0 = hp / p, w0 = wp / p;
  const dim3 grid(((h0 + kTh - 1) / kTh) * ((w0 + kTw - 1) / kTw), n);
  costrows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      left, right, out, hp, wp, p, d0, max_d);
  return (int)cudaGetLastError();
}
