// K1: padded image rows -> patch disparities and scores, in one kernel;
// K1b: the same kernel on grad_hist (magnitude, bin) plane pairs.
//
// Replaces deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_kernel
// (via _match_rows / match_rows) in both its forms: the patch form, and
// magbin=True, where the fused kernel takes each image as an L1
// gradient-magnitude plane and an orientation-bin plane and the one-hot
// descriptor dot becomes sum mag_L * mag_R * [bin_L == bin_R].  The form
// is a template flag (MAGBIN); the cost code is cost.cuh, shared with K4.
// Both forms are _cost_block followed by pyramid_body(fast=True).
// In: (n, Hp, Wp) f32 left and right images (+ the two bin planes in
// magbin form).  Out: (n, H0, W0) int32 disparity bins and f32 level-0
// scores.
//
// One block per (instance, 2^L x 2^L-patch tile); an instance is one
// pair-direction, so a whole batch in both directions is one launch.  The
// block stages its p*T x p*T left pixels and the p*T x (p*T + max_d - 1)
// right pixels its targets can reach, computes the tile's (D0, T, T)
// cost volume into shared memory, and runs the fast pyramid on it
// (pyramid.cuh).  Only the images are read and the (T, T) results
// written: no descriptor, cost volume or pyramid level touches device
// memory.
//
// Bound on this card by shared memory: ~120 KB per block at the bench
// geometry (D0 = 64, T = 16, p = 4; ~168 KB with the bin planes) allows
// one block per SM, and the correlation reads two pixels from shared
// memory per multiply-add.  The design aliases the pyramid's scratch
// over the image buffers to keep the block at one tile's volume plus its
// images; register tiling, overlapping loads with compute and several
// blocks per SM are left for later work.

#include "cost.cuh"
#include "pyramid.cuh"

namespace {

struct FusedLayout {
  dm::CostTile tile;
  int t;
  int scratch_floats;  // cost tile buffers, or pyramid scratch
};

__host__ __device__ inline FusedLayout fused_layout(int p, int d0, int max_d,
                                                    int levels, bool magbin) {
  FusedLayout f;
  f.t = 1 << levels;
  f.tile = dm::cost_tile(p, f.t, f.t, max_d);
  const int images = dm::cost_tile_floats(f.tile, magbin);
  const int pyr = dm::pyramid_scratch_bytes(d0, f.t, levels) / 4;
  f.scratch_floats = ((images > pyr ? images : pyr) + 3) & ~3;
  return f;
}

}  // namespace

// Shared memory of one block: the tile's level-0 volume and the scratch
// (mirrored by ops/fused_cuda.py:smem_bytes, which routes on it).
extern "C" int dm_fused_smem(int p, int d0, int max_d, int levels,
                             int magbin) {
  const FusedLayout f = fused_layout(p, d0, max_d, levels, magbin != 0);
  return 4 * (d0 * f.t * f.t + f.scratch_floats);
}

namespace {

template <bool MAGBIN>
__global__ void __launch_bounds__(dm::kThreads)
fused_kernel(const float* __restrict__ left, const float* __restrict__ right,
             const float* __restrict__ lbin, const float* __restrict__ rbin,
             int32_t* __restrict__ disp, float* __restrict__ score, int hp,
             int wp, int p, int d0, int max_d, int levels, float lam) {
  extern __shared__ float4 smem4[];
  FusedLayout f = fused_layout(p, d0, max_d, levels, MAGBIN);
  dm::CostTile& c = f.tile;
  const int t = f.t;
  const int h0 = hp / p, w0 = wp / p;
  const int tiles_w = w0 / t;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * t, x0 = tx * t;  // tile origin in patches

  float* cost0 = reinterpret_cast<float*>(smem4);
  float* scratch = cost0 + d0 * t * t;
  dm::carve(c, scratch, MAGBIN);
  const size_t img = (size_t)n * hp * wp;
  dm::stage_tile<MAGBIN>(c, left + img, right + img,
                         MAGBIN ? lbin + img : nullptr,
                         MAGBIN ? rbin + img : nullptr, hp, wp, y0, x0);

  for (int e = threadIdx.x; e < t * t; e += blockDim.x) {
    const int i = e / t, j = e - i * t;
    const float il = c.invl[e];
    for (int d = 0; d < d0; ++d)
      cost0[d * t * t + e] = dm::patch_cost<MAGBIN>(c, i, j, x0 + j, d, il);
  }
  __syncthreads();

  dm::pyramid_tile<true>(cost0, scratch, d0, t, levels, lam,
                         disp + (size_t)n * h0 * w0,
                         score + (size_t)n * h0 * w0, w0, y0, x0);
}

template <bool MAGBIN>
int launch(const float* left, const float* right, const float* lbin,
           const float* rbin, int32_t* disp, float* score, int n, int hp,
           int wp, int p, int d0, int max_d, int levels, float lam,
           cudaStream_t stream) {
  const FusedLayout f = fused_layout(p, d0, max_d, levels, MAGBIN);
  const int smem = dm_fused_smem(p, d0, max_d, levels, MAGBIN);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<MAGBIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int h0 = hp / p, w0 = wp / p;
  const dim3 grid((h0 / f.t) * (w0 / f.t), n);
  fused_kernel<MAGBIN><<<grid, dm::kThreads, smem, stream>>>(
      left, right, lbin, rbin, disp, score, hp, wp, p, d0, max_d, levels,
      lam);
  return (int)cudaGetLastError();
}

}  // namespace

// lbin/rbin null: patch form (K1); else magbin form (K1b), left/right
// being the magnitude planes.
extern "C" int dm_fused_match(const float* left, const float* right,
                              const float* lbin, const float* rbin,
                              int32_t* disp, float* score, int n, int hp,
                              int wp, int p, int d0, int max_d, int levels,
                              float lam, void* stream) {
  if (lbin != nullptr)
    return launch<true>(left, right, lbin, rbin, disp, score, n, hp, wp, p,
                        d0, max_d, levels, lam, (cudaStream_t)stream);
  return launch<false>(left, right, nullptr, nullptr, disp, score, n, hp, wp,
                       p, d0, max_d, levels, lam, (cudaStream_t)stream);
}
