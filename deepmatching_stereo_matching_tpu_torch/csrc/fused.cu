// K1: padded image rows -> patch disparities and scores, in one kernel.
//
// Replaces deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_kernel
// (patch form, via _match_rows / match_rows): _cost_block followed by
// pyramid_body(fast=True).  In: (n, Hp, Wp) f32 left and right images.
// Out: (n, H0, W0) int32 disparity bins and f32 level-0 scores.
//
// One block per (instance, 2^L x 2^L-patch tile); an instance is one
// pair-direction, so a whole batch in both directions is one launch.  The
// block loads its p*T x p*T left pixels and the p*T x (p*T + max_d - 1)
// right pixels its targets can reach, computes the tile's (D0, T, T)
// cost volume into shared memory, and runs the fast pyramid on it
// (pyramid.cuh).  Only the images are read and the (T, T) results written:
// no descriptor, cost volume or pyramid level touches device memory.
//
// Numerics, in the TPU kernel's order (algebraic normalisation, so scores
// differ from the normalise-then-dot oracle by rounding only):
//   invL = 1 / max(sqrt(sum L^2), 1e-8) per patch (pixel-row sums first);
//   invR = 1 / max(sqrt(sum R^2), 1e-8) per window start x0 (column sums
//          over the patch rows first);
//   cost = relu(raw * invL * invR) where p*j >= d and d < max_d, else 0.
//
// Bound on this card by shared memory: ~120 KB per block at the bench
// geometry (D0 = 64, T = 16, p = 4) allows one block per SM, and the
// correlation reads two pixels from shared memory per multiply-add.  The
// design aliases the pyramid's scratch over the image buffers to keep the
// block at one tile's volume plus its images; register tiling, overlapping
// loads with compute and several blocks per SM are left for later work.

#include "pyramid.cuh"

namespace {

struct FusedLayout {
  int t, pt, rw, nwin;
  int scratch_floats;  // image buffers, norms, or pyramid scratch
};

__host__ __device__ inline FusedLayout fused_layout(int p, int d0, int max_d,
                                                    int levels) {
  FusedLayout f;
  f.t = 1 << levels;
  f.pt = p * f.t;
  f.rw = f.pt + max_d - 1;  // right pixel columns a tile's targets reach
  f.nwin = f.rw - p + 1;    // window starts x0 within them
  const int images = f.pt * f.pt + f.pt * f.rw + f.t * f.nwin + f.t * f.t;
  const int pyr = dm::pyramid_scratch_bytes(d0, f.t, levels) / 4;
  f.scratch_floats = ((images > pyr ? images : pyr) + 3) & ~3;
  return f;
}

__global__ void __launch_bounds__(dm::kThreads)
fused_kernel(const float* __restrict__ left, const float* __restrict__ right,
             int32_t* __restrict__ disp, float* __restrict__ score, int hp,
             int wp, int p, int d0, int max_d, int levels, float lam) {
  extern __shared__ float4 smem4[];
  const FusedLayout f = fused_layout(p, d0, max_d, levels);
  const int t = f.t, pt = f.pt, rw = f.rw, nwin = f.nwin;
  const int h0 = hp / p, w0 = wp / p;
  const int tiles_w = w0 / t;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * t, x0 = tx * t;  // tile origin in patches
  const int xb = p * x0 - (max_d - 1);  // image column of right column 0
  const int live = d0 < max_d ? d0 : max_d;

  float* cost0 = reinterpret_cast<float*>(smem4);
  float* scratch = cost0 + d0 * t * t;
  float* lt = scratch;          // (pt, pt) left pixels
  float* rt = lt + pt * pt;     // (pt, rw) right pixels
  float* invr = rt + pt * rw;   // (t, nwin)
  float* invl = invr + t * nwin;  // (t, t)

  const float* lsrc = left + (size_t)n * hp * wp + (size_t)p * y0 * wp;
  const float* rsrc = right + (size_t)n * hp * wp + (size_t)p * y0 * wp;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < pt * pt; e += nt) {
    const int y = e / pt, x = e - y * pt;
    lt[e] = lsrc[(size_t)y * wp + p * x0 + x];
  }
  for (int e = tid; e < pt * rw; e += nt) {
    const int y = e / rw, x = e - y * rw;
    const int gx = xb + x;  // < wp always; < 0 only for masked targets
    rt[e] = gx >= 0 ? rsrc[(size_t)y * wp + gx] : 0.0f;
  }
  __syncthreads();

  for (int e = tid; e < t * t; e += nt) {
    const int i = e / t, j = e - i * t;
    float m2 = 0.0f;
    for (int dr = 0; dr < p; ++dr) {
      const float* row = lt + (p * i + dr) * pt + p * j;
      float s = row[0] * row[0];
      for (int dc = 1; dc < p; ++dc) s += row[dc] * row[dc];
      m2 = dr == 0 ? s : m2 + s;
    }
    invl[e] = 1.0f / fmaxf(sqrtf(m2), 1e-8f);
  }
  for (int e = tid; e < t * nwin; e += nt) {
    const int i = e / nwin, w = e - i * nwin;
    float win = 0.0f;
    for (int dc = 0; dc < p; ++dc) {
      float col = 0.0f;
      for (int dr = 0; dr < p; ++dr) {
        const float v = rt[(p * i + dr) * rw + w + dc];
        col = dr == 0 ? v * v : col + v * v;
      }
      win = dc == 0 ? col : win + col;
    }
    invr[e] = 1.0f / fmaxf(sqrtf(win), 1e-8f);
  }
  __syncthreads();

  for (int e = tid; e < t * t; e += nt) {
    const int i = e / t, j = e - i * t;
    const int jg = x0 + j;
    const float il = invl[e];
    for (int d = 0; d < d0; ++d) {
      float c = 0.0f;
      if (d < live && p * jg >= d) {
        // Target start x0 = p*jg - d is right column p*j + max_d - 1 - d.
        const int w = p * j + (max_d - 1) - d;
        float raw = 0.0f;
        for (int dr = 0; dr < p; ++dr) {
          const float* lrow = lt + (p * i + dr) * pt + p * j;
          const float* rrow = rt + (p * i + dr) * rw + w;
          float s = lrow[0] * rrow[0];
          for (int dc = 1; dc < p; ++dc) s += lrow[dc] * rrow[dc];
          raw = dr == 0 ? s : raw + s;
        }
        const float corr = raw * il * invr[i * nwin + w];
        c = fmaxf(corr, 0.0f);
      }
      cost0[d * t * t + e] = c;
    }
  }
  __syncthreads();

  dm::pyramid_tile<true>(cost0, scratch, d0, t, levels, lam,
                         disp + (size_t)n * h0 * w0,
                         score + (size_t)n * h0 * w0, w0, y0, x0);
}

}  // namespace

extern "C" int dm_fused_match(const float* left, const float* right,
                              int32_t* disp, float* score, int n, int hp,
                              int wp, int p, int d0, int max_d, int levels,
                              float lam, void* stream) {
  const FusedLayout f = fused_layout(p, d0, max_d, levels);
  const int smem = 4 * (d0 * f.t * f.t + f.scratch_floats);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int h0 = hp / p, w0 = wp / p;
  const dim3 grid((h0 / f.t) * (w0 / f.t), n);
  fused_kernel<<<grid, dm::kThreads, smem, (cudaStream_t)stream>>>(
      left, right, disp, score, hp, wp, p, d0, max_d, levels, lam);
  return (int)cudaGetLastError();
}
