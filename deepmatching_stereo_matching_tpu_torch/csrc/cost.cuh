// Level-0 correlation costs of one tile of patches, from padded image
// pixels staged in shared memory: K4's cost block (costrows.cu), patch
// descriptors.  K1 (fused.cu) restates this arithmetic on purpose, in
// registers and with explicit roundings, and K4's volume is its bitwise
// witness; fused.cu takes only kEps from here.
//
// Numerics, in the order of the TPU kernels' shared cost block
// (deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_cost_block;
// algebraic normalisation, so costs differ from the normalise-then-dot
// oracle by rounding only):
//   invL = 1 / max(sqrt(sum L^2), 1e-8) per patch (pixel-row sums first);
//   invR = 1 / max(sqrt(sum R^2), 1e-8) per window start x0 (column sums
//          over the patch rows first);
//   cost = relu(raw * invL * invR) where p*j >= d and d < max_d, else 0;
//   raw sums each pixel row over its columns first, then over the rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dm {

constexpr float kEps = 1e-8f;

// A tile of th x tw patches of one instance.  Shared-memory buffers:
//   lt (p*th, lw) left pixels, lw = p*tw;
//   rt (p*th, rw) right pixels from image column p*x0 - (max_d - 1), the
//      columns the tile's targets reach, rw = lw + max_d - 1;
//   invr (th, nwin) per window start w of each patch row, nwin = rw-p+1;
//   invl (th, tw) per patch.
struct CostTile {
  int p, th, tw, max_d, lw, rw, nwin;
  float *lt, *rt, *invr, *invl;
};

__host__ __device__ inline CostTile cost_tile(int p, int th, int tw,
                                              int max_d) {
  CostTile c{};
  c.p = p;
  c.th = th;
  c.tw = tw;
  c.max_d = max_d;
  c.lw = p * tw;
  c.rw = c.lw + max_d - 1;
  c.nwin = c.rw - p + 1;
  return c;
}

// Floats of shared memory the tile's buffers take.
__host__ __device__ inline int cost_tile_floats(const CostTile& c) {
  return c.p * c.th * (c.lw + c.rw) + c.th * c.nwin + c.th * c.tw;
}

// Lays the buffers out from `buf` (cost_tile_floats of shared memory).
__device__ inline void carve(CostTile& c, float* buf) {
  const int rows = c.p * c.th;
  c.lt = buf;
  c.rt = c.lt + rows * c.lw;
  c.invr = c.rt + rows * c.rw;
  c.invl = c.invr + c.th * c.nwin;
}

// Stages the tile at patch origin (y0, x0) of one instance's (hp, wp)
// planes and computes its norms.  Pixels
// outside the image read as 0; they feed only costs that are masked or
// lie outside the (h0, w0) grid.  Ends with every thread past a barrier.
__device__ inline void stage_tile(CostTile& c, const float* left,
                                  const float* right, int hp, int wp, int y0,
                                  int x0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p = c.p, rows = p * c.th;
  const int ly = p * y0, lx = p * x0, rx = lx - (c.max_d - 1);
  for (int e = tid; e < rows * c.lw; e += nt) {
    const int y = e / c.lw, x = e - y * c.lw;
    const int gy = ly + y, gx = lx + x;
    const bool ok = gy < hp && gx < wp;
    const size_t g = (size_t)gy * wp + gx;
    c.lt[e] = ok ? left[g] : 0.0f;
  }
  for (int e = tid; e < rows * c.rw; e += nt) {
    const int y = e / c.rw, x = e - y * c.rw;
    const int gy = ly + y, gx = rx + x;
    const bool ok = gy < hp && gx >= 0 && gx < wp;
    const size_t g = (size_t)gy * wp + gx;
    c.rt[e] = ok ? right[g] : 0.0f;
  }
  __syncthreads();

  for (int e = tid; e < c.th * c.tw; e += nt) {
    const int i = e / c.tw, j = e - i * c.tw;
    float m2 = 0.0f;
    for (int dr = 0; dr < p; ++dr) {
      const float* row = c.lt + (p * i + dr) * c.lw + p * j;
      float s = row[0] * row[0];
      for (int dc = 1; dc < p; ++dc) s += row[dc] * row[dc];
      m2 = dr == 0 ? s : m2 + s;
    }
    c.invl[e] = 1.0f / fmaxf(sqrtf(m2), kEps);
  }
  for (int e = tid; e < c.th * c.nwin; e += nt) {
    const int i = e / c.nwin, w = e - i * c.nwin;
    float win = 0.0f;
    for (int dc = 0; dc < p; ++dc) {
      float col = 0.0f;
      for (int dr = 0; dr < p; ++dr) {
        const float v = c.rt[(p * i + dr) * c.rw + w + dc];
        col = dr == 0 ? v * v : col + v * v;
      }
      win = dc == 0 ? col : win + col;
    }
    c.invr[e] = 1.0f / fmaxf(sqrtf(win), kEps);
  }
  __syncthreads();
}

// Cost of tile patch (i, j), global patch column jg, at disparity d;
// il = invl of the patch.
__device__ inline float patch_cost(const CostTile& c, int i, int j, int jg,
                                   int d, float il) {
  const int p = c.p;
  if (d >= c.max_d || p * jg < d) return 0.0f;
  // Target start x0 = p*jg - d is right-strip column p*j + max_d - 1 - d.
  const int w = p * j + (c.max_d - 1) - d;
  float raw = 0.0f;
  for (int dr = 0; dr < p; ++dr) {
    const int l = (p * i + dr) * c.lw + p * j;
    const int r = (p * i + dr) * c.rw + w;
    float s = c.lt[l] * c.rt[r];
    for (int dc = 1; dc < p; ++dc) s += c.lt[l + dc] * c.rt[r + dc];
    raw = dr == 0 ? s : raw + s;
  }
  return fmaxf(raw * il * c.invr[i * c.nwin + w], 0.0f);
}

}  // namespace dm
