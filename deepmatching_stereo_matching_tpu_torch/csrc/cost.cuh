// The level-0 cost block that K1/K1b (fused.cu) and K4 (costrows.cu) both
// compile: image rows staged in shared memory, their norms, and the
// correlation costs read from them.  One implementation, so K4's volume
// is bitwise the costs K1 pools (chip_smoke.py holds K1's scores to it).
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
// A pixel row's sum starts with a*b and takes each further product with
// one rounding (FMA) in patch form; in magbin form a product counts where
// the bins agree, and is rounded before it is added.  Row sums and norms
// add in order; only K4's window norms at p >= 5 round one square more
// (column_term).  Written with explicit intrinsics, since an unrolled loop
// of `s += a * b` lets the compiler contract and reorder the sums
// otherwise (it did, at p = 4).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dm {

constexpr float kEps = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The staged tile as the cost code reads it: t patch rows of p pixel rows
// each.  lt: the left pixels from the tile's first column (stride ls);
// rt: the right strip from image column p*x0 - lead, lead >= max_d - 1
// (stride rs); invr: the right-window norms per patch row (stride is);
// lb/rb: the bin planes as bytes (magbin form, strides lsb/rsb).
struct Tile {
  const float *lt, *rt, *invr;
  const uint8_t *lb, *rb;
  int p, t, ls, rs, is, lsb, rsb, lead, max_d;
};

// Four pixels from image column gx of row gy of an (hp, wp) plane: one
// 16-byte load where they lie inside the image on a 16-byte boundary;
// pixels outside the image read as 0.
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int hp,
                                        int wp, int gy, int gx) {
  const size_t row = (size_t)gy * wp;
  if (gy < hp && gx >= 0 && gx + 3 < wp &&
      (reinterpret_cast<uintptr_t>(src + row + gx) & 15) == 0)
    return *reinterpret_cast<const float4*>(src + row + gx);
  float e[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int x = gx + u;
    e[u] = gy < hp && x >= 0 && x < wp ? src[row + x] : 0.0f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// Copies `width` columns from image column gx0 of `nrows` rows from row
// gy0 of an (hp, wp) plane into shared rows `stride` elements apart, as
// floats or (bins) bytes.  A warp takes whole rows, each lane chunks of
// four columns.  Floats go by 16-byte cp.async where load4 would take one
// load (the caller waits with cp.async.wait_all), so that all of a
// block's copies are in flight together; bytes, which are converted on
// the way, by kBatch rows of loads before any store.
template <typename Out>
__device__ void stage_rows(Out* dst, int stride, const float* __restrict__ src,
                           int hp, int wp, int gy0, int gx0, int nrows,
                           int width) {
  constexpr int kBatch = 8;
  const int chunks = (width + 3) >> 2;
  int lpr = 32;  // lanes per row: a power of two, at least `chunks`
  while (lpr > 1 && lpr / 2 >= chunks) lpr >>= 1;
  const int lane = threadIdx.x & 31;
  const int step = (blockDim.x >> 5) * (32 / lpr);  // rows per pass
  const int first = (threadIdx.x >> 5) * (32 / lpr) + lane / lpr;
  if constexpr (sizeof(Out) == 4) {
    for (int y = first; y < nrows; y += step) {
      const int gy = gy0 + y;
      const size_t row = (size_t)gy * wp;
      for (int c = lane & (lpr - 1); c < chunks; c += lpr) {
        const int gx = gx0 + 4 * c;
        Out* d = dst + y * stride + 4 * c;
        if (gy < hp && gx >= 0 && gx + 3 < wp &&
            (reinterpret_cast<uintptr_t>(src + row + gx) & 15) == 0) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           (unsigned)__cvta_generic_to_shared(d)),
                       "l"(src + row + gx));
        } else {
          *reinterpret_cast<float4*>(d) = load4(src, hp, wp, gy, gx);
        }
      }
    }
  } else {
    for (int y0 = first; y0 < nrows; y0 += kBatch * step) {
      for (int c = lane & (lpr - 1); c < chunks; c += lpr) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (y0 + b * step < nrows)
            v[b] = load4(src, hp, wp, gy0 + y0 + b * step, gx0 + 4 * c);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int y = y0 + b * step;
          if (y >= nrows) break;
          *reinterpret_cast<uint32_t*>(dst + y * stride + 4 * c) =
              (uint32_t)v[b].x | (uint32_t)v[b].y << 8 |
              (uint32_t)v[b].z << 16 | (uint32_t)v[b].w << 24;
        }
      }
    }
  }
}

template <bool MAGBIN>
__device__ __forceinline__ float first_term(float a, float b, bool same) {
  const float prod = __fmul_rn(a, b);
  return MAGBIN && !same ? 0.0f : prod;
}

template <bool MAGBIN>
__device__ __forceinline__ float add_term(float s, float a, float b,
                                          bool same) {
  if (MAGBIN) return __fadd_rn(s, same ? __fmul_rn(a, b) : 0.0f);
  return __fmaf_rn(a, b, s);
}

__device__ __forceinline__ float inv_norm(float sq) {
  return __fdiv_rn(1.0f, fmaxf(__fsqrt_rn(sq), kEps));
}

// relu(raw * invL * invR).
__device__ __forceinline__ float scaled(float raw, float il, float ir) {
  return fmaxf(__fmul_rn(__fmul_rn(raw, il), ir), 0.0f);
}

// A column's sum of squares over pixel rows 0..dr: v*v at row 0, then one
// FMA per row.  With ROW4 the square of pixel row 4 is rounded before it
// is added: K4's rounding at p >= 5, which its volume keeps from the
// rolled loop it compiled before it shared this code.
template <bool ROW4>
__device__ __forceinline__ float column_term(float col, float v, int dr) {
  return dr == 0             ? __fmul_rn(v, v)
         : ROW4 && dr == 4   ? __fadd_rn(col, __fmul_rn(v, v))
                             : __fmaf_rn(v, v, col);
}

// invr[i][w] = 1 / max(|window|, eps) for every window start w of the
// right strip (`right` columns): per column the sum of squares over the p
// pixel rows (column_term), then the sum of the p columns.  A lane sums
// one column; its window takes the next p - 1 lanes' columns by shuffles,
// so a warp covers 33 - p windows per pass.
template <bool ROW4 = false>
__device__ inline void window_norms(const Tile& s, float* invr, int right) {
  const int p = s.p, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int nwin = right - p + 1;
  for (int i = threadIdx.x >> 5; i < s.t; i += nw) {
    const float* rows = s.rt + p * i * s.rs;
    if (p > 32) {  // too wide for one warp's shuffles
      for (int w = lane; w < nwin; w += 32) {
        float win = 0.0f;
        for (int dc = 0; dc < p; ++dc) {
          float col = 0.0f;
          for (int dr = 0; dr < p; ++dr)
            col = column_term<ROW4>(col, rows[dr * s.rs + w + dc], dr);
          win = dc == 0 ? col : __fadd_rn(win, col);
        }
        invr[i * s.is + w] = inv_norm(win);
      }
      continue;
    }
    const int step = 33 - p;
    for (int w0 = 0; w0 < nwin; w0 += step) {
      const int c = w0 + lane;
      float col = 0.0f;
      if (c < right) {
        for (int dr = 0; dr < p; ++dr)
          col = column_term<ROW4>(col, rows[dr * s.rs + c], dr);
      }
      float win = col;
      for (int dc = 1; dc < p; ++dc)
        win = __fadd_rn(win, __shfl_down_sync(kFull, col, dc));
      if (lane < step && c < nwin) invr[i * s.is + c] = inv_norm(win);
    }
  }
}

// 1 / max(|left patch (i, j)|, eps).
template <int P>
__device__ float left_inv_norm(const Tile& s, int i, int j) {
  const int p = P > 0 ? P : s.p;
  float m2 = 0.0f;
#pragma unroll
  for (int dr = 0; dr < p; ++dr) {
    const float* row = s.lt + (p * i + dr) * s.ls + p * j;
    float v = __fmul_rn(row[0], row[0]);
#pragma unroll
    for (int dc = 1; dc < p; ++dc) v = __fmaf_rn(row[dc], row[dc], v);
    m2 = dr == 0 ? v : __fadd_rn(m2, v);
  }
  return inv_norm(m2);
}

// Cost of tile patch (i, j), global patch column jg, at disparity d, read
// from the staged tile.
template <int P, bool MAGBIN>
__device__ float cell_cost(const Tile& s, int i, int j, int jg, int d,
                           float il) {
  const int p = P > 0 ? P : s.p;
  if (d >= s.max_d || p * jg < d) return 0.0f;
  const int w = p * j + s.lead - d;  // strip column of target start p*jg - d
  float raw = 0.0f;
#pragma unroll
  for (int dr = 0; dr < p; ++dr) {
    const int row = p * i + dr;
    const float* l = s.lt + row * s.ls + p * j;
    const float* r = s.rt + row * s.rs + w;
    const uint8_t* lb = MAGBIN ? s.lb + row * s.lsb + p * j : nullptr;
    const uint8_t* rb = MAGBIN ? s.rb + row * s.rsb + w : nullptr;
    float v = first_term<MAGBIN>(l[0], r[0], MAGBIN && lb[0] == rb[0]);
#pragma unroll
    for (int dc = 1; dc < p; ++dc)
      v = add_term<MAGBIN>(v, l[dc], r[dc], MAGBIN && lb[dc] == rb[dc]);
    raw = dr == 0 ? v : __fadd_rn(raw, v);
  }
  return scaled(raw, il, s.invr[i * s.is + w]);
}

// p = 4: the costs of d4..d4+3 (d4 a multiple of 4) of patch (i, j) from
// its left pixels L / bins lbw in registers and the right window slid
// through two aligned float4 per pixel row.  ivc carries the norm of the
// window at d4 in and that at d4 + 4 out.
template <bool MAGBIN>
__device__ __forceinline__ void costs4(const Tile& s, const float (&L)[4][4],
                                       const uint32_t (&lbw)[4], int i, int j,
                                       int jg, int d4, float il, float& ivc,
                                       float (&c)[4]) {
  if (d4 >= s.max_d) {
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = 0.0f;
    return;
  }
  const bool prev = d4 + 1 < s.max_d;  // a cost of d4+1..d4+3 counts
  const int col = 4 * j + s.lead - d4;  // window start at d4: aligned
  float raw[4];
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
    const int row = 4 * i + dr;
    const float* rr = s.rt + row * s.rs + col;
    const float4 cu = *reinterpret_cast<const float4*>(rr);
    const float4 pv = prev ? *reinterpret_cast<const float4*>(rr - 4)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float w8[8] = {pv.x, pv.y, pv.z, pv.w, cu.x, cu.y, cu.z, cu.w};
    uint32_t bcu = 0, bpv = 0;
    if (MAGBIN) {
      const uint8_t* rb = s.rb + row * s.rsb + col;
      bcu = *reinterpret_cast<const uint32_t*>(rb);
      bpv = prev ? *reinterpret_cast<const uint32_t*>(rb - 4) : 0u;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // Window at d4 + r: bytes / floats 4 - r .. 7 - r of (prev, cur).
      const uint32_t diff =
          MAGBIN ? lbw[dr] ^ __byte_perm(bpv, bcu, 0x7654 - 0x1111 * r) : 0u;
      float v = first_term<MAGBIN>(L[dr][0], w8[4 - r], (diff & 0xffu) == 0);
#pragma unroll
      for (int dc = 1; dc < 4; ++dc)
        v = add_term<MAGBIN>(v, L[dr][dc], w8[4 - r + dc],
                             ((diff >> (8 * dc)) & 0xffu) == 0);
      raw[r] = dr == 0 ? v : __fadd_rn(raw[r], v);
    }
  }
  const float4 ip =
      prev ? *reinterpret_cast<const float4*>(s.invr + i * s.is + col - 4)
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float iv[4] = {ivc, ip.w, ip.z, ip.y};
  ivc = ip.x;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d = d4 + r;
    c[r] = d < s.max_d && 4 * jg >= d ? scaled(raw[r], il, iv[r]) : 0.0f;
  }
}

}  // namespace dm
