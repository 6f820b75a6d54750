// K1: padded image rows -> patch disparities and scores, in one kernel;
// K1b: the same kernel on grad_hist (magnitude, bin) plane pairs.
//
// Replaces deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_kernel
// (via _match_rows / match_rows) in both its forms: the patch form, and
// magbin=True, where the fused kernel takes each image as an L1
// gradient-magnitude plane and an orientation-bin plane and the one-hot
// descriptor dot becomes sum mag_L * mag_R * [bin_L == bin_R].  The form
// is a template flag (MAGBIN).  Both forms are _cost_block followed by
// pyramid_body(fast=True): the cost arithmetic of K4's cost.cuh, restated
// here in registers (K4's volume is this kernel's bitwise witness), and
// pyramid.cuh from level 1.
// In: (n, Hp, Wp) f32 left and right images (+ the two bin planes in
// magbin form, integers 0..7 as f32).  Out: (n, H0, W0) int32 disparity
// bins and f32 level-0 scores.
//
// One block of 256 threads per (instance, 2^L x 2^L-patch tile); an
// instance is one pair-direction, so a whole batch in both directions is
// one launch.  Per block:
//   1. Stage the tile's p*T x p*T left pixels and the right strip its
//      targets reach, from image column p*x0 - (max_d - 1) rounded down
//      to a multiple of 4 (the offset is `lead`), in chunks of four: one
//      16-byte cp.async where the chunk lies inside the image on a
//      16-byte boundary, each warp walking its own rows (no integer
//      division).  Bins are staged as bytes.  Right-window norms follow: column sums
//      of squares per lane, the p-column window sums across lanes by
//      shuffles, in cost.cuh's order.
//   2. Level 0, streamed: a thread owns one patch cell, the four cells of
//      a 2x2 quad in adjacent lanes.  It walks d = 0..D0-1 in steps of
//      four.  Its p x p left pixels sit in registers; per step it loads,
//      for each pixel row, the aligned float4 at the step's window start
//      and the one before it (2 x 16-byte loads per row per 4 d), and
//      slides the window through those eight registers: 16 products per
//      load at p = 4, against one product per two scalar loads before.
//      The costs c[d] never touch memory: each pair (2k, 2k+1) with the
//      c[2k-1] kept from the step before is pooled in registers (pad -1,
//      ties lo/even/odd), its offset packed two bits per bin, and the
//      quad's 4-child mean formed by two __shfl_xor_sync in
//      ((q00 + q01) + (q10 + q11)) * 0.25 order.  Only the level-1 map
//      and the packed level-0 offsets are written to shared memory.
//   3. Levels >= 1 and the top-down walk: pyramid.cuh from level 1.  The
//      score, cost0[k] in the shrinking pyramid, is recomputed at the
//      chosen k from the staged pixels with the same arithmetic, so it is
//      bitwise the cost the stream pooled.
// Only the images are read and the (T, T) results written.
//
// Bank conflicts: with the right rows at a stride of 4 mod 8 floats, the
// eight lanes of a quarter-warp (two quads: 2 rows x 4 cells) read 128
// distinct bytes per float4, so the window loads are conflict-free for
// T >= 16; likewise the norms' float4 (stride 16 mod 32) and the bin
// words (stride 4 mod 8 words).  The left pixels (once per cell) and the
// score recompute (once per cell) read with up to 4-way conflicts.
//
// What bounds it on this card: neither bytes (0.032 ms for the bench's
// 64 instances at 3.35 TB/s) nor the FMA pipe (~0.03 ms of products),
// but the instructions around the products and the phases' barriers.
// On an H100 SXM at 700 W the bench call takes ~0.22 ms:
// staging and norms ~26% of it, the level-0 stream ~55% (its loop
// carries index arithmetic, masks and the pooling around the 64 products
// of each step of four disparities), levels >= 1, the walk and the score
// ~19% (profile_steps.py --k1 on copies of this kernel that end every
// block after staging and after level 0).  The block keeps no level-0
// volume: 72,992 B of shared memory at the bench geometry (D0 = 64,
// T = 16, p = 4; 86,304 B with the bin planes), so three K1 blocks (two
// K1b) share an SM, and `__launch_bounds__` holds the registers to that
// count; the carve-out is set to the most shared memory.  Staging by
// cp.async keeps a block's copies in flight together without registers.
// p = 4 is a template instance; any other p runs the same kernel with a
// runtime p, whose correlation reads the staged pixels per cost.

#include <atomic>
#include <mutex>

#include "cost.cuh"  // kEps
#include "pyramid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of one block: offsets in bytes, strides in elements.
struct FusedLayout {
  int t, rows, lw, ls, right, rs, is, lsb, rsb, kn;
  int lt, rt, invr, invl, lb, rb, lv, arg0, args, total;
};

__host__ __device__ inline FusedLayout fused_layout(int p, int d0, int max_d,
                                                    int levels, bool magbin) {
  FusedLayout f;
  f.t = 1 << levels;
  f.rows = p * f.t;
  f.lw = p * f.t;
  f.ls = round_up(f.lw, 4);
  // The right strip starts 'lead' columns left of the tile: max_d - 1
  // rounded up to 4 where the tile origin p*x0 is a multiple of 4, else
  // between max_d - 1 and max_d + 2.
  const int lead = f.lw % 4 == 0 ? round_up(max_d - 1, 4) : max_d + 2;
  f.right = round_up(f.lw + lead, 4);
  f.rs = f.right | 4;                          // 4 mod 8
  f.is = ((f.right + 15) & ~31) + 16;          // 16 mod 32
  f.lsb = round_up(f.lw, 16);
  f.rsb = 4 * (round_up(f.right / 4, 4) | 4);  // 4 mod 8 words
  f.kn = d0 / 2;
  int o = 0;
  f.lt = o;
  o += 4 * f.rows * f.ls;
  f.rt = o;
  o += 4 * f.rows * f.rs;
  f.invr = o;
  o += 4 * f.t * f.is;
  f.invl = o;
  o += 4 * f.t * f.t;
  f.lb = f.rb = o;
  if (magbin) {
    o += f.rows * f.lsb;
    f.rb = o;
    o += f.rows * f.rsb;
  }
  f.lv = o;  // pyramid levels 1..levels
  o += 4 * dm::level_floats(d0, f.t, levels);
  f.arg0 = o;  // level-0 offsets, 2 bits each: (kn/4, T, T) bytes
  o += (f.kn + 3) / 4 * f.t * f.t;
  f.args = o;  // offsets of levels 1..levels-1, int8
  o += dm::arg_bytes(d0, f.t, levels) - f.kn * f.t * f.t;
  f.total = round_up(o, 16);
  return f;
}

}  // namespace

// Shared memory of one block (mirrored by ops/fused_cuda.py:smem_bytes,
// which routes on it).
extern "C" int dm_fused_smem(int p, int d0, int max_d, int levels,
                             int magbin) {
  return fused_layout(p, d0, max_d, levels, magbin != 0).total;
}

namespace {

// The staged tile as the cost code reads it.
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

// The arithmetic of cost.cuh as K4 compiles it (its volume is bitwise
// this): a pixel row's sum starts with a*b and takes each further product
// with one rounding (FMA) in patch form; in magbin form a product counts
// where the bins agree, and is rounded before it is added.  Row sums and
// norms add in order.  Written with explicit intrinsics, since an
// unrolled loop of `s += a * b` lets the compiler contract and reorder
// the sums otherwise (it did, at p = 4).
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
  return __fdiv_rn(1.0f, fmaxf(__fsqrt_rn(sq), dm::kEps));
}

// relu(raw * invL * invR).
__device__ __forceinline__ float scaled(float raw, float il, float ir) {
  return fmaxf(__fmul_rn(__fmul_rn(raw, il), ir), 0.0f);
}

// invr[i][w] = 1 / max(|window|, eps) for every window start w of the
// right strip, in cost.cuh:stage_tile's order: per column the sum of
// squares over the p pixel rows, then the sum of the p columns.  A lane
// sums one column; its window takes the next p - 1 lanes' columns by
// shuffles, so a warp covers 33 - p windows per pass.
__device__ void window_norms(const Tile& s, float* invr, int right) {
  const int p = s.p, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int nwin = right - p + 1;
  for (int i = threadIdx.x >> 5; i < s.t; i += nw) {
    const float* rows = s.rt + p * i * s.rs;
    if (p > 32) {  // too wide for one warp's shuffles
      for (int w = lane; w < nwin; w += 32) {
        float win = 0.0f;
        for (int dc = 0; dc < p; ++dc) {
          float col = 0.0f;
          for (int dr = 0; dr < p; ++dr) {
            const float v = rows[dr * s.rs + w + dc];
            col = dr == 0 ? __fmul_rn(v, v) : __fmaf_rn(v, v, col);
          }
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
        for (int dr = 0; dr < p; ++dr) {
          const float v = rows[dr * s.rs + c];
          col = dr == 0 ? __fmul_rn(v, v) : __fmaf_rn(v, v, col);
        }
      }
      float win = col;
      for (int dc = 1; dc < p; ++dc)
        win = __fadd_rn(win, __shfl_down_sync(kFull, col, dc));
      if (lane < step && c < nwin) invr[i * s.is + c] = inv_norm(win);
    }
  }
}

// 1 / max(|left patch (i, j)|, eps), as cost.cuh:stage_tile computes it.
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
// from the staged tile: cost.cuh:patch_cost on this layout.
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

// Level 0 of the tile, streamed over d per cell: writes invl, the level-1
// map lv1 ((D0/2, T/2, T/2)) and the packed level-0 offsets arg0.
template <int P, bool MAGBIN>
__device__ void level0(const Tile& s, float* invl, float* lv1, uint8_t* arg0,
                       int d0, int x0) {
  const int t = s.t, cells = t * t, hs = t >> 1, kn = d0 >> 1;
  for (int base = 0; base < cells; base += blockDim.x) {
    if (base + (int)(threadIdx.x & ~31u) >= cells) continue;  // whole warp idle
    const int e = base + threadIdx.x;
    const bool active = e < cells;
    const int ec = e & (cells - 1);  // idle lanes shadow a real cell
    const int q = ec >> 2, sub = ec & 3;
    const int I = q / hs, J = q - I * hs;
    const int i = 2 * I + (sub >> 1), j = 2 * J + (sub & 1), jg = x0 + j;
    const int cell = i * t + j;
    const float il = left_inv_norm<P>(s, i, j);
    if (active) invl[cell] = il;

    float L[4][4];
    uint32_t lbw[4] = {0u, 0u, 0u, 0u};
    float ivc = 0.0f;
    if constexpr (P == 4) {
#pragma unroll
      for (int dr = 0; dr < 4; ++dr) {
        const float4 v = *reinterpret_cast<const float4*>(
            s.lt + (4 * i + dr) * s.ls + 4 * j);
        L[dr][0] = v.x;
        L[dr][1] = v.y;
        L[dr][2] = v.z;
        L[dr][3] = v.w;
        if (MAGBIN)
          lbw[dr] = *reinterpret_cast<const uint32_t*>(
              s.lb + (4 * i + dr) * s.lsb + 4 * j);
      }
      ivc = s.invr[i * s.is + 4 * j + s.lead];
    }

    float prevc = -1.0f;  // c[2k - 1]; the pad below bin 0
    uint32_t pack = 0u;
    for (int d4 = 0; d4 < d0; d4 += 4) {
      float c[4];
      if constexpr (P == 4) {
        costs4<MAGBIN>(s, L, lbw, i, j, jg, d4, il, ivc, c);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          c[r] = cell_cost<P, MAGBIN>(s, i, j, jg, d4 + r, il);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = (d4 >> 1) + h;
        if (k >= kn) break;
        const float lo = prevc, ev = c[2 * h], od = c[2 * h + 1];
        const float pooled = fmaxf(fmaxf(lo, ev), od);
        const uint32_t code = pooled == lo ? 0u : (pooled == ev ? 1u : 2u);
        pack |= code << (2 * (k & 3));
        if ((k & 3) == 3 || k == kn - 1) {
          if (active) arg0[(k >> 2) * cells + cell] = (uint8_t)pack;
          pack = 0u;
        }
        float m = pooled + __shfl_xor_sync(kFull, pooled, 1);
        m = m + __shfl_xor_sync(kFull, m, 2);
        if (active && sub == 0) lv1[k * hs * hs + q] = m * 0.25f;
        prevc = od;
      }
    }
  }
}

template <int P, bool MAGBIN>
__global__ void __launch_bounds__(dm::kThreads, MAGBIN ? 2 : 3)
fused_kernel(const float* __restrict__ left, const float* __restrict__ right,
             const float* __restrict__ lbin, const float* __restrict__ rbin,
             int32_t* __restrict__ disp, float* __restrict__ score, int hp,
             int wp, int p_arg, int d0, int max_d, int levels, float lam) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int p = P > 0 ? P : p_arg;
  const FusedLayout f = fused_layout(p, d0, max_d, levels, MAGBIN);
  const int t = f.t;
  const int h0 = hp / p, w0 = wp / p;
  const int tiles_w = w0 / t;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * t, x0 = tx * t;  // tile origin in patches
  const int ly = p * y0, lx = p * x0;
  const int rx = lx - (max_d - 1), rx0 = rx - (rx & 3);

  float* lt = reinterpret_cast<float*>(sm + f.lt);
  float* rt = reinterpret_cast<float*>(sm + f.rt);
  float* invr = reinterpret_cast<float*>(sm + f.invr);
  float* invl = reinterpret_cast<float*>(sm + f.invl);
  uint8_t* lb = reinterpret_cast<uint8_t*>(sm + f.lb);
  uint8_t* rb = reinterpret_cast<uint8_t*>(sm + f.rb);
  float* lv = reinterpret_cast<float*>(sm + f.lv);
  uint8_t* arg0 = reinterpret_cast<uint8_t*>(sm + f.arg0);
  int8_t* args = reinterpret_cast<int8_t*>(sm + f.args);
  const Tile s{lt, rt, invr, lb, rb, p, t, f.ls, f.rs, f.is, f.lsb, f.rsb,
               lx - rx0, max_d};

  const size_t img = (size_t)n * hp * wp;
  stage_rows(lt, f.ls, left + img, hp, wp, ly, lx, f.rows, f.lw);
  stage_rows(rt, f.rs, right + img, hp, wp, ly, rx0, f.rows, f.right);
  if (MAGBIN) {
    stage_rows(lb, f.lsb, lbin + img, hp, wp, ly, lx, f.rows, f.lw);
    stage_rows(rb, f.rsb, rbin + img, hp, wp, ly, rx0, f.rows, f.right);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  window_norms(s, invr, f.right);
  __syncthreads();
  level0<P, MAGBIN>(s, invl, lv, arg0, d0, x0);
  __syncthreads();

  const int hs = t >> 1;
  const float* top = dm::pyramid_up<true>(lv, lv + f.kn * hs * hs, args, d0,
                                          t, 1, levels, lam);
  int32_t* dst = disp + (size_t)n * h0 * w0;
  float* sco = score + (size_t)n * h0 * w0;
  for (int cell = threadIdx.x; cell < t * t; cell += blockDim.x) {
    const int y = cell / t, x = cell - y * t;
    int k = dm::descend_cell(top, args, d0, t, 1, levels, y, x);
    const int code = (arg0[(k >> 2) * t * t + cell] >> (2 * (k & 3))) & 3;
    k = 2 * k + code - 1;
    const size_t o = (size_t)(y0 + y) * w0 + (x0 + x);
    dst[o] = k;
    sco[o] = cell_cost<P, MAGBIN>(s, y, x, x0 + x, k, invl[cell]);
  }
}

constexpr int kMaxDevices = 64;

// Lets the kernel take `smem` bytes of dynamic shared memory, with the
// carve-out at the most shared memory, on the current device.  The
// attributes are set once per device and again only for a larger `smem`,
// so a launch at a size already allowed makes no attribute call.
template <int P, bool MAGBIN>
int prepare(int smem) {
  static std::atomic<int> allowed[kMaxDevices];  // bytes; 0: nothing set
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::atomic<int>* done = dev < kMaxDevices ? &allowed[dev] : nullptr;
  if (done && smem <= done->load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const int had = done ? done->load(std::memory_order_relaxed) : 0;
  if (smem <= had) return 0;
  if (had == 0)
    err = cudaFuncSetAttribute(fused_kernel<P, MAGBIN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_kernel<P, MAGBIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess && done) done->store(smem, std::memory_order_release);
  return (int)err;
}

template <int P, bool MAGBIN>
int launch(const float* left, const float* right, const float* lbin,
           const float* rbin, int32_t* disp, float* score, int n, int hp,
           int wp, int p, int d0, int max_d, int levels, float lam,
           cudaStream_t stream) {
  const FusedLayout f = fused_layout(p, d0, max_d, levels, MAGBIN);
  const int err = prepare<P, MAGBIN>(f.total);
  if (err != 0) return err;
  const int h0 = hp / p, w0 = wp / p;
  const dim3 grid((h0 / f.t) * (w0 / f.t), n);
  fused_kernel<P, MAGBIN><<<grid, dm::kThreads, f.total, stream>>>(
      left, right, lbin, rbin, disp, score, hp, wp, p, d0, max_d, levels,
      lam);
  return (int)cudaGetLastError();
}

template <int P, bool MAGBIN>
int blocks_per_sm(int smem) {
  const int err = prepare<P, MAGBIN>(smem);
  if (err != 0) return -err;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_kernel<P, MAGBIN>, dm::kThreads, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace

// lbin/rbin null: patch form (K1); else magbin form (K1b), left/right
// being the magnitude planes.
extern "C" int dm_fused_match(const float* left, const float* right,
                              const float* lbin, const float* rbin,
                              int32_t* disp, float* score, int n, int hp,
                              int wp, int p, int d0, int max_d, int levels,
                              float lam, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (lbin != nullptr) {
    return p == 4 ? launch<4, true>(left, right, lbin, rbin, disp, score, n,
                                    hp, wp, p, d0, max_d, levels, lam, st)
                  : launch<0, true>(left, right, lbin, rbin, disp, score, n,
                                    hp, wp, p, d0, max_d, levels, lam, st);
  }
  return p == 4 ? launch<4, false>(left, right, nullptr, nullptr, disp, score,
                                   n, hp, wp, p, d0, max_d, levels, lam, st)
                : launch<0, false>(left, right, nullptr, nullptr, disp, score,
                                   n, hp, wp, p, d0, max_d, levels, lam, st);
}

// Blocks of the kernel that serves (p, magbin) one SM holds at this
// configuration's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// negative: a CUDA error.
extern "C" int dm_fused_blocks_per_sm(int p, int d0, int max_d, int levels,
                                      int magbin) {
  const int smem = dm_fused_smem(p, d0, max_d, levels, magbin);
  if (magbin) return p == 4 ? blocks_per_sm<4, true>(smem)
                            : blocks_per_sm<0, true>(smem);
  return p == 4 ? blocks_per_sm<4, false>(smem)
                : blocks_per_sm<0, false>(smem);
}
