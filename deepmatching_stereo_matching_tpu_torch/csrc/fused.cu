// K1: padded image rows -> patch disparities and scores, in one kernel;
// K1b: the same kernel on grad_hist (magnitude, bin) plane pairs.
//
// Replaces deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_kernel
// (via _match_rows / match_rows) in both its forms: the patch form, and
// magbin=True, where the fused kernel takes each image as an L1
// gradient-magnitude plane and an orientation-bin plane and the one-hot
// descriptor dot becomes sum mag_L * mag_R * [bin_L == bin_R].  The form
// is a template flag (MAGBIN).  Both forms are _cost_block followed by
// pyramid_body(fast=True): the cost block of cost.cuh, which K4 compiles
// too (K4's volume is this kernel's bitwise witness), and pyramid.cuh
// from level 1.
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
//
// BF16 (Config.dtype='bfloat16'; K1's and K1b's bfloat16 instances): the
// planes and the cost arithmetic stay float32, and each cost is rounded to
// bfloat16 once, after the relu and the mask (fused_pallas.py:_cost_block's
// c.astype(dtype), in both forms), before it is pooled; the quad mean
// rounds after each add and after the * 0.25, pyramid_up<FAST, BF16>
// rounds every level's ops, the fast rectification is powf at lam as given
// (the wrapper passes the float32 1.4: JAX's fast form runs in float32),
// and the score is the recomputed cost rounded alike.  Levels stay floats
// holding bfloat16 values, so the layout, the shared memory and the blocks
// per SM are the float32 instance's; the float32 instances compile as
// before (every bfloat16 step sits under `if constexpr`).

#include "cost.cuh"
#include "launch.cuh"
#include "pyramid.cuh"

namespace {

using namespace dm;

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

// Level 0 of the tile, streamed over d per cell: writes invl, the level-1
// map lv1 ((D0/2, T/2, T/2)) and the packed level-0 offsets arg0.
template <int P, bool MAGBIN, bool BF16>
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
      if constexpr (BF16) {
#pragma unroll
        for (int r = 0; r < 4; ++r) c[r] = dm::round_bf16(c[r]);
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
        if constexpr (BF16) {
          float m = dm::round_bf16(
              __fadd_rn(pooled, __shfl_xor_sync(kFull, pooled, 1)));
          m = dm::round_bf16(__fadd_rn(m, __shfl_xor_sync(kFull, m, 2)));
          if (active && sub == 0)
            lv1[k * hs * hs + q] = dm::round_bf16(__fmul_rn(m, 0.25f));
        } else {
          float m = pooled + __shfl_xor_sync(kFull, pooled, 1);
          m = m + __shfl_xor_sync(kFull, m, 2);
          if (active && sub == 0) lv1[k * hs * hs + q] = m * 0.25f;
        }
        prevc = od;
      }
    }
  }
}

template <int P, bool MAGBIN, bool BF16>
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
  level0<P, MAGBIN, BF16>(s, invl, lv, arg0, d0, x0);
  __syncthreads();

  const int hs = t >> 1;
  const float* top = dm::pyramid_up<true, BF16>(lv, lv + f.kn * hs * hs, args,
                                                d0, t, 1, levels, lam);
  int32_t* dst = disp + (size_t)n * h0 * w0;
  float* sco = score + (size_t)n * h0 * w0;
  for (int cell = threadIdx.x; cell < t * t; cell += blockDim.x) {
    const int y = cell / t, x = cell - y * t;
    int k = dm::descend_cell(top, args, d0, t, 1, levels, y, x);
    const int code = (arg0[(k >> 2) * t * t + cell] >> (2 * (k & 3))) & 3;
    k = 2 * k + code - 1;
    const size_t o = (size_t)(y0 + y) * w0 + (x0 + x);
    dst[o] = k;
    if constexpr (BF16) {
      sco[o] = dm::round_bf16(
          cell_cost<P, MAGBIN>(s, y, x, x0 + x, k, invl[cell]));
    } else {
      sco[o] = cell_cost<P, MAGBIN>(s, y, x, x0 + x, k, invl[cell]);
    }
  }
}

template <int P, bool MAGBIN, bool BF16>
SmemAllowance& allowance() {
  static SmemAllowance a((const void*)fused_kernel<P, MAGBIN, BF16>);
  return a;
}

template <int P, bool MAGBIN, bool BF16>
int launch(const float* left, const float* right, const float* lbin,
           const float* rbin, int32_t* disp, float* score, int n, int hp,
           int wp, int p, int d0, int max_d, int levels, float lam,
           cudaStream_t stream) {
  const FusedLayout f = fused_layout(p, d0, max_d, levels, MAGBIN);
  const cudaError_t err = allowance<P, MAGBIN, BF16>().allow(f.total);
  if (err != cudaSuccess) return (int)err;
  const int h0 = hp / p, w0 = wp / p;
  const dim3 grid((h0 / f.t) * (w0 / f.t), n);
  fused_kernel<P, MAGBIN, BF16><<<grid, dm::kThreads, f.total, stream>>>(
      left, right, lbin, rbin, disp, score, hp, wp, p, d0, max_d, levels,
      lam);
  return (int)cudaGetLastError();
}

template <int P, bool MAGBIN, bool BF16>
int occupancy(int smem) {
  return blocks_per_sm(allowance<P, MAGBIN, BF16>(),
                       (const void*)fused_kernel<P, MAGBIN, BF16>,
                       dm::kThreads, smem);
}

}  // namespace

// lbin/rbin null: patch form (K1), else magbin form (K1b), left/right being
// the magnitude planes; bf16 != 0: the form's bfloat16 instance.
extern "C" int dm_fused_match(const float* left, const float* right,
                              const float* lbin, const float* rbin,
                              int32_t* disp, float* score, int n, int hp,
                              int wp, int p, int d0, int max_d, int levels,
                              float lam, int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (lbin != nullptr) {
    if (bf16) {
      return p == 4 ? launch<4, true, true>(left, right, lbin, rbin, disp,
                                            score, n, hp, wp, p, d0, max_d,
                                            levels, lam, st)
                    : launch<0, true, true>(left, right, lbin, rbin, disp,
                                            score, n, hp, wp, p, d0, max_d,
                                            levels, lam, st);
    }
    return p == 4 ? launch<4, true, false>(left, right, lbin, rbin, disp,
                                           score, n, hp, wp, p, d0, max_d,
                                           levels, lam, st)
                  : launch<0, true, false>(left, right, lbin, rbin, disp,
                                           score, n, hp, wp, p, d0, max_d,
                                           levels, lam, st);
  }
  if (bf16) {
    return p == 4 ? launch<4, false, true>(left, right, nullptr, nullptr,
                                           disp, score, n, hp, wp, p, d0,
                                           max_d, levels, lam, st)
                  : launch<0, false, true>(left, right, nullptr, nullptr,
                                           disp, score, n, hp, wp, p, d0,
                                           max_d, levels, lam, st);
  }
  return p == 4 ? launch<4, false, false>(left, right, nullptr, nullptr, disp,
                                          score, n, hp, wp, p, d0, max_d,
                                          levels, lam, st)
                : launch<0, false, false>(left, right, nullptr, nullptr, disp,
                                          score, n, hp, wp, p, d0, max_d,
                                          levels, lam, st);
}

// Blocks of the kernel that serves (p, magbin, bf16) one SM holds at this
// configuration's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// negative: a CUDA error.
extern "C" int dm_fused_blocks_per_sm(int p, int d0, int max_d, int levels,
                                      int magbin, int bf16) {
  const int smem = dm_fused_smem(p, d0, max_d, levels, magbin);
  if (magbin) {
    if (bf16) return p == 4 ? occupancy<4, true, true>(smem)
                            : occupancy<0, true, true>(smem);
    return p == 4 ? occupancy<4, true, false>(smem)
                  : occupancy<0, true, false>(smem);
  }
  if (bf16) return p == 4 ? occupancy<4, false, true>(smem)
                          : occupancy<0, false, true>(smem);
  return p == 4 ? occupancy<4, false, false>(smem)
                : occupancy<0, false, false>(smem);
}
