// Device-side aggregation pyramid + dense backtracking on ONE quadtree
// tile held in shared memory, from level 1 up.  Shared by the pyramid
// kernel (K3, pyramid.cu, exact mode) and the fused image->disparity
// kernel (K1, fused.cu, fast mode): each pools level 0 in registers
// itself, streamed over d per cell, and calls pyramid_up from level 1 and
// descend_cell.
//
// Semantics of deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:
// pyramid_body, written as a SHRINKING pyramid (level l is
// (D0>>l) x (T>>l) x (T>>l)) instead of the TPU's duplicated-cell layout:
//   * 3-wide disparity max-pool + x2 subsample, pad -1.0 below bin 0,
//     ties lo, then even, then odd; the offset in {-1, 0, 1} is recorded;
//   * 4-child mean in ((q00 + q01) + (q10 + q11)) * 0.25 order;
//   * x^lam never by __powf or an exp2/log2 form: in exact mode
//     after every merge, correctly rounded (pow_rn: float32 maps); in
//     fast mode by powf, deferred to the pooled map of the next level and
//     skipped at the top (max commutes with the monotone power);
//   * first-max argmax at the top, then k = 2k + offset per level, and
//     score = cost0[k] (K3 reads it from the volume, K1 recomputes it
//     from its staged pixels).
// A tile of T = 2^levels patches holds whole quadtrees, so no merge
// crosses a tile and blocks need nothing from each other.
// BF16 (K1's bfloat16 instance): the maps stay floats, each holding a
// bfloat16 value: every add, the * 0.25 and every power round their
// result to bfloat16 (round_bf16), as torch and XLA do per op on bfloat16
// tensors; comparisons read the exact widenings.  lam is used as given
// (the caller passes the exponent JAX uses).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dm {

constexpr int kThreads = 256;

// x rounded to the nearest bfloat16 (ties to even), held as a float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x^lam correctly rounded: the power in double, rounded once to float
// (correct unless the exact power lies within double's error of a
// rounding boundary).  The exact mode's power on float32 maps.  powf errs
// by up to 2 ULP, and at a pool near-tie that flipped decisions away from
// the oracle's (np.power) on a KITTI-size pair (1226x370, D=128: 15
// patches) where this power keeps them.  The plain versions compute it
// alike (ops/pool.py:rectify).
__device__ __forceinline__ float pow_rn(float x, float lam) {
  return __double2float_rn(pow((double)x, (double)lam));
}

// ((q0 + q1) + (q2 + q3)) * 0.25 with every result rounded to bfloat16.
__device__ __forceinline__ float quad_mean_bf16(const float (&q)[4]) {
  const float a = round_bf16(__fadd_rn(q[0], q[1]));
  const float b = round_bf16(__fadd_rn(q[2], q[3]));
  return round_bf16(__fmul_rn(round_bf16(__fadd_rn(a, b)), 0.25f));
}

// Floats of pyramid levels 1..levels (level 0 is the cost tile itself).
__host__ __device__ inline int level_floats(int d0, int t, int levels) {
  int n = 0;
  for (int l = 1; l <= levels; ++l) n += (d0 >> l) * (t >> l) * (t >> l);
  return n;
}

// Bytes of the recorded pool offsets, levels 0..levels-1.
__host__ __device__ inline int arg_bytes(int d0, int t, int levels) {
  int n = 0;
  for (int l = 0; l < levels; ++l) n += (d0 >> (l + 1)) * (t >> l) * (t >> l);
  return n;
}

// Bottom-up from level `first` (map `cur`, (d0 >> first, t >> first,
// t >> first) in shared memory) to the top: each level's map goes to
// `out` and the next, its pool offsets to `arg` and on.  Returns the top
// map ((d0 >> levels) bins of one spatial cell).  Every level ends with
// a barrier.
template <bool FAST, bool BF16 = false>
__device__ const float* pyramid_up(const float* cur, float* out, int8_t* arg,
                                   int d0, int t, int first, int levels,
                                   float lam) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int l = first; l < levels; ++l) {
    const int sl = t >> l, hs = sl >> 1, kn = (d0 >> l) >> 1;
    const int plane = sl * sl, oplane = hs * hs;
    for (int e = tid; e < kn * oplane; e += nt) {
      const int k = e / oplane, rem = e - k * oplane;
      const int I = rem / hs, J = rem - I * hs;
      float q[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c = (2 * I + u) * sl + 2 * J + v;
          const float lo = k > 0 ? cur[(2 * k - 1) * plane + c] : -1.0f;
          const float ev = cur[(2 * k) * plane + c];
          const float od = cur[(2 * k + 1) * plane + c];
          float pooled = fmaxf(fmaxf(lo, ev), od);
          arg[k * plane + c] = pooled == lo ? -1 : (pooled == ev ? 0 : 1);
          if constexpr (BF16) {
            if (FAST && l > 0) pooled = round_bf16(powf(pooled, lam));
          } else {
            if (FAST && l > 0) pooled = powf(pooled, lam);
          }
          q[2 * u + v] = pooled;
        }
      }
      if constexpr (BF16) {
        const float m = quad_mean_bf16(q);
        out[k * oplane + rem] = FAST ? m : round_bf16(powf(m, lam));
      } else {
        const float m = ((q[0] + q[1]) + (q[2] + q[3])) * 0.25f;
        out[k * oplane + rem] = FAST ? m : pow_rn(m, lam);
      }
    }
    __syncthreads();
    arg += kn * plane;
    cur = out;
    out += kn * oplane;
  }
  return cur;
}

// Top-down walk of level-0 cell (y, x): first-max argmax over the top
// map, then k = 2k + offset from level levels - 1 down to level `last`,
// whose offsets `args` starts with (levels last..levels-1, as pyramid_up
// laid them out).  Returns the cell's bin at level `last`.
__device__ inline int descend_cell(const float* top, const int8_t* args,
                                   int d0, int t, int last, int levels,
                                   int y, int x) {
  const int dtop = d0 >> levels;
  int k = 0;
  float best = top[0];
  for (int d = 1; d < dtop; ++d) {
    const float v = top[d];
    if (v > best) {
      best = v;
      k = d;
    }
  }
  for (int l = levels - 1; l >= last; --l) {
    int off = 0;  // offset of level l's args
    for (int m = last; m < l; ++m) off += (d0 >> (m + 1)) * (t >> m) * (t >> m);
    const int sl = t >> l;
    k = 2 * k + args[off + k * sl * sl + (y >> l) * sl + (x >> l)];
  }
  return k;
}

}  // namespace dm
