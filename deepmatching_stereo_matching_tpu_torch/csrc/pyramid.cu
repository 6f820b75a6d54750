// K3: pyramid + dense backtracking on a D-major cost volume.
//
// Replaces deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:_kernel
// (pyramid_body(fast=False) via _pyramid_backtrack / pyramid_backtrack).
// In: (n, D0, H0, W0) f32.  Out: (n, H0, W0) int32 disparity bins and
// f32 level-0 scores.  Exact mode: the correctly rounded power after
// every merge (pyramid.cuh:pow_rn; powf in the bfloat16 instance, whose
// result rounds to bf16).
//
// One block of 256 threads per (instance, 2^L x 2^L-patch tile), on K1's
// level-0 structure (fused.cu:level0) with loads of the volume in place of
// the costs K1 computes:
//   1. Level 0, streamed: a thread owns one level-0 cell, the four cells
//      of a 2x2 quad in adjacent lanes (at T >= 16 a warp reads two
//      64-byte row segments of each plane).  It reads its costs
//      cost[n][d][y0+y][x0+x] straight from device memory, kStep planes
//      at a time, the next kStep planes' loads issued before the current
//      ones are pooled.  Each (2k-1, 2k, 2k+1) is pooled in registers (pad
//      -1 below bin 0, ties lo/even/odd), its offset packed at 2 bits, and
//      the quad's 4-child mean formed by two __shfl_xor_sync in
//      ((q00 + q01) + (q10 + q11)) * 0.25 order, then x^lam by pow_rn
//      (float32; each of the quad's four lanes powers one of a step's four
//      planes): the level-1 map, the only level-0 result in shared memory.
//   2. Levels >= 1 and the top-down walk: pyramid.cuh from level 1.
//   3. The score: one load of cost[k] per cell, a copy, so bitwise.
// Shared memory holds levels 1..L and the offsets only: 12,576 B at the
// bench (D0 = 64, T = 16) against 84,256 B with the (D0, T, T) tile, so
// registers, not shared memory, set the blocks per SM, and one block's
// loads overlap another's levels >= 1 and barriers.
// Bound on this card by the volume read: 4 B per cost, 0.06 ms for the
// bench's 64 instances at 3.35 TB/s; ~12 operations per cost.
//
// BF16 (K3's bfloat16 instance; pyramid_pallas.py:pyramid_body on a bf16
// volume, Config.dtype='bfloat16' on the descriptor routes): the volume is
// bf16 (2 B per cost), each cost widened exactly as it is loaded; every
// map is rounded to bf16 after each op, as XLA does per op on bf16 arrays:
// the w-pair sum, the h-pair sum, the * 0.25 and powf (round_bf16), with
// lam as the wrapper passes it (1.4 rounded to bf16, 1.3984375: JAX's
// jnp.power(m, jnp.asarray(lam, dt))); comparisons read the exact
// widenings, and the score is the bf16 cost at the winner, widened.  The
// levels stay floats holding bf16 values, so the layout, the shared
// memory and the blocks per SM are the float32 instance's, and the
// float32 instance compiles as before (every bf16 step sits under
// `if constexpr`).

#include <cuda_bf16.h>

#include <type_traits>

#include "launch.cuh"
#include "pyramid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStep = 8;  // planes per step of the level-0 stream

// Shared memory of one block: offsets in bytes.
struct PyramidLayout {
  int t, kn, lv, arg0, args, total;
};

__host__ __device__ inline PyramidLayout pyramid_layout(int d0, int levels) {
  PyramidLayout f;
  f.t = 1 << levels;
  f.kn = d0 / 2;
  int o = 0;
  f.lv = o;  // pyramid levels 1..levels
  o += 4 * dm::level_floats(d0, f.t, levels);
  f.arg0 = o;  // level-0 offsets, 2 bits each: (kn/4, T, T) bytes
  o += (f.kn + 3) / 4 * f.t * f.t;
  f.args = o;  // offsets of levels 1..levels-1, int8
  o += dm::arg_bytes(d0, f.t, levels) - f.kn * f.t * f.t;
  f.total = (o + 15) & ~15;
  return f;
}

// The volume's element type: float, or __nv_bfloat16 in the BF16 instance.
template <bool BF16>
using Cost = std::conditional_t<BF16, __nv_bfloat16, float>;

// One cost, as a float (a bf16 cost widened exactly).
__device__ __forceinline__ float load_cost(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_cost(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// c[r] = cost of plane d + r of one cell (col: the cell in plane 0), 0
// past d0.
template <typename T>
__device__ __forceinline__ void load_planes(const T* __restrict__ col,
                                            size_t plane, int d, int d0,
                                            float (&c)[kStep]) {
#pragma unroll
  for (int r = 0; r < kStep; ++r)
    c[r] = d + r < d0 ? load_cost(col + (size_t)(d + r) * plane) : 0.0f;
}

// Level 0 of the tile, streamed over d per cell from src (the instance's
// volume at the tile origin): writes the level-1 map lv1 ((D0/2, T/2,
// T/2)) and the packed level-0 offsets arg0.
template <bool BF16>
__device__ void level0(const Cost<BF16>* __restrict__ src, size_t plane,
                       int w0, float* lv1, uint8_t* arg0, int d0, int t,
                       float lam) {
  const int cells = t * t, hs = t >> 1, kn = d0 >> 1;
  for (int base = 0; base < cells; base += blockDim.x) {
    if (base + (int)(threadIdx.x & ~31u) >= cells) continue;  // whole warp idle
    const int e = base + threadIdx.x;
    const bool active = e < cells;
    const int ec = e & (cells - 1);  // idle lanes shadow a real cell
    const int q = ec >> 2, sub = ec & 3;
    const int I = q / hs, J = q - I * hs;
    const int i = 2 * I + (sub >> 1), j = 2 * J + (sub & 1);
    const int cell = i * t + j;
    const Cost<BF16>* col = src + (size_t)i * w0 + j;

    float cur[kStep], nxt[kStep];
    load_planes(col, plane, 0, d0, cur);
    float prevc = -1.0f;  // c[2k - 1]; the pad below bin 0
    uint32_t pack = 0u;
    for (int d = 0; d < d0; d += kStep) {
      load_planes(col, plane, d + kStep, d0, nxt);
      float mq[kStep / 2];  // float32: this step's quad sums, one a plane
#pragma unroll
      for (int h = 0; h < kStep / 2; ++h) {
        const int k = (d >> 1) + h;
        if (k >= kn) break;
        const float lo = prevc, ev = cur[2 * h], od = cur[2 * h + 1];
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
            lv1[k * hs * hs + q] = dm::round_bf16(
                powf(dm::round_bf16(__fmul_rn(m, 0.25f)), lam));
        } else {
          const float m = pooled + __shfl_xor_sync(kFull, pooled, 1);
          mq[h] = m + __shfl_xor_sync(kFull, m, 2);  // alike in all 4 lanes
        }
        prevc = od;
      }
      if constexpr (!BF16) {
        // The quad's four lanes take one plane's power each.
        static_assert(kStep / 2 == 4, "one plane a lane of the quad");
        const int k = (d >> 1) + sub;
        const float m = sub == 0 ? mq[0]
                        : sub == 1 ? mq[1]
                        : sub == 2 ? mq[2] : mq[3];
        if (active && k < kn)
          lv1[k * hs * hs + q] = dm::pow_rn(m * 0.25f, lam);
      }
#pragma unroll
      for (int r = 0; r < kStep; ++r) cur[r] = nxt[r];
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(dm::kThreads, 4)
pyramid_kernel(const Cost<BF16>* __restrict__ cost, int32_t* __restrict__ disp,
               float* __restrict__ score, int d0, int h0, int w0, int levels,
               float lam) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const PyramidLayout f = pyramid_layout(d0, levels);
  const int t = f.t;
  const int tiles_w = w0 / t;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * t, x0 = tx * t;
  const size_t plane = (size_t)h0 * w0;
  const Cost<BF16>* src =
      cost + (size_t)n * d0 * plane + (size_t)y0 * w0 + x0;
  float* lv = reinterpret_cast<float*>(sm + f.lv);
  uint8_t* arg0 = reinterpret_cast<uint8_t*>(sm + f.arg0);
  int8_t* args = reinterpret_cast<int8_t*>(sm + f.args);

  level0<BF16>(src, plane, w0, lv, arg0, d0, t, lam);
  __syncthreads();
  const int hs = t >> 1;
  const float* top = dm::pyramid_up<false, BF16>(lv, lv + f.kn * hs * hs,
                                                 args, d0, t, 1, levels, lam);
  int32_t* dst = disp + (size_t)n * plane;
  float* sco = score + (size_t)n * plane;
  for (int cell = threadIdx.x; cell < t * t; cell += blockDim.x) {
    const int y = cell / t, x = cell - y * t;
    int k = dm::descend_cell(top, args, d0, t, 1, levels, y, x);
    const int code = (arg0[(k >> 2) * t * t + cell] >> (2 * (k & 3))) & 3;
    k = 2 * k + code - 1;
    const size_t o = (size_t)(y0 + y) * w0 + (x0 + x);
    dst[o] = k;
    if constexpr (BF16) {
      sco[o] = __bfloat162float(src[(size_t)k * plane + (size_t)y * w0 + x]);
    } else {
      sco[o] = src[(size_t)k * plane + (size_t)y * w0 + x];
    }
  }
}

template <bool BF16>
dm::SmemAllowance& allowance() {
  static dm::SmemAllowance a((const void*)pyramid_kernel<BF16>);
  return a;
}

template <bool BF16>
int launch(const void* cost, int32_t* disp, float* score, int n, int d0,
           int h0, int w0, int levels, float lam, cudaStream_t stream) {
  const PyramidLayout f = pyramid_layout(d0, levels);
  const cudaError_t err = allowance<BF16>().allow(f.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h0 / f.t) * (w0 / f.t), n);
  pyramid_kernel<BF16><<<grid, dm::kThreads, f.total, stream>>>(
      static_cast<const Cost<BF16>*>(cost), disp, score, d0, h0, w0, levels,
      lam);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one block (mirrored by ops/pyramid_cuda.py:smem_bytes;
// routing decides on the earlier layout's bytes, pyramid_cuda.route_bytes).
extern "C" int dm_pyramid_smem(int d0, int levels) {
  return pyramid_layout(d0, levels).total;
}

// Blocks of the float32 or bf16 instance one SM holds at this
// configuration; negative: a CUDA error.
extern "C" int dm_pyramid_blocks_per_sm(int d0, int levels, int bf16) {
  const int smem = dm_pyramid_smem(d0, levels);
  return bf16 ? dm::blocks_per_sm(allowance<true>(),
                                  (const void*)pyramid_kernel<true>,
                                  dm::kThreads, smem)
              : dm::blocks_per_sm(allowance<false>(),
                                  (const void*)pyramid_kernel<false>,
                                  dm::kThreads, smem);
}

// cost: (n, d0, h0, w0) float32, or bf16 where bf16 != 0.
extern "C" int dm_pyramid_backtrack(const void* cost, int32_t* disp,
                                    float* score, int n, int d0, int h0,
                                    int w0, int levels, float lam, int bf16,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<true>(cost, disp, score, n, d0, h0, w0, levels, lam,
                             st)
              : launch<false>(cost, disp, score, n, d0, h0, w0, levels, lam,
                              st);
}

extern "C" const char* dm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
