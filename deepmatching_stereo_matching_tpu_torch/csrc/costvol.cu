// K2 and K6: level-0 correlation cost volume, in two layouts.
//
// K2 (D-major, (b, d, i, j)) replaces deepmatching_stereo_matching_tpu/
// ops/costvol_pallas.py:_kernel_dmajor (via _cost_volume_rows(dmajor=True)
// / cost_volume_dmajor).  K6 (row layout, (b, i, d, j)) replaces
// costvol_pallas.py:_kernel (via _cost_volume_rows(dmajor=False),
// cost_volume and cost_volume_slab): the volume of the sharded strategies,
// where one patch row's planes are contiguous and so are the H-chunks
// that dslab's all_to_all moves.
// out[b, .., d, .., j] = relu(<src[b, i, j, :], tgt[b, i, x, :]>), with
// x = p*(j + origin_offset) -+ (d_offset + d) (minus forward, plus
// reverse); exactly 0 where x falls outside [0, wt) or d_offset + d >=
// max_d.  d_offset makes the volume one disparity slab [d_offset,
// d_offset + d0) of a larger one; the TPU kernel shifted the target by
// whole patch columns instead, because its schedule could not depend on a
// traced offset.  One kernel, the layout a template flag: a slab of K6 is
// bitwise the same bins of K2, and the sharded strategies bitwise the
// unsharded pipeline.
//
// What bounds it on this card: device memory.  Each bin costs 2*C flops
// and 4 bytes of output; the descriptors are read once.  At the bench
// (64 instances, C = 16, D0 = 64) that is 0.45 GB, 0.135 ms at 3.35 TB/s,
// against 0.03 ms of FMAs.  The earlier kernel gave each thread one
// (b, i, j) and had it read its source and each target descriptor from
// device memory: a warp's loads touched 32 cache lines each (lanes
// 4*C and 4*p*C bytes apart) for one useful float per line, and nothing
// reused a target column across the ~D0/p bins that read it.
//
// The design:
//   1. A block owns kTj = 32 consecutive patch columns j0.. of one (b, i)
//      and one chunk of dc bins [dc0, dc0 + dc).  It stages into shared
//      memory, by cp.async, the tile's source descriptors and the target
//      strip its bins read, both contiguous in device memory: 16-byte
//      copies where C is a multiple of 4 and the tensors are 16-byte
//      aligned, 4-byte copies otherwise.  Columns outside [0, wt) and
//      patch columns past w0 are zero-filled (a copy of 0 source bytes).
//      C is staged in chunks of at most kCk floats, double-buffered, the
//      bins' accumulators staying in registers across chunks.
//   2. Register-tiled correlation.  Warp g owns the kJr = 4 patch columns
//      jg + u (jg = j0 + 4g) and lane l of run r the bins (jg + u,
//      dc0 - skew + e + u*p) forward, (jg + u, dc0 + e - u*p) reverse,
//      e = 32r + l, skew = 3p: the four bins of a lane read ONE target
//      column (p*(jg + u) - d does not depend on u), so each float4 of
//      the target feeds 16 FMAs, and each float4 of the source (the same
//      address across the warp: one broadcast) feeds 4 * runs.  At the
//      bench, 7 loads of 16 bytes per 48 FMAs per lane.  A warp's lanes
//      read consecutive target columns; the shared row stride s is 4 mod
//      8 floats, so the float4 loads of each quarter-warp fall in
//      distinct banks.  The skewed runs cover dc + skew bins rounded up to
//      32 per column group, so some lanes compute bins outside the chunk
//      (2/3 useful at the bench) and discard them.
//   3. The numbers: each bin's dot is one FMA chain over k = 0..C-1 in
//      order from 0.0f (__fmaf_rn: nothing reorders or splits it), as the
//      earlier kernel's `acc += a[k] * b[k]` compiled.  Masked bins write
//      0.0f, not relu of a dot with a zero-filled column.
//   4. Writes.  The bins go through shared memory ((dc, kTj + 1) floats,
//      conflict-free) and leave as whole rows of 32 consecutive j: 128
//      bytes per warp store in either layout, so K6 needs no grid of its
//      own.
//   5. A block takes costvol_plan(c, d0, p).smem bytes (at most 110,592,
//      at p = 8 with C >= 64), so at least two share an SM;
//      __launch_bounds__ holds the registers to that.
// The earlier chunk (kRowsChunk) and K6's d-chunked grid are gone: every
// block writes whole rows, whatever the layout.
//
// K2's bfloat16 instance (T = __nv_bfloat16, D-major only; Config.dtype=
// 'bfloat16' on the descriptor routes, costvol_pallas.py:117-118 on bf16
// descriptors): the descriptors are bf16 and widened exactly to float as
// they are staged, by plain loads (16 bytes = 8 elements where C is a
// multiple of 8 and both tensors are 16-byte aligned, else 2 bytes = 1),
// since the widening needs them in registers; the shared layout, the plan
// and the FMA chain are the float32 instance's, so each bin's sum is the
// float32 kernel's on the widened descriptors, and it is rounded once,
// after the relu and the mask, as it is written (rows of 32 j are 64
// bytes).  So its volume is bitwise the float32 kernel's on the widened
// descriptors, rounded.  The product of two bf16 values is exact in
// float32, so the FMA and a multiply-add give the same sums, the rule JAX's
// kernel follows.  No JAX path runs K6 in bf16, so there is no row-layout
// bf16 instance.  The float32 instances compile as before (every bf16
// step sits under `if constexpr`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJr = 4;              // patch columns per warp
constexpr int kTj = kWarps * kJr;   // patch columns per block
constexpr int kRunsMax = 4;         // runs of 32 bins per lane
constexpr int kCk = 32;             // descriptor floats per staged chunk

// A block's schedule; mirrored by ops/costvol_cuda.py:plan.
struct CostvolPlan {
  int skew;   // (kJr - 1) * p: the run's shift across a warp's columns
  int dc;     // bins per chunk
  int nch;    // chunks of d0
  int nr;     // runs of 32 per lane
  int w;      // target strip columns
  int ck;     // descriptor floats per C chunk
  int nck;    // C chunks
  int s;      // shared row stride, floats: 4 mod 8
  int bufs;   // staging buffers: 2 when C is chunked
  int buf;    // floats of one buffer: kTj source rows, then w strip rows
  int smem;   // bytes
};

__host__ __device__ inline CostvolPlan costvol_plan(int c, int d0, int p) {
  CostvolPlan q;
  q.skew = (kJr - 1) * p;
  const int dcmax = 32 * kRunsMax - q.skew;
  q.nch = dcmax > 0 ? (d0 + dcmax - 1) / dcmax : 0;
  q.dc = q.nch > 0 ? (d0 + q.nch - 1) / q.nch : 0;
  q.nr = (q.dc + q.skew + 31) / 32;
  q.w = p * (kTj - kJr) + 32 * q.nr;
  q.ck = c < kCk ? c : kCk;
  q.nck = (c + q.ck - 1) / q.ck;
  q.s = (q.ck + 3) / 4 * 4;
  if (q.s % 8 == 0) q.s += 4;
  q.bufs = q.nck > 1 ? 2 : 1;
  q.buf = (kTj + q.w) * q.s;
  const int stage = q.bufs * q.buf;
  const int out = q.dc * (kTj + 1);
  q.smem = (4 * (stage > out ? stage : out) + 15) / 16 * 16;
  return q;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

// Floats [kc, kc + ckc) of the tile's kTj source rows and of the strip's
// w target columns from x_lo, into buf's rows (stride s); rows outside
// the data zero-filled.  16-byte copies (VEC16) or 4-byte ones.
template <bool VEC16>
__device__ __forceinline__ void stage(float* buf, const CostvolPlan& q,
                                      const float* __restrict__ srow,
                                      const float* __restrict__ trow, int c,
                                      int w0, int wt, int j0, int x_lo,
                                      int kc, int ckc) {
  const int rows = kTj + q.w;
  const int per_row = VEC16 ? ckc >> 2 : ckc;
  const int total = rows * per_row;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int row = e / per_row, k = e - row * per_row;
    const float* g = srow;
    bool ok;
    if (row < kTj) {
      ok = j0 + row < w0;
      if (ok) g = srow + (size_t)(j0 + row) * c;
    } else {
      const int x = x_lo + row - kTj;
      ok = x >= 0 && x < wt;
      if (ok) g = trow + (size_t)x * c;
    }
    if (VEC16) {
      cp_async16(buf + row * q.s + 4 * k, ok ? g + kc + 4 * k : srow,
                 ok ? 16 : 0);
    } else {
      cp_async4(buf + row * q.s + k, ok ? g + kc + k : srow, ok ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// stage() for bfloat16 descriptors: elements [kc, kc + ckc) of the same
// rows, widened to float as they are stored, by 16-byte loads of 8
// elements (VEC16) or 2-byte loads of one; rows outside the data
// zero-filled.  Synchronous: the caller's barrier orders it.
template <bool VEC16>
__device__ __forceinline__ void stage_bf16(
    float* buf, const CostvolPlan& q, const __nv_bfloat16* __restrict__ srow,
    const __nv_bfloat16* __restrict__ trow, int c, int w0, int wt, int j0,
    int x_lo, int kc, int ckc) {
  const int rows = kTj + q.w;
  const int per_row = VEC16 ? ckc >> 3 : ckc;
  const int total = rows * per_row;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int row = e / per_row, k = e - row * per_row;
    const __nv_bfloat16* g = nullptr;
    if (row < kTj) {
      if (j0 + row < w0) g = srow + (size_t)(j0 + row) * c;
    } else {
      const int x = x_lo + row - kTj;
      if (x >= 0 && x < wt) g = trow + (size_t)x * c;
    }
    if (VEC16) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g) v = __ldg(reinterpret_cast<const uint4*>(g + kc + 8 * k));
      // Element 2m in the low half of word m, 2m + 1 in the high half.
      float4* d = reinterpret_cast<float4*>(buf + row * q.s + 8 * k);
      d[0] = make_float4(__uint_as_float(v.x << 16),
                         __uint_as_float(v.x & 0xffff0000u),
                         __uint_as_float(v.y << 16),
                         __uint_as_float(v.y & 0xffff0000u));
      d[1] = make_float4(__uint_as_float(v.z << 16),
                         __uint_as_float(v.z & 0xffff0000u),
                         __uint_as_float(v.w << 16),
                         __uint_as_float(v.w & 0xffff0000u));
    } else {
      buf[row * q.s + k] = g ? __bfloat162float(g[kc + k]) : 0.0f;
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[r][u] of this lane, over the staged floats [0, ckc) of buf.
__device__ __forceinline__ void correlate(const float* buf,
                                          const CostvolPlan& q, int g,
                                          const int (&tcol)[kRunsMax],
                                          int ckc,
                                          float (&acc)[kRunsMax][kJr]) {
  const float* sj = buf + g * kJr * q.s;
  const int nq = ckc >> 2;
  for (int k4 = 0; k4 < nq; ++k4) {
    float4 a[kJr];
#pragma unroll
    for (int u = 0; u < kJr; ++u)
      a[u] = *reinterpret_cast<const float4*>(sj + u * q.s + 4 * k4);
#pragma unroll
    for (int r = 0; r < kRunsMax; ++r) {
      if (r < q.nr) {
        const float4 t =
            *reinterpret_cast<const float4*>(buf + tcol[r] + 4 * k4);
#pragma unroll
        for (int u = 0; u < kJr; ++u) {
          acc[r][u] = __fmaf_rn(a[u].x, t.x, acc[r][u]);
          acc[r][u] = __fmaf_rn(a[u].y, t.y, acc[r][u]);
          acc[r][u] = __fmaf_rn(a[u].z, t.z, acc[r][u]);
          acc[r][u] = __fmaf_rn(a[u].w, t.w, acc[r][u]);
        }
      }
    }
  }
  for (int k = 4 * nq; k < ckc; ++k) {
    float a[kJr];
#pragma unroll
    for (int u = 0; u < kJr; ++u) a[u] = sj[u * q.s + k];
#pragma unroll
    for (int r = 0; r < kRunsMax; ++r) {
      if (r < q.nr) {
        const float t = buf[tcol[r] + k];
#pragma unroll
        for (int u = 0; u < kJr; ++u)
          acc[r][u] = __fmaf_rn(a[u], t, acc[r][u]);
      }
    }
  }
}

// T: the descriptors' and the volume's type (float, or __nv_bfloat16 for
// K2's bf16 instance).
template <bool ROWS, bool VEC16, typename T>
__global__ void __launch_bounds__(kThreads, 2)
costvol_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
               T* __restrict__ out, int h0, int w0, int wt, int c, int d0,
               int p, int max_d, int reverse, int origin_offset,
               int d_offset) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const CostvolPlan q = costvol_plan(c, d0, p);
  const int ntj = (w0 + kTj - 1) / kTj;
  const int tj = blockIdx.x % ntj, ch = blockIdx.x / ntj;
  const int i = blockIdx.y, b = blockIdx.z;
  const int j0 = tj * kTj, dc0 = ch * q.dc;
  const int dcn = min(q.dc, d0 - dc0);
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The strip: forward its last column serves lane 0 of run 0 of warp
  // kWarps - 1, reverse its first column lane 0 of run 0 of warp 0.
  const int xo = p * (j0 + origin_offset);
  const int x_lo = reverse ? xo + d_offset + dc0
                           : xo - d_offset - dc0 + q.skew - (32 * q.nr - 1);
  int tcol[kRunsMax];  // strip row of each run's column, times s
#pragma unroll
  for (int r = 0; r < kRunsMax; ++r) {
    const int e = 32 * r + lane;
    const int idx = p * kJr * g + (reverse ? e : 32 * q.nr - 1 - e);
    tcol[r] = (kTj + idx) * q.s;
  }

  const T* srow = src + ((size_t)b * h0 + i) * w0 * c;
  const T* trow = tgt + ((size_t)b * h0 + i) * wt * c;
  float acc[kRunsMax][kJr];
#pragma unroll
  for (int r = 0; r < kRunsMax; ++r)
#pragma unroll
    for (int u = 0; u < kJr; ++u) acc[r][u] = 0.0f;

  if constexpr (kBf16) {
    stage_bf16<VEC16>(sm, q, srow, trow, c, w0, wt, j0, x_lo, 0,
                      min(q.ck, c));
  } else {
    stage<VEC16>(sm, q, srow, trow, c, w0, wt, j0, x_lo, 0, min(q.ck, c));
  }
  for (int ci = 0; ci < q.nck; ++ci) {
    const int kc = ci * q.ck;
    if constexpr (kBf16) {
      if (ci + 1 < q.nck)
        stage_bf16<VEC16>(sm + ((ci + 1) & 1) * q.buf, q, srow, trow, c, w0,
                          wt, j0, x_lo, kc + q.ck, min(q.ck, c - kc - q.ck));
    } else if (ci + 1 < q.nck) {
      stage<VEC16>(sm + ((ci + 1) & 1) * q.buf, q, srow, trow, c, w0, wt, j0,
                   x_lo, kc + q.ck, min(q.ck, c - kc - q.ck));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    correlate(sm + (ci & 1) * q.buf, q, g, tcol, min(q.ck, c - kc), acc);
    __syncthreads();
  }

  // The bins of the chunk, masked, into a (dc, kTj + 1) stage ...
  constexpr int os = kTj + 1;
#pragma unroll
  for (int r = 0; r < kRunsMax; ++r) {
    if (r >= q.nr) break;
    const int e = 32 * r + lane;
    const int x = x_lo + p * kJr * g + (reverse ? e : 32 * q.nr - 1 - e);
    const bool in = x >= 0 && x < wt;
#pragma unroll
    for (int u = 0; u < kJr; ++u) {
      const int jj = g * kJr + u;
      const int dd = reverse ? e - u * p : e + u * p - q.skew;
      if (dd >= 0 && dd < dcn && j0 + jj < w0) {
        const bool live = in && d_offset + dc0 + dd < max_d;
        sm[dd * os + jj] = live ? fmaxf(acc[r][u], 0.0f) : 0.0f;
      }
    }
  }
  __syncthreads();
  // ... and out as whole rows of kTj consecutive j.
  const size_t i_stride = ROWS ? (size_t)d0 * w0 : (size_t)w0;
  const size_t d_stride = ROWS ? (size_t)w0 : (size_t)h0 * w0;
  T* o = out + (size_t)b * d0 * h0 * w0 + i * i_stride + j0 + lane;
  if (j0 + lane < w0) {
    for (int dd = g; dd < dcn; dd += kWarps)
      store(o + (dc0 + dd) * d_stride, sm[dd * os + lane]);
  }
}

template <bool ROWS, bool VEC16, typename T>
dm::SmemAllowance& allowance() {
  static dm::SmemAllowance a((const void*)costvol_kernel<ROWS, VEC16, T>);
  return a;
}

template <bool ROWS, bool VEC16, typename T>
int launch(const T* src, const T* tgt, T* out, int n, int h0, int w0, int wt,
           int c, int d0, int p, int max_d, int reverse, int origin_offset,
           int d_offset, cudaStream_t stream) {
  const CostvolPlan q = costvol_plan(c, d0, p);
  if (q.nch <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allowance<ROWS, VEC16, T>().allow(q.smem);
  if (err != cudaSuccess) return (int)err;
  const long long gx = (long long)((w0 + kTj - 1) / kTj) * q.nch;
  if (gx > INT_MAX || h0 > 65535 || n > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, h0, n);
  costvol_kernel<ROWS, VEC16, T><<<grid, kThreads, q.smem, stream>>>(
      src, tgt, out, h0, w0, wt, c, d0, p, max_d, reverse, origin_offset,
      d_offset);
  return (int)cudaGetLastError();
}

// 16-byte staging where every row of C elements starts on a 16-byte
// boundary (C a multiple of 4 floats, or of 8 bf16).
template <typename T>
bool vec16(const T* src, const T* tgt, int c) {
  return c % (16 / sizeof(T)) == 0 &&
         (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(tgt) & 15) == 0;
}

template <bool ROWS, typename T>
int dispatch(const T* src, const T* tgt, T* out, int n, int h0, int w0,
             int wt, int c, int d0, int p, int max_d, int reverse,
             int origin_offset, int d_offset, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return vec16(src, tgt, c)
             ? launch<ROWS, true>(src, tgt, out, n, h0, w0, wt, c, d0, p,
                                  max_d, reverse, origin_offset, d_offset, st)
             : launch<ROWS, false>(src, tgt, out, n, h0, w0, wt, c, d0, p,
                                   max_d, reverse, origin_offset, d_offset,
                                   st);
}

template <bool ROWS, bool VEC16, typename T>
int occupancy(int smem) {
  return dm::blocks_per_sm(allowance<ROWS, VEC16, T>(),
                           (const void*)costvol_kernel<ROWS, VEC16, T>,
                           kThreads, smem);
}

}  // namespace

// Shared memory of one block (mirrored by ops/costvol_cuda.py:smem_bytes);
// 0 where the tile cannot take p (3 * p >= 128).
extern "C" int dm_costvol_smem(int c, int d0, int p) {
  const CostvolPlan q = costvol_plan(c, d0, p);
  return q.nch > 0 ? q.smem : 0;
}

// Blocks of the instance that a launch with 16-byte aligned tensors takes
// (row layout or D-major; float32 or, D-major only, bf16) that one SM
// holds; negative: a CUDA error.
extern "C" int dm_costvol_blocks_per_sm(int c, int d0, int p, int rows,
                                        int bf16) {
  const int smem = dm_costvol_smem(c, d0, p);
  if (smem <= 0 || (rows && bf16)) return -(int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (bf16)
    return c % 8 == 0 ? occupancy<false, true, bf>(smem)
                      : occupancy<false, false, bf>(smem);
  const bool v = c % 4 == 0;
  if (rows)
    return v ? occupancy<true, true, float>(smem)
             : occupancy<true, false, float>(smem);
  return v ? occupancy<false, true, float>(smem)
           : occupancy<false, false, float>(smem);
}

// K2: out is (n, d0, h0, w0).
extern "C" int dm_costvol_dmajor(const float* src, const float* tgt,
                                 float* out, int n, int h0, int w0, int wt,
                                 int c, int d0, int p, int max_d, int reverse,
                                 int origin_offset, void* stream) {
  return dispatch<false>(src, tgt, out, n, h0, w0, wt, c, d0, p, max_d,
                         reverse, origin_offset, 0, stream);
}

// K2's bf16 instance: bf16 descriptors, out (n, d0, h0, w0) bf16.
extern "C" int dm_costvol_dmajor_bf16(const void* src, const void* tgt,
                                      void* out, int n, int h0, int w0,
                                      int wt, int c, int d0, int p, int max_d,
                                      int reverse, int origin_offset,
                                      void* stream) {
  using bf = __nv_bfloat16;
  return dispatch<false>(static_cast<const bf*>(src),
                         static_cast<const bf*>(tgt), static_cast<bf*>(out),
                         n, h0, w0, wt, c, d0, p, max_d, reverse,
                         origin_offset, 0, stream);
}

// K6: out is (n, h0, d0, w0), global bins [d_offset, d_offset + d0).
extern "C" int dm_costvol_rows(const float* src, const float* tgt, float* out,
                               int n, int h0, int w0, int wt, int c, int d0,
                               int p, int max_d, int reverse,
                               int origin_offset, int d_offset, void* stream) {
  return dispatch<true>(src, tgt, out, n, h0, w0, wt, c, d0, p, max_d,
                        reverse, origin_offset, d_offset, stream);
}
