// K5: one level of the aggregation pyramid on a D-major volume in device
// memory.
//
// Replaces deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:
// _slab_kernel (via _aggregate_slabs / aggregate_slabs).  The TPU kernel
// walks the disparity axis in 32-plane slabs, threading one halo plane
// per level from slab to slab, because VMEM cannot hold all of D; device
// memory can, so here each level is one launch over the whole volume.
// In: level l, (n, d, h, w) f32 or bf16.  Out: level l + 1, (n, d/2, h/2,
// w/2) in the same type, and the pool offsets of level l, (n, d/2, h, w)
// int8 in {-1, 0, 1}.
//
// One thread per parent cell (b, k, I, J), consecutive threads on
// consecutive J.  It pools planes 2k-1, 2k, 2k+1 of its four children
// (-1.0 below plane 0; ties lo, then even, then odd), records the four
// offsets, optionally rectifies the pooled values (fast mode at l > 0,
// the deferred power), merges in ((q00 + q01) + (q10 + q11)) * 0.25
// order and optionally rectifies the merge (exact mode).  powf, never
// __powf: the semantics of pyramid.cuh, so K5 and K3 agree bitwise.
//
// The bfloat16 instance (Config.dtype='bfloat16'; pyramid_pallas.py's
// slab kernel on a bf16 volume) reads and writes bf16 maps and rounds
// every op's result to bf16, as pyramid.cuh's BF16 form does; the wrapper
// passes lam rounded to bf16 (1.3984375 for 1.4), the exponent JAX's
// jnp.power(x, jnp.asarray(lam, dt)) uses.  Its offsets stay int8.
//
// Bound on this card by device memory: level 0 reads the volume once
// (4 B per element in f32, 2 B in bf16; each child pair as one load)
// and writes an eighth of it plus the offsets as one byte per pooled
// element; ~6 flops per element is far below the compute roof.  Every
// index is size_t: a batch of large-D volumes passes 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pyramid.cuh"

namespace {

constexpr int kThreads = 256;

// Children (2J, 2J + 1) of one row of one plane, at an even, aligned index.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
aggregate_level_kernel(const T* __restrict__ cur, T* __restrict__ nxt,
                       int8_t* __restrict__ arg, size_t total, int d, int h,
                       int w, int pow_pooled, int pow_merged, float lam) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int kn = d >> 1, hh = h >> 1, hw = w >> 1;
  const int J = (int)(e % hw);
  size_t r = e / hw;
  const int I = (int)(r % hh);
  r /= hh;
  const int k = (int)(r % kn);
  const size_t b = r / kn;
  const size_t plane = (size_t)h * w;
  const T* src = cur + b * d * plane;
  int8_t* a = arg + (b * kn + k) * plane;

  float q[4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const size_t c = (size_t)(2 * I + u) * w + 2 * J;  // even: pair-aligned
    const float2 ev = load_pair(src + 2 * k * plane + c);
    const float2 od = load_pair(src + (2 * k + 1) * plane + c);
    const float2 lo = k > 0 ? load_pair(src + (2 * k - 1) * plane + c)
                            : make_float2(-1.0f, -1.0f);
    const float lv[2] = {lo.x, lo.y}, evv[2] = {ev.x, ev.y},
                odv[2] = {od.x, od.y};
    int8_t off[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      float pooled = fmaxf(fmaxf(lv[v], evv[v]), odv[v]);
      off[v] = pooled == lv[v] ? -1 : (pooled == evv[v] ? 0 : 1);
      if constexpr (kBf16) {
        if (pow_pooled) pooled = dm::round_bf16(powf(pooled, lam));
      } else {
        if (pow_pooled) pooled = powf(pooled, lam);
      }
      q[2 * u + v] = pooled;
    }
    *reinterpret_cast<char2*>(a + c) = make_char2(off[0], off[1]);
  }
  if constexpr (kBf16) {
    const float m = dm::quad_mean_bf16(q);
    store(nxt + e, pow_merged ? powf(m, lam) : m);  // store rounds
  } else {
    const float m = ((q[0] + q[1]) + (q[2] + q[3])) * 0.25f;
    nxt[e] = pow_merged ? powf(m, lam) : m;
  }
}

template <typename T>
int launch(const void* cur, void* nxt, int8_t* arg, int n, int d, int h,
           int w, int pow_pooled, int pow_merged, float lam,
           cudaStream_t stream) {
  const size_t total = (size_t)n * (d >> 1) * (h >> 1) * (w >> 1);
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidConfiguration;
  aggregate_level_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(cur), static_cast<T*>(nxt), arg, total, d, h, w,
      pow_pooled, pow_merged, lam);
  return (int)cudaGetLastError();
}

}  // namespace

// cur/nxt: float (bf16 == 0) or __nv_bfloat16 maps.
extern "C" int dm_aggregate_level(const void* cur, void* nxt, int8_t* arg,
                                  int n, int d, int h, int w, int pow_pooled,
                                  int pow_merged, float lam, int bf16,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(cur, nxt, arg, n, d, h, w, pow_pooled,
                                      pow_merged, lam, st)
              : launch<float>(cur, nxt, arg, n, d, h, w, pow_pooled,
                              pow_merged, lam, st);
}
