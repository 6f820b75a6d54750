// K4: padded image rows -> the D-major level-0 cost volume.
//
// Replaces deepmatching_stereo_matching_tpu/ops/fused_pallas.py:
// _cost_only_kernel (via _cost_volume_rows / cost_volume_rows): K1's cost
// block (cost.cuh, which both kernels compile) with the volume written to
// device memory instead of a pyramid run on it, for volumes whose quadtree
// tile does not fit one block's shared memory (KITTI at D0 = 128 and 256).
// In: (n, Hp, Wp) f32 left and right images, patch form.  Out:
// (n, D0, H0, W0) f32 or bf16 (below).
//
// One block per (instance, th x 32-patch tile), one thread per patch, a
// warp per patch row: each d-plane store of a warp is one 128-byte line.
// The tile is fixed by (p, max_d), not by the pyramid depth: no merge
// happens here.  Per block:
//   1. Stage the tile's p*th x 32p left pixels and the right strip its
//      targets reach, from image column 32p*x0 - round_up(max_d - 1, 4),
//      by cp.async (cost.cuh:stage_rows), then the right-window norms
//      (cost.cuh:window_norms), as K1 does, but with the square of pixel
//      row 4 rounded before it is added (ROW4): the volume at p >= 5 stays
//      bitwise what this kernel's earlier rolled loops computed.
//   2. p = 4 (a template instance): the thread holds its 4 x 4 left pixels
//      in registers and walks d in steps of four through cost.cuh:costs4,
//      as K1 does: the window at d4 + r is floats 4 - r .. 7 - r of the
//      aligned float4 before the window start of d4 and the one at it, so
//      a step takes two 16-byte loads per pixel row and one of norms,
//      against two scalar loads per multiply-add before.  A warp's 32
//      lanes read 512 consecutive bytes per load: no bank conflicts.
//      (Carrying the float4 at the window start over from the step before,
//      one load fewer, ran no faster.)  Any other p: a runtime-p instance
//      that reads the staged pixels per cost (cost.cuh:cell_cost).
//   3. Every plane d < D0 is stored: 0 for d >= max_d and where p*jg < d.
//      Cells outside the (H0, W0) grid (ragged tiles) store nothing.
// th is 8 where two blocks fit an SM (58,368 B at KITTI D0 = 128: three
// blocks per SM; 78,848 B at D0 = 256: two), else 4, 2 or 1, so that two
// blocks fit at every configuration that fused_cuda.cost_supported routes
// here.  A wider tile (64 patch columns, two warps per row) would shrink
// the strip's overhang (2x the tile's width at D0 = 256 instead of 3x) but
// takes more shared memory per row for the same blocks per SM; the strip
// comes from L2, and what a block moves to device memory, its slice of the
// volume (th x 32 x D0 floats), is 3-5x what it stages.
//
// Bound on this card by the volume write: 4 B per cost, 0.09 ms for the
// 302 MB of 16 KITTI instances at D0 = 128 at 3.35 TB/s; the products
// (16 per cost) take a third of that at the FMA rate.
//
// The volume's element type is a template parameter: float, or
// __nv_bfloat16 for Config.dtype='bfloat16' (fused_pallas.py:_cost_block's
// c.astype(dtype)).  The bfloat16 instance computes the same float32 costs
// and rounds each once as it stores it (__float2bfloat16_rn), so its volume
// is bitwise the float32 volume rounded, at 2 B per cost: half the bytes
// that bound the kernel (0.045 ms of volume at KITTI D0 = 128 x 16).

#include <cuda_bf16.h>

#include "cost.cuh"
#include "launch.cuh"

namespace {

using namespace dm;

constexpr int kTw = 32;       // patch columns of a tile: one warp
constexpr int kMaxRows = 8;   // patch rows of a tile, at most
// The bytes a block may take for two per SM: an H100 SM's 233,472 B of
// shared memory over two blocks, less the 1 KB reserved per block.
constexpr int kTwoPerSm = 233472 / 2 - 1024;

// Shared memory of one block: strides in elements (bins: bytes), offsets
// in bytes.  The bin planes (K4b) follow K4's floats.
struct RowsLayout {
  int th, rows, lw, right, rs, is, lsb, rsb;
  int lt, rt, invr, lb, rb, total;
};

__host__ __device__ inline RowsLayout rows_layout(int p, int max_d, int th,
                                                  bool magbin) {
  RowsLayout f;
  f.th = th;
  f.rows = p * th;
  f.lw = p * kTw;  // a multiple of 4, and so is the tile origin p*x0
  const int lead = round_up(max_d - 1, 4);
  f.right = round_up(f.lw + lead, 4);
  f.rs = f.right | 4;                  // 4 mod 8
  f.is = ((f.right + 15) & ~31) + 16;  // 16 mod 32
  f.lsb = round_up(f.lw, 16);
  f.rsb = 4 * (round_up(f.right / 4, 4) | 4);  // 4 mod 8 words
  f.lt = 0;
  f.rt = 4 * f.rows * f.lw;
  f.invr = f.rt + 4 * f.rows * f.rs;
  f.lb = round_up(f.invr + 4 * th * f.is, 16);
  f.rb = f.lb + f.rows * f.lsb;
  f.total = magbin ? round_up(f.rb + f.rows * f.rsb, 16) : f.lb;
  return f;
}

// The layout at the tallest tile (8, 4, 2 or 1 patch rows) of which two
// blocks fit an SM.
__host__ __device__ inline RowsLayout pick_layout(int p, int max_d,
                                                  bool magbin) {
  int th = kMaxRows;
  while (th > 1 && rows_layout(p, max_d, th, magbin).total > kTwoPerSm)
    th >>= 1;
  return rows_layout(p, max_d, th, magbin);
}

__device__ __forceinline__ void store_cost(float* o, float c) { *o = c; }
__device__ __forceinline__ void store_cost(__nv_bfloat16* o, float c) {
  *o = __float2bfloat16_rn(c);
}

// p = 4: the costs of patch (i, j), global column jg, for d = 0..d0-1
// into o[d * plane], four planes per step (step 2 above); in magbin form
// (K4b) with the patch's four bin words in registers beside its pixels.
template <bool MAGBIN, typename T>
__device__ __forceinline__ void stream4(const Tile& s, int i, int j, int jg,
                                        float il, int d0, T* o,
                                        size_t plane) {
  uint32_t lbw[4] = {0u, 0u, 0u, 0u};
  float L[4][4];
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
    const float4 v =
        *reinterpret_cast<const float4*>(s.lt + (4 * i + dr) * s.ls + 4 * j);
    L[dr][0] = v.x;
    L[dr][1] = v.y;
    L[dr][2] = v.z;
    L[dr][3] = v.w;
    if (MAGBIN)
      lbw[dr] = *reinterpret_cast<const uint32_t*>(
          s.lb + (4 * i + dr) * s.lsb + 4 * j);
  }
  // The norm of the window at d = 0, whose start is aligned.
  float ivc = s.invr[i * s.is + 4 * j + s.lead];
  int d4 = 0;
  for (; d4 < d0 && d4 < s.max_d; d4 += 4) {
    float c[4];
    costs4<MAGBIN>(s, L, lbw, i, j, jg, d4, il, ivc, c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (d4 + r < d0) store_cost(o + (size_t)(d4 + r) * plane, c[r]);
  }
  for (; d4 < d0; d4 += 4) {  // planes d >= max_d
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (d4 + r < d0) store_cost(o + (size_t)(d4 + r) * plane, 0.0f);
  }
}

// One block of K4 (patch) or K4b (MAGBIN: lbin/rbin are the bin planes).
// K4's window norms keep its ROW4 rounding; K4b's are K1b's.
template <int P, bool MAGBIN, typename T>
__device__ __forceinline__ void rows_block(
    const float* __restrict__ left, const float* __restrict__ right,
    const float* __restrict__ lbin, const float* __restrict__ rbin,
    T* __restrict__ out, int hp, int wp, int p_arg, int d0, int max_d) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int p = P > 0 ? P : p_arg;
  const RowsLayout f = pick_layout(p, max_d, MAGBIN);
  const int h0 = hp / p, w0 = wp / p;
  const int tiles_w = (w0 + kTw - 1) / kTw;
  const int ty = blockIdx.x / tiles_w, tx = blockIdx.x - ty * tiles_w;
  const int n = blockIdx.y;
  const int y0 = ty * f.th, x0 = tx * kTw;  // tile origin in patches
  const int ly = p * y0, lx = p * x0;
  const int rx = lx - (max_d - 1), rx0 = rx - (rx & 3);

  float* lt = reinterpret_cast<float*>(sm + f.lt);
  float* rt = reinterpret_cast<float*>(sm + f.rt);
  float* invr = reinterpret_cast<float*>(sm + f.invr);
  uint8_t* lb = MAGBIN ? reinterpret_cast<uint8_t*>(sm + f.lb) : nullptr;
  uint8_t* rb = MAGBIN ? reinterpret_cast<uint8_t*>(sm + f.rb) : nullptr;
  const Tile s{lt, rt, invr, lb, rb, p, f.th, f.lw, f.rs, f.is,
               f.lsb, f.rsb, lx - rx0, max_d};
  const size_t img = (size_t)n * hp * wp;
  stage_rows(lt, f.lw, left + img, hp, wp, ly, lx, f.rows, f.lw);
  stage_rows(rt, f.rs, right + img, hp, wp, ly, rx0, f.rows, f.right);
  if constexpr (MAGBIN) {
    stage_rows(lb, f.lsb, lbin + img, hp, wp, ly, lx, f.rows, f.lw);
    stage_rows(rb, f.rsb, rbin + img, hp, wp, ly, rx0, f.rows, f.right);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  window_norms<!MAGBIN>(s, invr, f.right);
  __syncthreads();

  const int i = threadIdx.x >> 5, j = threadIdx.x & 31, jg = x0 + j;
  if (y0 + i >= h0 || jg >= w0) return;
  const size_t plane = (size_t)h0 * w0;
  T* o = out + (size_t)n * d0 * plane + (size_t)(y0 + i) * w0 + jg;
  const float il = left_inv_norm<P>(s, i, j);
  if constexpr (P == 4) {
    stream4<MAGBIN>(s, i, j, jg, il, d0, o, plane);
  } else {
    for (int d = 0; d < d0; ++d)
      store_cost(o + (size_t)d * plane,
                 cell_cost<P, MAGBIN>(s, i, j, jg, d, il));
  }
}

template <int P, typename T>
__global__ void __launch_bounds__(kMaxRows * 32, 3)
costrows_kernel(const float* __restrict__ left,
                const float* __restrict__ right, T* __restrict__ out,
                int hp, int wp, int p_arg, int d0, int max_d) {
  rows_block<P, false>(left, right, nullptr, nullptr, out, hp, wp, p_arg, d0,
                       max_d);
}

// K4b: K4 on grad_hist (magnitude, bin) plane pairs, the large-D route of
// the DeepMatching descriptor.  The magbin form of K4's cost block, as K1b
// is of K1's: each of the p^2 pixel pairs adds mag_L * mag_R where the two
// orientation bins agree (cost.cuh:costs4<true> / cell_cost<P, true>), and
// each norm is that of the magnitudes, so the cost is the oracle's
// normalised dot of one-hot grad_hist descriptors up to rounding.  The
// kernel has its own symbol, so a device trace tells it from K4.
//
// In: (n, Hp, Wp) f32 magnitude and bin planes of both images (bins are
// integers 0..7 held as floats, descriptors.grad_hist_magbin).  Out: the
// (n, D0, H0, W0) f32 or bf16 volume K4 writes for patch planes.  The
// block is K4's (a th x 32-patch tile, a thread per patch, a warp per patch
// row), with the bin planes staged as bytes beside the floats at K1b's
// strides (left rows at a multiple of 16 bytes, the right strip at 4 mod 8
// words, so a warp's 32 bin words of one row fall in 32 banks).  The right
// window norms round as K1b's do (no ROW4 term), so the volume is the cost
// K1b pools, bitwise, at every p.
//
// What bounds it on this card: the volume write, as K4's (4 B a cost;
// 2.42 GB for the 64 instances of a 32-pair KITTI step at D0 = 256, 0.72
// ms at 3.35 TB/s), with the arithmetic of the same order: a cost is p^2
// products, each behind a bin compare and a select, a multiply and an add
// where K4 has one FMA (at p = 4, 32 FP32 instructions a cost, 0.58 ms of
// the FP32 pipe for those 64 instances, the compares on the integer pipe
// beside them).  The bin planes, staged as bytes, add a quarter to K4's
// staged bytes.  The bfloat16 instance rounds each float32 cost once as it
// stores it.
template <int P, typename T>
__global__ void __launch_bounds__(kMaxRows * 32, 2)
costrows_magbin_kernel(const float* __restrict__ left,
                       const float* __restrict__ right,
                       const float* __restrict__ lbin,
                       const float* __restrict__ rbin, T* __restrict__ out,
                       int hp, int wp, int p_arg, int d0, int max_d) {
  rows_block<P, true>(left, right, lbin, rbin, out, hp, wp, p_arg, d0, max_d);
}

template <int P, bool MAGBIN, typename T>
const void* kernel() {
  if constexpr (MAGBIN) return (const void*)costrows_magbin_kernel<P, T>;
  return (const void*)costrows_kernel<P, T>;
}

template <int P, bool MAGBIN, typename T>
SmemAllowance& allowance() {
  static SmemAllowance a(kernel<P, MAGBIN, T>());
  return a;
}

template <int P, bool MAGBIN, typename T>
int launch(const float* left, const float* right, const float* lbin,
           const float* rbin, T* out, int n, int hp, int wp, int p, int d0,
           int max_d, cudaStream_t stream) {
  const RowsLayout f = pick_layout(p, max_d, MAGBIN);
  const cudaError_t err = allowance<P, MAGBIN, T>().allow(f.total);
  if (err != cudaSuccess) return (int)err;
  const int h0 = hp / p, w0 = wp / p;
  const dim3 grid(((h0 + f.th - 1) / f.th) * ((w0 + kTw - 1) / kTw), n);
  if constexpr (MAGBIN)
    costrows_magbin_kernel<P, T><<<grid, 32 * f.th, f.total, stream>>>(
        left, right, lbin, rbin, out, hp, wp, p, d0, max_d);
  else
    costrows_kernel<P, T><<<grid, 32 * f.th, f.total, stream>>>(
        left, right, out, hp, wp, p, d0, max_d);
  return (int)cudaGetLastError();
}

template <bool MAGBIN, typename T>
int occupancy(int p, int max_d) {
  const RowsLayout f = pick_layout(p, max_d, MAGBIN);
  return p == 4 ? blocks_per_sm(allowance<4, MAGBIN, T>(),
                                kernel<4, MAGBIN, T>(), 32 * f.th, f.total)
                : blocks_per_sm(allowance<0, MAGBIN, T>(),
                                kernel<0, MAGBIN, T>(), 32 * f.th, f.total);
}

template <bool MAGBIN, typename T>
int dispatch(const float* left, const float* right, const float* lbin,
             const float* rbin, T* out, int n, int hp, int wp, int p, int d0,
             int max_d, cudaStream_t st) {
  return p == 4 ? launch<4, MAGBIN, T>(left, right, lbin, rbin, out, n, hp,
                                       wp, p, d0, max_d, st)
                : launch<0, MAGBIN, T>(left, right, lbin, rbin, out, n, hp,
                                       wp, p, d0, max_d, st);
}

template <bool MAGBIN>
int dispatch_volume(const float* left, const float* right, const float* lbin,
                    const float* rbin, void* out, int n, int hp, int wp,
                    int p, int d0, int max_d, int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<MAGBIN>(left, right, lbin, rbin,
                            static_cast<__nv_bfloat16*>(out), n, hp, wp, p,
                            d0, max_d, st);
  return dispatch<MAGBIN>(left, right, lbin, rbin, static_cast<float*>(out),
                          n, hp, wp, p, d0, max_d, st);
}

}  // namespace

// Shared memory of one block (mirrored by ops/fused_cuda.py:
// cost_smem_bytes; routing decides on the earlier layout's bytes,
// fused_cuda.cost_route_bytes).
extern "C" int dm_cost_rows_smem(int p, int max_d) {
  return pick_layout(p, max_d, false).total;
}

// Blocks of the instance that serves (p, bf16) one SM holds; negative: a
// CUDA error.
extern "C" int dm_cost_rows_blocks_per_sm(int p, int max_d, int bf16) {
  return bf16 ? occupancy<false, __nv_bfloat16>(p, max_d)
              : occupancy<false, float>(p, max_d);
}

// out: (n, d0, h0, w0) float (bf16 == 0) or __nv_bfloat16.
extern "C" int dm_cost_rows(const float* left, const float* right, void* out,
                            int n, int hp, int wp, int p, int d0, int max_d,
                            int bf16, void* stream) {
  return dispatch_volume<false>(left, right, nullptr, nullptr, out, n, hp, wp,
                                p, d0, max_d, bf16, stream);
}

// K4b: shared memory of one block (mirrored by ops/fused_cuda.py:
// cost_smem_bytes(..., magbin=True), which also routes it).
extern "C" int dm_cost_rows_magbin_smem(int p, int max_d) {
  return pick_layout(p, max_d, true).total;
}

extern "C" int dm_cost_rows_magbin_blocks_per_sm(int p, int max_d, int bf16) {
  return bf16 ? occupancy<true, __nv_bfloat16>(p, max_d)
              : occupancy<true, float>(p, max_d);
}

// left/right: magnitude planes, lbin/rbin: bin planes, all (n, hp, wp) f32;
// out: (n, d0, h0, w0) float (bf16 == 0) or __nv_bfloat16.
extern "C" int dm_cost_rows_magbin(const float* left, const float* right,
                                   const float* lbin, const float* rbin,
                                   void* out, int n, int hp, int wp, int p,
                                   int d0, int max_d, int bf16, void* stream) {
  return dispatch_volume<true>(left, right, lbin, rbin, out, n, hp, wp, p, d0,
                               max_d, bf16, stream);
}
