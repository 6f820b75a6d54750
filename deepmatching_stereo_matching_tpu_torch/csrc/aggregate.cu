// K5: the level aggregation of a D-major volume, every level in one launch.
//
// Replaces deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:
// _slab_kernel (via _aggregate_slabs / aggregate_slabs).  The TPU kernel
// walks the disparity axis in 32-plane slabs, computes all L levels of a
// slab in one call, threads one lo halo plane per level from slab to slab
// and writes only each level's pool offsets and the top map.  Here that
// sequential slab loop is a loop inside the block.
// In: (n, D0, H0, W0) f32 or bf16.  Out: the top map (n, D0>>L, H0>>L,
// W0>>L) in the same type and the pool offsets of every level l,
// (n, D0>>(l+1), H0>>l, W0>>l) int8 in {-1, 0, 1}, each level at its own
// offset of one buffer (agg_arg_offset, mirrored by
// ops/pyramid_cuda.py:arg_offsets).
//
// Bound on this card by device memory: the volume read once (4 B per
// element, 2 B in bf16), every level's offsets (about half a byte per
// element) and the top map written once; ~7 operations per element of
// each level above 0 are far below the compute roof.  So the design keeps
// every level above 0 on chip, keeps the volume in flight, and keeps the
// upper levels off the stream's path.
//
// One block per (instance, 32 x 32 tile of level-0 cells); a tile holds
// whole quadtrees of up to kMaxLevels = 5 levels, so no merge crosses it.
// The block walks D upward in chunks of kChunk = 32 planes.  Four stream
// warps own the tile, a thread 2 rows x 4 columns (whole quads) and the 2
// level-1 cells they merge to; per plane pair (2k, 2k+1) each thread:
//   1. takes the pair from a ring of kRing pairs in shared memory that
//      cp.async fills kRing - 1 pairs ahead, so every plane of the volume
//      is read once, by 16-byte copies, and no register holds a load in
//      flight.  float32: a thread copies its own four 16-byte words (no
//      barrier).  bf16: a thread's words are 8 bytes, so each lane of a
//      warp copies one 16-byte chunk of the warp's 8 rows x 32 columns and
//      the warp reads them after __syncwarp (8-byte copies streamed the
//      bf16 volume markedly slower);
//   2. level 0, in registers: pools against the previous odd plane, kept
//      in registers (the pad -1.0 below plane 0), stores its 4 offsets a
//      row as one 4-byte store, and merges its quads: level-1 plane k;
//   3. level 1, in registers, on odd k: pools planes k-1 and k against its
//      level-1 halo, stores the offsets (a pair of threads four a store,
//      by a shuffle), and merges each level-1 quad with the row partner's
//      half (lane ^ 8) by one shuffle: level-2 plane k/2, into the chunk's
//      level-2 map (two buffers in shared memory; the top at L = 2).
// A fifth warp, the level warp, runs levels 2..L-1 one chunk behind: each
// level's chunk map pooled against its lo halo plane (the last odd plane
// of the previous chunk, in the level's own domain: before the power in
// fast mode, as pyramid_pallas.py's bounds_out), its offsets stored 4 (at
// level L-1, 2) to a store, merged into the next level's map, the last
// level's merge straight to `top`; then every halo takes the chunk's last
// odd plane.  Named barriers hand the level-2 buffers over ("full" after
// the stream warps' chunk, "free" after the level warp's), so the stream
// warps never wait for the upper levels; with them inline, every chunk
// stopped a block's stream for a few microseconds.  Only the offsets and
// the top map reach device memory.  No block splits D: a split would
// recompute a 32-plane cone of halos (+12.5% reads at D = 256), and at
// KITTI D=256 x 8 instances the 288 blocks already keep the card's memory
// busier than the upper levels let it be.
// 96 registers and 160 threads make 4 blocks per SM; a cap of 80 for a
// fifth spilled, which the gate refuses.
//
// Numerics (bitwise the parent's per-level kernel and
// ops/pyramid_cuda.py:aggregate_dmajor_torch): fmaxf(fmaxf(lo, even),
// odd), ties lo, then even, then odd; the merge ((q00 + q01) + (q10 +
// q11)) * 0.25 with q indexed (row, col); never __powf; fast (a template
// flag, so each instance inlines only its powers): powf on the pooled
// values at every level above 0 (pow_first: at this launch's level 0 too,
// out of line), none at the top; exact: after every merge, correctly
// rounded on float32 maps (pyramid.cuh:pow_rn).
// The bfloat16 instance rounds every op's result to bf16 (pyramid.cuh's
// round_bf16), its maps floats holding bf16 values, with lam as the
// wrapper passes it (1.4 rounded to bf16).
//
// Forms: 16-byte (the ring) where W0 is a multiple of the columns a
// 16-byte load holds (4 f32, 8 bf16) and the volume's base is 16-byte
// aligned, else narrow (element loads into registers, pair and byte
// stores: W0 = 2 mod 4 at L = 1, W0 = 4 mod 8 in bf16, a view off
// alignment).  A tile past H0 or W0 is masked: H0 and W0 are multiples of
// 2^L, so every level's in-range part of a tile is a whole number of its
// merges; out-of-range threads still take part in the shuffles.  More
// than kMaxLevels levels: the wrapper chains launches of at most
// kMaxLevels levels each, the level-5 map of one the volume of the next.
// Every index into device memory is size_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"
#include "pyramid.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 5;           // levels per launch
constexpr int kTile = 1 << kMaxLevels;  // level-0 cells per tile side
constexpr int kChunk = 32;              // level-0 planes per chunk
constexpr int kRing = 4;                // plane pairs in the cp.async ring

// The volume's element type and its thread shape: 4 columns a thread (one
// load of a word W: 16 bytes of f32, 8 of bf16), 8 threads across a tile
// and 16 down.
template <bool BF16>
struct Elem {
  using T = std::conditional_t<BF16, __nv_bfloat16, float>;
  using W = std::conditional_t<BF16, uint2, uint4>;
  static constexpr int kV = 4;
  static constexpr int kCols = kTile / kV;
  static constexpr int kStream = kCols * (kTile / 2);  // the stream warps
  static constexpr int kThreads = kStream + 32;        // and the level warp
  // The ring: kRing pairs x 4 words (2 planes x 2 rows) a thread.
  static constexpr int kRingBytes = kRing * 4 * (int)sizeof(W) * kStream;
};

// Shared memory of one block after the ring, in floats: two buffers of
// the level-2 chunk map ((kChunk >> 2) planes of (kTile >> 2)^2 cells;
// chunk c in buffer c % 2), then the chunk map of each level l in 3..L-1,
// then the lo halo (one plane) of each level in 2..L-1.  Every part is a
// multiple of 4 floats (16-byte aligned).
__host__ __device__ constexpr int agg_map_floats(int l) {
  return (kChunk >> l) * (kTile >> l) * (kTile >> l);
}
__host__ __device__ constexpr int agg_halo_floats(int l) {
  return (kTile >> l) * (kTile >> l);
}
__host__ __device__ inline int agg_map_off(int l) {  // l >= 3
  int o = 2 * agg_map_floats(2);
  for (int m = 3; m < l; ++m) o += agg_map_floats(m);
  return o;
}
__host__ __device__ inline int agg_halo_off(int levels, int l) {
  int o = agg_map_off(levels);
  for (int m = 2; m < l; ++m) o += agg_halo_floats(m);
  return o;
}
template <bool BF16>
__host__ __device__ inline int agg_smem_bytes(int levels) {
  return Elem<BF16>::kRingBytes +
         4 * (levels > 2 ? agg_halo_off(levels, levels) : 0);
}

// Byte offset of level l's offsets in the one int8 buffer: each level's
// (n, d0>>(l+1), h0>>l, w0>>l) bytes, rounded up to 16.
__host__ __device__ inline size_t agg_arg_offset(int n, int d0, int h0,
                                                 int w0, int l) {
  size_t o = 0;
  for (int m = 0; m < l; ++m)
    o += ((size_t)n * (d0 >> (m + 1)) * (h0 >> m) * (w0 >> m) + 15) &
         ~(size_t)15;
  return o;
}

struct ArgPtrs {
  int8_t* p[kMaxLevels];
};

// Element c of a thread's row (its 4 columns in one word), widened
// exactly to float.
__device__ __forceinline__ float elem(const uint4& u, int c) {
  return __uint_as_float(c == 0 ? u.x : c == 1 ? u.y : c == 2 ? u.z : u.w);
}
__device__ __forceinline__ float elem(const uint2& u, int c) {
  const unsigned w = c < 2 ? u.x : u.y;
  return __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
}

// One plane's two rows at `p` (row y, column x), one element at a time
// where the column pair is in range (the narrow form).
template <bool BF16>
__device__ __forceinline__ void load_narrow(
    const typename Elem<BF16>::T* p, int w0, int pairs_in,
    typename Elem<BF16>::W (&raw)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const typename Elem<BF16>::T* q = p + (size_t)r * w0;
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c / 2 >= pairs_in) break;
      if constexpr (BF16) {
        const unsigned h =
            __ldg(reinterpret_cast<const unsigned short*>(q + c));
        w[c / 2] |= (c & 1) ? (h << 16) : h;
      } else {
        w[c] = __float_as_uint(__ldg(q + c));
      }
    }
    if constexpr (BF16) {
      raw[r] = make_uint2(w[0], w[1]);
    } else {
      raw[r] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// 16 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async(uint4* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// x^lam, rounded to bf16 in the BF16 instance; EXACT (the exact mode's
// power after a merge) correctly rounded on float32 maps.
template <bool BF16, bool EXACT = false>
__device__ __forceinline__ float rect(float x, float lam) {
  if constexpr (BF16) {
    return dm::round_bf16(powf(x, lam));
  } else if constexpr (EXACT) {
    return dm::pow_rn(x, lam);
  } else {
    return powf(x, lam);
  }
}

// x^lam for the power on a chained launch's level-0 pool: out of line, so
// the hot loop inlines only the powers of its mode.
template <bool BF16>
__device__ __noinline__ float rect_first(float x, float lam) {
  return rect<BF16>(x, lam);
}

// a + b and x * 0.25, rounded to bf16 in the BF16 instance.
template <bool BF16>
__device__ __forceinline__ float add(float a, float b) {
  if constexpr (BF16) {
    return dm::round_bf16(__fadd_rn(a, b));
  } else {
    return __fadd_rn(a, b);
  }
}
template <bool BF16>
__device__ __forceinline__ float quarter(float x) {
  if constexpr (BF16) {
    return dm::round_bf16(__fmul_rn(x, 0.25f));
  } else {
    return __fmul_rn(x, 0.25f);
  }
}

// ((q0 + q1) + (q2 + q3)) * 0.25, every result rounded to bf16 in BF16.
template <bool BF16>
__device__ __forceinline__ float quad_mean(float q0, float q1, float q2,
                                           float q3) {
  return quarter<BF16>(add<BF16>(add<BF16>(q0, q1), add<BF16>(q2, q3)));
}

// Pool one cell: returns the pooled value and its offset code as a byte.
__device__ __forceinline__ float pool3(float lo, float ev, float od,
                                       uint32_t& code) {
  const float p = fmaxf(fmaxf(lo, ev), od);
  code = p == lo ? 0xffu : (p == ev ? 0u : 1u);
  return p;
}

// Named barriers between the stream warps and the level warp, for level-2
// buffer `buf`: kFullBar + buf, "full", and kFreeBar + buf, "free again".
// The ids are immediates, so ptxas reserves only these.
constexpr int kFullBar = 1, kFreeBar = 3;
template <int ID>
__device__ __forceinline__ void bar_sync(int count) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(count) : "memory");
}
template <int ID>
__device__ __forceinline__ void bar_arrive(int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int base, int buf, int count) {
  if (base == kFullBar) {
    buf ? bar_sync<kFullBar + 1>(count) : bar_sync<kFullBar>(count);
  } else {
    buf ? bar_sync<kFreeBar + 1>(count) : bar_sync<kFreeBar>(count);
  }
}
__device__ __forceinline__ void bar_arrive(int base, int buf, int count) {
  if (base == kFullBar) {
    buf ? bar_arrive<kFullBar + 1>(count) : bar_arrive<kFullBar>(count);
  } else {
    buf ? bar_arrive<kFreeBar + 1>(count) : bar_arrive<kFreeBar>(count);
  }
}

__device__ __forceinline__ void store_top(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_top(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // v holds a bf16 value: exact
}

// Levels 2..L-1 of chunk `ci` (planes c0 .. c0 + depth) of one tile, by
// the level warp: from the level-2 map in buffer ci % 2 up, each level
// pooled against its halo, its offsets stored, merged into the next map or
// the top; then every halo takes the chunk's last odd plane.
template <bool BF16, bool FAST>
__device__ void upper_levels(float* sm, typename Elem<BF16>::T* top,
                             const ArgPtrs& args, int b, int ci, int c0,
                             int depth, int d0, int h0, int w0, int y0,
                             int x0, int rows_in, int cols_in, int levels,
                             float lam) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 2; l < kMaxLevels; ++l) {
    if (l >= levels) break;
    const int sl = kTile >> l, hs = sl >> 1;
    const int P = levels - l >= 2 ? 2 : 1;  // parents an item merges
    const int groups = hs / P, npairs = depth >> (l + 1);
    const int items = npairs * hs * groups;
    const float* map =
        sm + (l == 2 ? (ci & 1) * agg_map_floats(2) : agg_map_off(l));
    const float* halo = sm + agg_halo_off(levels, l);
    const int hl = h0 >> l, wl = w0 >> l, knl = d0 >> (l + 1);
    const size_t plane_l = (size_t)hl * wl;
    const bool last = l + 1 == levels;
    for (int e = lane; e < items; e += 32) {
      const int J = e % groups, r2 = e / groups;
      const int I = r2 % hs, k = r2 / hs;
      if (2 * I >= (rows_in >> l) || 2 * P * J >= (cols_in >> l)) continue;
      float pooled[2][4];
      uint32_t pack[2] = {0u, 0u};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= 2 * P) break;
          const int cell = (2 * I + r) * sl + 2 * P * J + c;
          const float lo =
              k > 0 ? map[(2 * k - 1) * sl * sl + cell] : halo[cell];
          const float ev = map[(2 * k) * sl * sl + cell];
          const float od = map[(2 * k + 1) * sl * sl + cell];
          uint32_t code;
          float p = pool3(lo, ev, od, code);
          if (FAST) p = rect<BF16>(p, lam);
          pooled[r][c] = p;
          pack[r] |= code << (8 * c);
        }
        int8_t* a = args.p[l] +
                    ((size_t)b * knl + (c0 >> (l + 1)) + k) * plane_l +
                    (size_t)((y0 >> l) + 2 * I + r) * wl + (x0 >> l) +
                    2 * P * J;
        if (P == 2) {
          *reinterpret_cast<uint32_t*>(a) = pack[r];
        } else {
          *reinterpret_cast<uint16_t*>(a) = (uint16_t)pack[r];
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p >= P) break;
        float m = quad_mean<BF16>(pooled[0][2 * p], pooled[0][2 * p + 1],
                                  pooled[1][2 * p], pooled[1][2 * p + 1]);
        if (!FAST) m = rect<BF16, true>(m, lam);
        if (last) {
          const int ht = h0 >> levels, wt = w0 >> levels;
          store_top(top +
                        ((size_t)b * (d0 >> levels) + (c0 >> levels) + k) *
                            ((size_t)ht * wt) +
                        (size_t)((y0 >> levels) + I) * wt + (x0 >> levels) +
                        P * J + p,
                    m);
        } else {
          sm[agg_map_off(l + 1) + (k * hs + I) * hs + P * J + p] = m;
        }
      }
    }
    __syncwarp();
  }
  // Every level's lo halo: the chunk's last odd plane.
#pragma unroll
  for (int l = 2; l < kMaxLevels; ++l) {
    if (l >= levels) break;
    const float* lastodd =
        sm + (l == 2 ? (ci & 1) * agg_map_floats(2) : agg_map_off(l)) +
        ((depth >> l) - 1) * agg_halo_floats(l);
    for (int c = lane; c < agg_halo_floats(l); c += 32)
      sm[agg_halo_off(levels, l) + c] = lastodd[c];
  }
  __syncwarp();
}

template <bool BF16, bool VEC, bool FAST>
__global__ void __launch_bounds__(Elem<BF16>::kThreads)
aggregate_kernel(const typename Elem<BF16>::T* __restrict__ vol,
                 typename Elem<BF16>::T* __restrict__ top, ArgPtrs args,
                 int tiles_w, int tiles, int d0, int h0, int w0, int levels,
                 int pow_first, float lam) {
  using T = typename Elem<BF16>::T;
  using W = typename Elem<BF16>::W;
  constexpr int kV = Elem<BF16>::kV, kCols = Elem<BF16>::kCols;
  constexpr int kNT = Elem<BF16>::kStream, kAll = Elem<BF16>::kThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4) + Elem<BF16>::kRingBytes / 4;

  const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
  const int y0 = (t / tiles_w) * kTile, x0 = (t % tiles_w) * kTile;
  const int rows_in = min(kTile, h0 - y0), cols_in = min(kTile, w0 - x0);
  const int tid = threadIdx.x;

  if (tid >= kNT) {  // the level warp: levels 2..L-1, a chunk behind
    if (levels <= 2) return;
#pragma unroll
    for (int l = 2; l < kMaxLevels; ++l) {
      if (l >= levels) break;
      for (int c = tid - kNT; c < agg_halo_floats(l); c += 32)
        sm[agg_halo_off(levels, l) + c] = -1.0f;
    }
    const int chunks = (d0 + kChunk - 1) / kChunk;
    for (int ci = 0; ci < chunks; ++ci) {
      const int c0 = ci * kChunk;
      bar_sync(kFullBar, ci & 1, kAll);
      upper_levels<BF16, FAST>(sm, top, args, b, ci, c0,
                               min(kChunk, d0 - c0), d0, h0, w0, y0, x0,
                               rows_in, cols_in, levels, lam);
      if (ci + 2 < chunks) bar_arrive(kFreeBar, ci & 1, kAll);  // chunk ci + 2
    }
    return;
  }

  // The stream warps: levels 0 and 1.
  const int tx = tid % kCols, ty = tid / kCols;
  const int y = y0 + 2 * ty, x = x0 + kV * tx;
  const int kn = d0 >> 1;
  // Column pairs of this thread inside the volume (VEC: all or none).
  const int pairs_in = y < h0 ? min(kV / 2, max(0, (w0 - x) / 2)) : 0;
  const size_t plane = (size_t)h0 * w0;
  const T* src = vol + (size_t)b * d0 * plane + (size_t)y * w0 + x;

  // The ring (VEC): pair k in slot k % kRing.  float32: each thread copies
  // its own four words (plane 2k + i / 2, row i % 2) to slot * 4 * kNT +
  // i * kNT + tid, so a warp's words are adjacent.  bf16: a warp's 8 rows
  // x 32 columns of a plane are 32 chunks of 16 bytes, one per lane (row
  // lane / 4, chunk lane % 4), and a thread reads its 8-byte words from the
  // warp's chunks after __syncwarp.
  const int wid = tid >> 5, lane = tid & 31;
  const T* chunk_src;  // bf16: this lane's chunk of plane 0
  bool chunk_in = false;
  if constexpr (BF16) {
    const int row = y0 + 8 * wid + (lane >> 2), col = x0 + 8 * (lane & 3);
    chunk_in = row < h0 && col < w0;
    chunk_src = vol + (size_t)b * d0 * plane + (size_t)row * w0 + col;
  }
  const T* next = src;  // plane 2k of the next pair to issue
  if constexpr (BF16) next = chunk_src;
  int issued = 0;
  auto issue = [&]() {
    if (issued < kn) {
      const int s = issued % kRing;
      if constexpr (BF16) {
        if (chunk_in) {
          uint4* slot = reinterpret_cast<uint4*>(smem4) +
                        (s * (kNT / 32) + wid) * 64 + lane;
          cp_async(slot, next);
          cp_async(slot + 32, next + plane);
        }
      } else if (pairs_in > 0) {
        W* slot = reinterpret_cast<W*>(smem4) + s * 4 * kNT + tid;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async(slot + i * kNT, next + (i / 2) * plane + (i & 1) * w0);
      }
      next += 2 * plane;
    }
    ++issued;
    cp_async_commit();
  };
  auto take = [&](int k, W (&cur)[2][2]) {  // pair k from the ring
    const int s = k % kRing;
    if constexpr (BF16) {
      const uint2* blk = reinterpret_cast<const uint2*>(smem4) +
                         (s * (kNT / 32) + wid) * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cur[i / 2][i & 1] =
            blk[(i / 2) * 64 + (2 * (ty & 3) + (i & 1)) * 8 + tx];
    } else {
      const W* slot = reinterpret_cast<const W*>(smem4) + s * 4 * kNT + tid;
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i / 2][i & 1] = slot[i * kNT];
    }
  };
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < kRing - 1; ++k) issue();
  }

  float prev[2][kV];  // the previous odd plane: level 0's lo halo
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < kV; ++c) prev[r][c] = -1.0f;
  float lo1[kV / 2], ev1[kV / 2];  // level 1's lo halo and even plane
#pragma unroll
  for (int c = 0; c < kV / 2; ++c) lo1[c] = ev1[c] = -1.0f;
  const bool even_row = (ty & 1) == 0;
  // Output pointers at pair 0, advanced as the walk goes.
  int8_t* a0 = args.p[0] + (size_t)b * kn * plane + (size_t)y * w0 + x;
  int8_t* a1 = levels > 1 ? args.p[1] + (size_t)b * (d0 >> 2) * (plane >> 2) +
                                (size_t)(y >> 1) * (w0 >> 1) + (x >> 1)
                          : nullptr;

  for (int c0 = 0, ci = 0; c0 < d0; c0 += kChunk, ++ci) {
    const int depth = min(kChunk, d0 - c0);  // a multiple of 2^levels
    // Level-2 buffer ci % 2 is free once the level warp is done with chunk
    // ci - 2.
    if (levels > 2 && ci >= 2) bar_sync(kFreeBar, ci & 1, kAll);
    float* map2 = sm + (ci & 1) * agg_map_floats(2);
    for (int kk = 0; kk < depth / 2; ++kk, a0 += plane) {
      const int k = (c0 >> 1) + kk;
      W cur[2][2] = {};  // [plane 2k, 2k + 1][row]
      if constexpr (VEC) {
        if constexpr (BF16) __syncwarp();  // the slot issued next is read
        issue();
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
        if constexpr (BF16) __syncwarp();  // every lane's chunks landed
        take(k, cur);
      } else {
        if (pairs_in > 0) {
          load_narrow<BF16>(src + (size_t)(2 * k) * plane, w0, pairs_in,
                            cur[0]);
          load_narrow<BF16>(src + (size_t)(2 * k + 1) * plane, w0, pairs_in,
                            cur[1]);
        }
      }
      // 1. Level 0: pool, store the offsets, merge the quads.
      float pooled[2][kV];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t pack = 0u;
#pragma unroll
        for (int c = 0; c < kV; ++c) {
          const float ev = elem(cur[0][r], c);
          const float od = elem(cur[1][r], c);
          uint32_t code;
          float p = pool3(prev[r][c], ev, od, code);
          if (pow_first) p = rect_first<BF16>(p, lam);
          pooled[r][c] = p;
          prev[r][c] = od;
          pack |= code << (8 * c);
        }
        int8_t* a = a0 + (size_t)r * w0;
        if constexpr (VEC) {
          if (pairs_in > 0) *reinterpret_cast<uint32_t*>(a) = pack;
        } else {
#pragma unroll
          for (int c = 0; c < kV; c += 2) {
            if (c / 2 >= pairs_in) break;
            *reinterpret_cast<uint16_t*>(a + c) = (uint16_t)(pack >> (8 * c));
          }
        }
      }
      float m1[kV / 2];
#pragma unroll
      for (int c = 0; c < kV / 2; ++c) {
        m1[c] = quad_mean<BF16>(pooled[0][2 * c], pooled[0][2 * c + 1],
                                pooled[1][2 * c], pooled[1][2 * c + 1]);
        if (!FAST) m1[c] = rect<BF16, true>(m1[c], lam);
      }
      if (levels == 1) {  // level 1 is the top
        T* o = top + ((size_t)b * kn + k) * (plane >> 2) +
               (size_t)(y >> 1) * (w0 >> 1) + (x >> 1);
#pragma unroll
        for (int c = 0; c < kV / 2; ++c)
          if (c < pairs_in) store_top(o + c, m1[c]);
        continue;
      }
      if ((kk & 1) == 0) {  // level-1 plane k is even: keep it
#pragma unroll
        for (int c = 0; c < kV / 2; ++c) ev1[c] = m1[c];
        continue;
      }
      // 2. Level 1: pool planes k - 1, k against the halo, store the
      // offsets, merge the level-1 quads with the row partner.
      float p1[kV / 2];
      uint32_t pack1 = 0u;
#pragma unroll
      for (int c = 0; c < kV / 2; ++c) {
        uint32_t code;
        p1[c] = pool3(lo1[c], ev1[c], m1[c], code);
        if (FAST) p1[c] = rect<BF16>(p1[c], lam);
        lo1[c] = m1[c];
        pack1 |= code << (8 * c);
      }
      if constexpr (VEC) {
        // Two cells a thread; at L >= 3 a pair of threads stores four.
        const uint32_t other = __shfl_xor_sync(kFull, pack1, 1);
        if (levels >= 3) {
          if (pairs_in > 0 && (tx & 1) == 0)
            *reinterpret_cast<uint32_t*>(a1) = pack1 | (other << 16);
        } else if (pairs_in > 0) {
          *reinterpret_cast<uint16_t*>(a1) = (uint16_t)pack1;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kV / 2; ++c)
          if (c < pairs_in) a1[c] = (int8_t)(pack1 >> (8 * c));
      }
      a1 += plane >> 2;
      // Row sums of the level-1 quads, the partner row's by shuffle.
      const float mine = add<BF16>(p1[0], p1[1]);
      const float other = __shfl_xor_sync(kFull, mine, kCols);
      float m2 = quarter<BF16>(
          add<BF16>(even_row ? mine : other, even_row ? other : mine));
      if (!FAST) m2 = rect<BF16, true>(m2, lam);
      if (even_row && pairs_in > 0) {
        if (levels == 2) {  // level 2 is the top
          store_top(top + ((size_t)b * (d0 >> 2) + (k >> 1)) * (plane >> 4) +
                        (size_t)(y >> 2) * (w0 >> 2) + (x >> 2),
                    m2);
        } else {
          map2[((kk >> 1) * (kTile / 4) + (ty >> 1)) * (kTile / 4) +
               ((x - x0) >> 2)] = m2;
        }
      }
    }
    if (levels > 2) bar_arrive(kFullBar, ci & 1, kAll);  // buffer ci is full
  }
}

template <bool BF16, bool VEC, bool FAST>
dm::SmemAllowance& allowance() {
  static dm::SmemAllowance a((const void*)aggregate_kernel<BF16, VEC, FAST>);
  return a;
}

template <bool BF16, bool VEC, bool FAST>
int launch(const void* vol, void* top, int8_t* arg, int n, int d0, int h0,
           int w0, int levels, int pow_first, float lam,
           cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const int smem = agg_smem_bytes<BF16>(levels);
  const cudaError_t err = allowance<BF16, VEC, FAST>().allow(smem);
  if (err != cudaSuccess) return (int)err;
  ArgPtrs args;
  for (int l = 0; l < kMaxLevels; ++l)
    args.p[l] = l < levels ? arg + agg_arg_offset(n, d0, h0, w0, l) : nullptr;
  const int tiles_w = (w0 + kTile - 1) / kTile;
  const int tiles = ((h0 + kTile - 1) / kTile) * tiles_w;
  const long long blocks = (long long)n * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0 || d0 == 0) return (int)cudaSuccess;
  aggregate_kernel<BF16, VEC, FAST>
      <<<(unsigned)blocks, Elem<BF16>::kThreads, smem, stream>>>(
          static_cast<const T*>(vol), static_cast<T*>(top), args, tiles_w,
          tiles, d0, h0, w0, levels, pow_first, lam);
  return (int)cudaGetLastError();
}

// The 16-byte form: W0 a multiple of the columns one 16-byte load holds
// (4 f32, 8 bf16) and a 16-byte aligned base.
template <bool BF16>
bool vec_form(const void* vol, int w0) {
  return w0 % (16 / (int)sizeof(typename Elem<BF16>::T)) == 0 &&
         reinterpret_cast<uintptr_t>(vol) % 16 == 0;
}

template <bool BF16>
int launch_form(const void* vol, void* top, int8_t* arg, int n, int d0,
                int h0, int w0, int levels, int fast, int pow_first,
                float lam, cudaStream_t stream) {
  const bool vec = vec_form<BF16>(vol, w0);
  if (fast)
    return vec ? launch<BF16, true, true>(vol, top, arg, n, d0, h0, w0,
                                          levels, pow_first, lam, stream)
               : launch<BF16, false, true>(vol, top, arg, n, d0, h0, w0,
                                           levels, pow_first, lam, stream);
  return vec ? launch<BF16, true, false>(vol, top, arg, n, d0, h0, w0, levels,
                                         pow_first, lam, stream)
             : launch<BF16, false, false>(vol, top, arg, n, d0, h0, w0,
                                          levels, pow_first, lam, stream);
}

template <bool BF16, bool VEC, bool FAST>
int occupancy(int levels) {
  return dm::blocks_per_sm(allowance<BF16, VEC, FAST>(),
                           (const void*)aggregate_kernel<BF16, VEC, FAST>,
                           Elem<BF16>::kThreads, agg_smem_bytes<BF16>(levels));
}

template <bool BF16>
int occupancy(int levels, int fast) {
  return fast ? occupancy<BF16, true, true>(levels)
              : occupancy<BF16, true, false>(levels);
}

}  // namespace

// Shared memory of one block of the float32 (bf16 == 0) or bf16 instance
// at `levels` (<= 5; mirrored by ops/pyramid_cuda.py:aggregate_smem_bytes).
extern "C" int dm_aggregate_smem(int levels, int bf16) {
  return bf16 ? agg_smem_bytes<true>(levels) : agg_smem_bytes<false>(levels);
}

// Blocks of the 16-byte form of one instance (bf16, fast mode) one SM
// holds at `levels`; negative: a CUDA error.
extern "C" int dm_aggregate_blocks_per_sm(int levels, int bf16, int fast) {
  return bf16 ? occupancy<true>(levels, fast) : occupancy<false>(levels, fast);
}

// vol: float (bf16 == 0) or __nv_bfloat16 (n, d0, h0, w0); top the same
// type (n, d0>>levels, h0>>levels, w0>>levels); arg the offsets of levels
// 0..levels-1 at agg_arg_offset.  levels in 1..5; fast: the deferred
// power; pow_first: the power on this launch's level-0 pool too (fast
// mode, a launch that starts above level 0).
extern "C" int dm_aggregate(const void* vol, void* top, int8_t* arg, int n,
                            int d0, int h0, int w0, int levels, int fast,
                            int pow_first, float lam, int bf16,
                            void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_form<true>(vol, top, arg, n, d0, h0, w0, levels, fast,
                                  pow_first, lam, st)
              : launch_form<false>(vol, top, arg, n, d0, h0, w0, levels, fast,
                                   pow_first, lam, st);
}
