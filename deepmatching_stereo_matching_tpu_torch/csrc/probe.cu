// P1-P3: the streaming mul/add probes.
//
// Replace tools/vpu_ceiling.py:59 kernel (P1, the pure stream), :120
// small_kernel (P2, the small-array form) and :165 shift_kernel (P3, one
// operand of every product read at a lane offset).  Each computes, for
// every output element, over 64 planes d:
//
//   plane(d) = a[j1]*a[j2] + a[j1']*a[j2'] + ... (4 products) ; total += plane
//
// with the operand schedules of the TPU probes (PAIRS / TRIPS in
// ops/probe_cuda.py), and repeats that work as the TPU grid did.
//
// What bounds it on this card: the float32 pipes.  The loop holds the
// mul/add mix and the on-chip operand reads a TPU grid step makes, so the
// time is the rate of that mix.  The design keeps it so:
//   * every product and sum is __fmul_rn / __fadd_rn, in the TPU order
//     (products left to right into the plane, then total += plane): nvcc
//     cannot contract them into FMA, so the instruction mix is the TPU's,
//     4 mul + 3 add + 1 add per plane, and the kernel is bitwise equal to
//     its plain version.  Without FMA the pipes' ceiling is half the
//     published 67 TFLOP/s, which counts an FMA as two operations;
//   * nothing can be merged.  A block stages its row of the 32 input
//     planes in shared memory once; every repetition reads its operands
//     there again through volatile loads, as every TPU grid step read
//     them from VMEM, and stores its total through a volatile store, so
//     no repetition can be hoisted, merged or dropped.  P1 and P2 read
//     each operand twice, once for the first factor's role and once for
//     the second's: the schedule holds 27 pairs that are another pair
//     reversed (a[x]*a[y] and a[y]*a[x]), which the compiler merged when
//     both came from the same registers (231 of 256 multiplies left in
//     SASS).  P3 reads each distinct (plane, lane offset) window once a
//     repetition and each product's aligned operand once, as the TPU
//     probe's window memo did (88 + 31 reads);
//   * each thread runs `inner` repetitions; the other repetitions run in
//     more blocks (blockIdx.y) that write identical values to the same
//     output, as the TPU grid's steps did, so each input row is read once
//     per block copy from L2 (the wrapper's `l2_bytes`).
//
// P3's schedule (the mix per repetition above unchanged: 256 FMUL, 255
// FADD, 119 volatile shared loads, one volatile store).  A repetition
// keeps ~119 operands live (31 aligned, 88 windows reused 88 and 176
// products later), so registers allow at most four blocks of 128 threads
// per SM, and a block that staged its row synchronously before its
// repetitions left its warps idle through every staging.  So P3 runs
// persistent blocks, four per SM, each walking the (row, copy) items of
// the grid the TPU probe had: while one item's `inner` repetitions read
// one 20 KB row buffer, the next item's row arrives in the other by
// 16-byte cp.async, without registers.  No block walks more than
// ceil(items / resident blocks) items (512 blocks of six at the full
// repetitions on 132 SMs).  A cap of 128 registers (four blocks by
// __launch_bounds__) spilled; at the bound of three, ptxas takes 117 and
// four blocks fit all the same.
//
// Shapes are the TPU probes': P1 (32, 384, 128) -> (384, 128); P2 the
// same input, rows [:96] -> (96, 128); P3 (32, 192, 160) -> (192, 128).

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kSrc = 32, kPlanes = 64, kW0 = 128;
constexpr int kRows = 384, kRowsSmall = 96, kRowsShift = 192, kWShift = 160;

// tools/vpu_ceiling.py:54-55 (pairs) and :161-162 (trips), for k in
// [0, 256): product i of plane d is k = 4 d + i.
__device__ constexpr int pair_j1(int k) { return (5 * k + 1) % 31; }
__device__ constexpr int pair_j2(int k) { return ((3 * k + 7) % 29) + 3; }
__device__ constexpr int trip_j2(int k) { return ((3 * k + 7) % 8) + 3; }
__device__ constexpr int trip_o(int k) { return ((7 * k + 3) % 11) + 1; }

// P3's window (trip_j2, trip_o) depends on k mod 8 and k mod 11 only
// (3 and 7 are units mod 8 and 11), so on k mod 88: products 0..87 read
// the 88 distinct windows, and product k reads product k % 88's.
constexpr int kWindows = 88;

// Row `row` of the 32 planes of a (32, rows, width) input into `win`.
__device__ void stage_row(const float* __restrict__ a, float* win, int rows,
                          int width, int row) {
  for (int i = threadIdx.x; i < kSrc * width; i += blockDim.x) {
    const int j = i / width, col = i - j * width;
    win[i] = a[((size_t)j * rows + row) * width + col];
  }
  __syncthreads();
}

// The 64 planes' total from the products' operands, in the TPU order.
template <typename Lhs, typename Rhs>
__device__ __forceinline__ float planes(Lhs lhs, Rhs rhs) {
  float total = 0.0f;
#pragma unroll
  for (int d = 0; d < kPlanes; ++d) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * d + i;
      const float t = __fmul_rn(lhs(k), rhs(k));
      acc = i == 0 ? t : __fadd_rn(acc, t);
    }
    total = d == 0 ? acc : __fadd_rn(total, acc);
  }
  return total;
}

// P1 / P2: one block per row of rows [0, ROWS) of a (32, 384, 128) input.
template <int ROWS>
__global__ void __launch_bounds__(kW0)
stream_kernel(const float* __restrict__ a, float* __restrict__ out,
              int inner) {
  __shared__ float win[kSrc * kW0];
  const int row = blockIdx.x, c = threadIdx.x;
  stage_row(a, win, kRows, kW0, row);
  const volatile float* v = win;
  volatile float* dst = out + row * kW0 + c;
#pragma unroll 1
  for (int r = 0; r < inner; ++r) {
    float x1[kSrc], x2[kSrc];   // the first and the second factor's reads
#pragma unroll
    for (int j = 0; j < kSrc; ++j) {
      if (j < 31) x1[j] = v[j * kW0 + c];     // pair_j1 in [0, 31)
      if (j >= 3) x2[j] = v[j * kW0 + c];     // pair_j2 in [3, 32)
    }
    *dst = planes([&](int k) { return x1[pair_j1(k)]; },
                  [&](int k) { return x2[pair_j2(k)]; });
  }
}

// P3: persistent blocks; item i of `items` is row i % 192 of a (32, 192,
// 160) input, `inner` repetitions of it; thread c computes column c of
// the (192, 128) output.
constexpr int kShiftMinBlocks = 3;                  // see the note above
constexpr int kShiftRow = kSrc * kWShift;           // floats of one row
constexpr int kShiftSmem = 2 * kShiftRow * 4;       // two row buffers

// Row `row` of the 32 planes into `win` by 16-byte cp.async, committed as
// one group.
__device__ __forceinline__ void stage_row_async(const float* __restrict__ a,
                                                float* win, int row) {
  constexpr int kChunks = kWShift / 4;
  for (int i = threadIdx.x; i < kSrc * kChunks; i += blockDim.x) {
    const int j = i / kChunks, q = i - j * kChunks;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(win + j * kWShift +
                                                        4 * q)),
                 "l"(a + ((size_t)j * kRowsShift + row) * kWShift + 4 * q));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kW0, kShiftMinBlocks)
shift_kernel(const float* __restrict__ a, float* __restrict__ out,
             int inner, int items) {
  extern __shared__ float4 shift_smem[];
  float* rows = reinterpret_cast<float*>(shift_smem);
  const int c = threadIdx.x;
  int item = blockIdx.x;
  stage_row_async(a, rows, item % kRowsShift);
#pragma unroll 1
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < items) {
      stage_row_async(a, rows + ((it + 1) & 1) * kShiftRow, next % kRowsShift);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);  // an empty group
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this item's
    __syncthreads();
    const volatile float* v = rows + (it & 1) * kShiftRow;
    volatile float* dst = out + (item % kRowsShift) * kW0 + c;
#pragma unroll 1
    for (int r = 0; r < inner; ++r) {
      float x[kSrc], w[kWindows];
#pragma unroll
      for (int j = 0; j < 31; ++j) x[j] = v[j * kWShift + c];  // offset 0
      *dst = planes(
          [&](int k) { return x[pair_j1(k)]; },   // trips' j1 is pairs' j1
          [&](int k) {
            if (k < kWindows)
              w[k] = v[trip_j2(k) * kWShift + c + trip_o(k)];
            return w[k % kWindows];
          });
    }
    __syncthreads();  // every thread is done with this buffer
  }
}

dm::SmemAllowance& shift_allowance() {
  static dm::SmemAllowance a((const void*)shift_kernel);
  return a;
}

// Blocks of one P3 launch over `items` items: the card's resident blocks,
// trimmed to those that the fewest rounds of items need; negative: a CUDA
// error.
int shift_grid(int items) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int per_sm = dm::blocks_per_sm(shift_allowance(),
                                       (const void*)shift_kernel, kW0,
                                       kShiftSmem);
  if (per_sm <= 0) return per_sm < 0 ? per_sm : -(int)cudaErrorInvalidValue;
  const int slots = sms * per_sm;
  const int each = (items + slots - 1) / slots;
  return (items + each - 1) / each;
}

template <int ROWS>
int launch_stream(const float* a, float* out, int inner, int copies,
                  void* stream) {
  const dim3 grid(ROWS, copies);
  stream_kernel<ROWS><<<grid, kW0, 0, (cudaStream_t)stream>>>(a, out, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// Every launch runs `inner` repetitions per thread in `copies` block
// copies: inner * copies repetitions in all.
extern "C" int dm_probe_stream(const float* a, float* out, int inner,
                               int copies, void* stream) {
  return launch_stream<kRows>(a, out, inner, copies, stream);
}

extern "C" int dm_probe_small(const float* a, float* out, int inner,
                              int copies, void* stream) {
  return launch_stream<kRowsSmall>(a, out, inner, copies, stream);
}

extern "C" int dm_probe_shift(const float* a, float* out, int inner,
                              int copies, void* stream) {
  const int items = kRowsShift * copies;
  if (items <= 0) return (int)cudaSuccess;
  const int grid = shift_grid(items);
  if (grid < 0) return -grid;
  shift_kernel<<<grid, kW0, kShiftSmem, (cudaStream_t)stream>>>(a, out, inner,
                                                                items);
  return (int)cudaGetLastError();
}

// P3's blocks per SM (the occupancy calculator) and the blocks of a launch
// of `copies` copies; negative: a CUDA error.
extern "C" int dm_probe_shift_blocks_per_sm() {
  return dm::blocks_per_sm(shift_allowance(), (const void*)shift_kernel, kW0,
                           kShiftSmem);
}

extern "C" int dm_probe_shift_grid(int copies) {
  return shift_grid(kRowsShift * copies);
}
