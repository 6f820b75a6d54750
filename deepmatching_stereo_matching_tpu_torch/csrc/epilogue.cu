// EPI: the LR check, densify and the five pixel outputs of a step in one
// launch (models/pipeline.py:lr_outputs).
//
// Replaces no TPU kernel: the JAX package runs the LR check and densify in
// XLA (deepmatching_stereo_matching_tpu/models/pipeline.py,
// lr_consistency_patch_padded and densify).  It was added because the port
// ran them as 40 torch operations a step (the sentinel pad and its cat,
// int64 column indices, two gathers, bool maps combined one op at a time,
// three repeat_interleave densifies, a float copy, a fill and a zero map
// that were then overwritten): 0.2289 of a 0.5615 ms Middlebury step at
// 32 pairs, and most of the step's host issue.
// In: (n, H0, W0) patch maps: disp int32, score float32 and, with the LR
// check, the R->L disparity disp_r int32.  Out: five (n, H0 p, W0 p)
// maps, bitwise the plain chain (pipeline.lr_consistency_patch, then
// pipeline.pixel_outputs):
//   disparity float32: (float)dL where valid, else invalid_value;
//   disparity_raw int32: dL; valid bool; score float32: the patch's score;
//   disparity_right int32: disp_r's patch value, or 0 without the check.
// Pixel column x = p J + c of patch (i, J) reads dR at patch column J - q
// where c >= r, else J - q - 1, with dL = p q + r (floor division); a
// column left of the map reads the sentinel INT32_MIN / 2, as the plain
// chain's catted pad does.  valid = |dL - dR| <= tau and dL <= x (with the
// check), and score >= min_score (where min_score > 0).  |dL - dR| is
// torch's: an int32 difference and abs that wrap, compared with tau as
// float32 (torch promotes an int32 tensor and a Python float to float32,
// so a difference past 2^24 is rounded, and tau too).  A column that
// reads the sentinel serves only pixels with dL > x, which the check
// rejects anyway: the sentinel never decides a pixel.
//
// Bound by bytes: 12 B a patch read (8 without the check), 17 B a pixel
// written (work.py:epilogue), 17.75 B a pixel at p = 4.  At the Middlebury
// step's 128 pairs (96 x 128 patches, 384 x 512 pixels) 446,693,376 B,
// 0.1333 ms at 3.35 TB/s; at the KITTI step's 32 pairs (96 x 384)
// 0.1000 ms; at the Middlebury 2014 F step's 16 pairs (512 x 768) 0.5334
// ms.  A block takes 128 consecutive patch columns of one pixel row, a
// thread one pixel row of one patch: at p = 4 one 16-byte store for each
// of the four 4-byte maps and one 4-byte store of valid, neighbouring
// threads on neighbouring words, so a warp writes 512 contiguous bytes a
// store.  The p threads of a patch's rows load the same patch words, and
// dR's two reads land beside them; device memory sees each word about
// once, the rest come from the L1 or the L2.  Any other p takes a loop of
// scalar stores.  Offsets are size_t: an F step's maps hold 100.7 M
// elements each.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;
constexpr int kSentinel = -1073741824;      // pipeline._SENTINEL

struct Maps {
  const int* __restrict__ disp;
  const float* __restrict__ score;
  const int* __restrict__ disp_r;           // null without the LR check
  float* __restrict__ out;
  int* __restrict__ raw;
  unsigned char* __restrict__ valid;
  float* __restrict__ score_px;
  int* __restrict__ right;
};

// |a - b| <= tau as torch computes it for int32 maps and a Python float:
// the difference and its abs wrap in int32 (abs(INT32_MIN) stays
// INT32_MIN), then both sides are float32.
__device__ __forceinline__ bool within(int a, int b, float tau) {
  const unsigned d = (unsigned)a - (unsigned)b;
  const unsigned m = (int)d < 0 ? 0u - d : d;
  return __int2float_rn((int)m) <= tau;
}

// dR at patch column j of a row; the sentinel left of the map (and right
// of it, which a disparity in [0, D) never reaches).
__device__ __forceinline__ int right_at(const int* __restrict__ row,
                                        long long j, int w0) {
  return j >= 0 && j < w0 ? __ldg(row + j) : kSentinel;
}

// floor(a / p), as torch.div(..., rounding_mode="floor") takes it in int64
// for either sign.
__device__ __forceinline__ long long floor_div(int a, int p) {
  return a >= 0 ? a / p : -((-(long long)a + p - 1) / p);
}

// P: the patch size, or 0 for a runtime p.  LR: a right map is given.
template <int P, bool LR>
__global__ void __launch_bounds__(kThreads)
lr_outputs_kernel(Maps m, long long rows, int w0, int p_rt, float tau,
                  int use_min, float min_score, float invalid) {
  const int p = P > 0 ? P : p_rt;
  const int J = blockIdx.x * kThreads + threadIdx.x;
  if (J >= w0) return;
  const size_t wp = (size_t)w0 * p;
  for (long long y = blockIdx.y; y < rows; y += gridDim.y) {
    const size_t row0 = (size_t)(y / p) * w0;  // patch row y / p over n H0
    const int dl = __ldg(m.disp + row0 + J);
    const float s = __ldg(m.score + row0 + J);
    // Pixel column c of the patch is valid where c >= r ? ok_a : ok_b and
    // c >= reach (dL <= x, x = J p + c), with the check; and where the
    // score passes.
    bool ok_a = true, ok_b = true;
    int dr = 0;
    long long r = 0, reach = LLONG_MIN;
    if (LR) {
      const int* row = m.disp_r + row0;
      dr = __ldg(row + J);
      const long long q = floor_div(dl, p);
      r = dl - q * p;
      ok_a = within(dl, right_at(row, J - q, w0), tau);
      ok_b = within(dl, right_at(row, J - q - 1, w0), tau);
      reach = (long long)dl - (long long)J * p;
    }
    const bool score_ok = !use_min || s >= min_score;
    const auto valid_at = [&](int c) {
      return score_ok && (c >= r ? ok_a : ok_b) && (long long)c >= reach;
    };
    const float d = __int2float_rn(dl);
    const size_t px = (size_t)y * wp + (size_t)J * p;
    if constexpr (P == 4) {
      const bool v0 = valid_at(0), v1 = valid_at(1), v2 = valid_at(2),
                 v3 = valid_at(3);
      *reinterpret_cast<float4*>(m.out + px) = make_float4(
          v0 ? d : invalid, v1 ? d : invalid, v2 ? d : invalid,
          v3 ? d : invalid);
      *reinterpret_cast<int4*>(m.raw + px) = make_int4(dl, dl, dl, dl);
      *reinterpret_cast<uchar4*>(m.valid + px) = make_uchar4(v0, v1, v2, v3);
      *reinterpret_cast<float4*>(m.score_px + px) = make_float4(s, s, s, s);
      *reinterpret_cast<int4*>(m.right + px) = make_int4(dr, dr, dr, dr);
    } else {
      for (int c = 0; c < p; ++c) {
        const bool v = valid_at(c);
        m.out[px + c] = v ? d : invalid;
        m.raw[px + c] = dl;
        m.valid[px + c] = v;
        m.score_px[px + c] = s;
        m.right[px + c] = dr;
      }
    }
  }
}

template <int P>
void launch(const dim3& grid, cudaStream_t st, const Maps& m, long long rows,
            int w0, int p, float tau, int use_min, float min_score,
            float invalid) {
  if (m.disp_r)
    lr_outputs_kernel<P, true><<<grid, kThreads, 0, st>>>(
        m, rows, w0, p, tau, use_min, min_score, invalid);
  else
    lr_outputs_kernel<P, false><<<grid, kThreads, 0, st>>>(
        m, rows, w0, p, tau, use_min, min_score, invalid);
}

}  // namespace

// disp, disp_r: (n, h0, w0) int32 (disp_r null: no LR check); score:
// (n, h0, w0) float32; out, score_px: (n, h0 p, w0 p) float32; raw, right:
// int32; valid: bool (one byte).  One launch.
extern "C" int dm_lr_outputs(const int* disp, const float* score,
                             const int* disp_r, float* out, int* raw,
                             unsigned char* valid, float* score_px,
                             int* right, int n, int h0, int w0, int p,
                             float tau, int use_min, float min_score,
                             float invalid, void* stream) {
  if (n < 0 || h0 < 0 || w0 < 0 || p < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * h0 * p;  // pixel rows
  if (rows == 0 || w0 == 0) return 0;
  const Maps m{disp, score, disp_r, out, raw, valid, score_px, right};
  const dim3 grid((w0 + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  const cudaStream_t st = (cudaStream_t)stream;
  const int vec = p == 4 && (uintptr_t)out % 16 == 0 &&
                  (uintptr_t)raw % 16 == 0 && (uintptr_t)score_px % 16 == 0 &&
                  (uintptr_t)right % 16 == 0 && (uintptr_t)valid % 4 == 0;
  if (vec)
    launch<4>(grid, st, m, rows, w0, p, tau, use_min, min_score, invalid);
  else
    launch<0>(grid, st, m, rows, w0, p, tau, use_min, min_score, invalid);
  return (int)cudaGetLastError();
}
