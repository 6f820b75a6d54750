#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits nonzero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds csrc/*.cu from this checkout, one process per
     source; ptxas reports each kernel's registers, shared memory, spills,
     and the eight fused_kernel instances (p = 4 and runtime p, patch and
     magbin, float32 and bfloat16), the six costvol_kernel instances
     (D-major and rows, 16-byte and 4-byte staging, in float32; D-major in
     bfloat16), the four costrows_kernel instances (p = 4 and runtime p,
     float32 and bfloat16 volumes) and the four costrows_magbin_kernel
     (K4b) instances, the two pyramid_kernel instances, the
     eight aggregate_kernel instances (float32 and bfloat16, 16-byte and
     narrow form, fast and exact) and the three probe kernels must spill
     nothing;
  3. kernel vs plain PyTorch version on the card, at full width:
     - bench shapes (450x375, D=64 -> padded 384x512, L=4, D0=64; 32
       pairs x 2 directions = 64 instances): cost volume (K2) atol 1e-6,
       pyramid (K3) decisions and scores equal, fused (K1, patch) and
       fused magbin (K1b, grad_hist) at most 0.5% of decisions flipped
       (the count is printed and recorded) and scores within 2e-5 where
       decisions agree; K1's scores bitwise equal to K4's volume on the
       same 64 instances gathered at K1's disparities; K1, K1b and K3 each
       at least 2 blocks per SM (CUDA's occupancy calculator);
     - K3 at every shape of `profile_steps.rows_cases` (the bench on
       real-valued and on tie-heavy costs, D0 = 128 at L = 4, L = 1, 2
       and 5): decisions and scores bitwise equal to plain, and its shared
       memory per block as the library computes it equal to
       `pyramid_cuda.smem_bytes`;
     - K1 and K1b at small tiles (L 2 and 3, max_d 13, 16 and 32, p 4,
       and the runtime-p instance at p 3 and 8) within the same gate,
       K1's scores bitwise K4's where p < 5 (at p 8 the count that differ
       is printed: K4's window norms round pixel row 4's squares);
     - the cost-volume kernel (K2, K6): its shared memory per block as
       the library computes it equals `costvol_cuda.smem_bytes`, and at
       least 2 blocks per SM at the bench, grad_hist and KITTI shapes; K2
       at grad_hist width (C=128, 64 instances) atol 1e-6; both layouts at
       small ragged shapes on every staging form
       (`profile_steps.costvol_cases`: p 3-8, C 9 to 512, d_offset not a
       multiple of p, w0 not a multiple of the 32-column tile, a pair off
       16-byte alignment) atol 1e-6, each K6 slab bitwise K2's bins; beside
       K2 (bench and C=128) and K6 (KITTI D=256), a library yardstick the
       port never calls: the correlation alone as one torch.matmul on an
       as_strided window view, timed, with the memory it copies;
     - K1 at the KITTI grid (1242x375 at D=64: L=4, 96x384 patches), the
       eval tool's first KITTI pair in both directions, within the bench
       K1's gates (decisions flipped <= 0.5%, scores within 2e-5);
     - KITTI shapes (1242x375 -> padded 384x1536, L=5, 96x384 patch grid):
       image->volume (K4) at D=128, 8 pairs x 2 directions, atol 2e-5;
       level aggregation (K5) on that volume and at D=256 (4 pairs x 2),
       fast and exact: offsets equal and top maps bitwise, one launch per
       call; K5's shared memory per block as the library computes it equal
       to `pyramid_cuda.aggregate_smem_bytes`, and at least 2 blocks per SM
       at both KITTI shapes in each dtype and mode; its event and device
       (profiler) time at D=128 beside its time before the redesign, and
       its exact mode's event time;
     - K4 at least 2 blocks per SM at both KITTI shapes; on a grid of
       ragged 8x32-patch tiles (28x76 patches, D0=100, max_d=99), on
       ragged grids at the runtime-p instance (p 3, 5, 6, 7) and at D0 = 14
       (not a multiple of 4), atol 2e-5;
     - K5 at every other K5 shape of `profile_steps.rows_cases` (L 1-6,
       tile counts that do not divide the grid, D0 = 2^L and D0 not a
       multiple of 32, the narrow form at W0 = 2 mod 4 and off 16-byte
       alignment, dslab's bench volume), fast and exact, float32 and bf16,
       real-valued and tie-heavy: top and offsets bitwise plain, one launch
       per call (two at L = 6);
     - the bfloat16 instances (Config.dtype='bfloat16'): K4 bf16 at both
       KITTI shapes, the 28x76 ragged grid and the ragged runtime-p and
       D0 = 14 grids bitwise K4's float32 volume rounded to bf16; K5 bf16
       on that volume at D=128 and D=256, fast and exact, offsets equal
       and top maps bitwise its plain version (which rounds every op and
       the exponent to bf16); K1 bf16 on the bench's 64 instances and at
       the small tiles (patch) within the 0.5% decision gate of its plain
       version, scores within one bf16 ulp where decisions agree, and
       bitwise K4 bf16's volume at K1 bf16's disparities where p < 5; K1
       bf16 and K4 bf16 at least 2 blocks per SM, their shared memory per
       block (the float32 layouts) equal to fused_cuda's mirrors;
     - the bfloat16 instances of the descriptor routes and of K1b: K2 bf16
       at every D-major shape of `profile_steps.costvol_cases` (forward,
       reverse, origin_offset, both staging forms) bitwise K2's float32
       volume of the widened descriptors, rounded; beside it the float32
       kernel's max |error| against plain on those widenings (the sum
       before the rounding) and the share of bins that round alike with
       plain bf16; at the bench (C=16) and grad_hist (C=128) shapes timed,
       with its blocks per SM and a bf16 matmul yardstick; K6 refuses
       bf16; K3 bf16 at every K3 shape of `rows_cases` and on the bench's
       K2 bf16 volume: decisions and scores bitwise plain, and equal to K5
       bf16 (exact) + `backtrack_top` on the same volume, timed at the
       bench; K1b bf16 on the bench's 64 grad_hist instances and the small
       tiles within K1 bf16's gates; each at least 2 blocks per SM;
     - each block's shared memory as the library computes it equals the
       mirror that fused_cuda's routing rules use (K1, K1b, K4);
     - the row-layout slab cost volume (K6) at KITTI D=256 (4 pairs x 2
       directions), whole range and the four 64-bin slabs at d_offset 0,
       64, 128, 192, forward and reverse: atol 1e-6, and the slabs joined
       along D bitwise equal to K2's volume; at the bench shapes on a
       halo-extended target (origin_offset = halo_q = 16): atol 1e-6 and
       bitwise equal to K2 on the unextended target; K2 on the KITTI
       D=256 descriptors, timed beside K6;
  3d. the streaming probes P1-P3 through their entry point
     (`tools.vpu_probe`, counts zeroed before it: exactly P1, P2, P3), each
     bitwise equal to its plain version at its full repetitions, timed,
     and failing above 1.05 of the 67 TFLOP/s float32 peak; where
     `cuobjdump` exists, each probe kernel's SASS holds 256 FMUL and no
     FFMA (no product merged or contracted), and P3's 119 shared loads a
     repetition; P3's blocks per SM and persistent grid, its registers,
     and its issue-rate ceiling (FP32 and shared-load warp-instructions
     at four per SM per clock of `nvidia-smi`'s clocks.max.sm);
  3e. the prep kernel (PREP, csrc/prep.cu; `prep_phase`) at a stream
     batch's side, a path of its own launching PREP alone: its event time
     (inputs cycled past the L2) beside its bytes bound, the plain version
     and NumPy;
  3f. K4b, the cost volume on grad_hist (magnitude, bin) planes
     (`k4b_phase`): blocks per SM at KITTI D=256 in both dtypes; the
     grad_hist KITTI D=256 step in each dtype a path of its own launching
     exactly K4b and K5 (bf16: their bf16 instances), and timed; K4b's
     event time beside work.k4b's bound;
  3g. PLANES, grad_hist's (magnitude, bin) planes (`planes_phase`, its
     two instances' registers with no spills), a path of its own
     launching PLANES alone: its event and device time
     at the grad_hist KITTI step's 128 images beside work.magbin_planes's
     bound and the plain torch build's time on the card; PLANES is
     counted on every path but held to no path's set of kernels;
  3h. the card tests (`card_tests_phase`): every tests/test_torch_*_card.py
     in one pytest process of its own (--noconftest: tests/conftest.py
     imports JAX), exit 0, every test passed and none skipped.  These
     hold PREP, K4b, PLANES and EPI to their plain versions and the
     oracle; a new kernel's card checks go there, and chip_smoke only
     times it;
  3i. EPI, the step's LR check, densify and five outputs (`epilogue_phase`,
     its four instances' registers with no spills), a path of its own
     launching EPI once: its event and device time at the Middlebury step
     cell's 128 pairs of 96 x 128 patches beside work.epilogue's bound and
     the plain chain's time on the card; EPI is counted on every step's
     path (one a step, held there by its card tests) but held to no
     path's set of kernels;
  4. main path through `api.match_stereo` against the NumPy oracle: two
     bench pairs (patch: 'fused' within the bench's 0.5% decision gate,
     'exact' bitwise on decisions), one KITTI pair at D=128 (the
     tools/bench_large.py recipe: 'exact' raw_neq = valid_neq = 0,
     'fused' within the 0.5% gate and |d bad-rate| <= 0.005) and two bench
     pairs with grad_hist (both routes within the 0.5% gate); each path
     and route runs with the launch counts (`_build.launches`) cleared
     just before it, and must launch exactly its kernels: bench K1 | K2,
     K3; KITTI K4, K5 | K2, K5 exact; grad_hist K1b | K2, K3 ('fused' |
     'exact'); centred
     descriptors on bench pairs 100/101 ('fused': exactly K2, K3;
     raw_neq = valid_neq = 0) and on adversarial pairs (97x141, D=24,
     seeds 0, 1, 5; 'exact' and 'fused': K2, K3; raw_neq = valid_neq = 0,
     flat windows centred to exact zeros as in the oracle); bfloat16
     ('fused') on bench pairs 100/101 (exactly K1 bf16) and on KITTI
     D=256 pair 7 (tools/bench_large.py's bf16 row: exactly K4 bf16, K5
     bf16), 'exact' bf16 on bench pairs 100/101 (exactly K2 bf16, K3 bf16)
     and KITTI D=256 pair 7 (K2 bf16, K5 bf16), grad_hist bf16 on pairs
     100/101 on 'fused' (K1b bf16) and 'exact' (K2 bf16, K3 bf16), each
     with kept bad rate - the oracle's <= 0.05 and disparity_raw agreeing
     >= BF16_F32_AGREE with the port's float32 run of the same route on
     pixels valid in both; centred descriptors ('fused') and lr_mode
     'direct' ('exact') in bf16 on bench pairs 100/101 and the adversarial
     pairs (K2 bf16 with K3 bf16), decisions within the 0.5% gate of the
     port's plain route on the CPU; a float16 config raises;
     `utils.checks.checked_match_padded` on pair
     100 ('fused': equal to the unchecked pipeline; raises naming the
     non-finite input on a NaN plane); the CLI (`--demo -o DIR`) in a
     subprocess: exit 0, five files, impl 'fused'; again with --dtype
     bfloat16, on 'fused' and on --impl exact;
  4e. the dataset evaluation tool (`tools.eval_dataset.main(argv)`, in
     this process) over synthetic pairs written to disk: the KITTI layout
     at 1242x375, 1241x376, 1224x370 and 1226x370 (16-bit PNG ground
     truth) at D=64 'fused' (K1 on the 96x384 grid), D=128 'fused' (K4,
     K5) and 'exact' (K2, K5 exact), D=256 'fused' with --save-disparity; the
     Middlebury layout (two 450x375 scenes, ground truth x 4 in an 8-bit
     PGM, --gt-scale 0.25) at D=64 'fused' (K1) and 'exact' (K2, K3).
     Each run is a path of its own and must launch exactly its kernels,
     once per pair; exit 0, a summary of every pair with ground truth,
     device cuda:0; 'exact' 0 decision and validity disagreement with the
     oracle, 'fused' at most 0.5%; each pair's kept bad rate within 0.005
     of the oracle's; the saved PFMs bitwise match_stereo's disparity.
     Then the tool in its own process (its first pair holds the CUDA
     context and the library load), and exit 2 on an empty directory;
  5. timing with CUDA events (any sample <= 0 fails): the batched
     `match_padded_core` step per route for the bench (32 pairs), grad_hist
     (32 pairs) and KITTI (D=128 x 8 pairs, D=256 x 4 pairs), the bench,
     grad_hist and KITTI D=256 steps in bfloat16 beside them on both
     routes, and peak device memory per step and over all;
  6. the sharded strategies (`parallel.match_batch_sharded`) on a world
     of one rank over NCCL, bench pairs 100 and 101, lr_mode 'flip' and
     'direct': tiled ('fused'), dslab, ringd, wtiled with merge_level 1
     and None ('exact'), each bitwise on every key to the unsharded
     pipeline at the strategy's padded extents on the same route
     (wtiled merge_level 1: decisions bitwise, scores rtol 1e-5, its
     merge levels running the torch pyramid); dslab and ringd raw_neq =
     valid_neq = 0 against the oracle; launch counts zeroed before each
     strategy: tiled K1 ('direct': K2, K3), dslab K6, K5 exact, ringd K6,
     wtiled(1) K6, wtiled(None) K2, K3; each again in bfloat16, as the JAX
     package runs it: tiled and wtiled(None) bitwise the unsharded bf16
     pipeline (K1 bf16, or K2 bf16 and K3 bf16), dslab, ringd and
     wtiled(1) bitwise their own float32 run (their float32 kernels: the
     JAX package builds their volumes from float32 descriptors); then
     each strategy's step at
     KITTI D=256 x 4 pairs ('flip'), timed as in 5; then the stream
     (`parallel.run_stream`, tiled, 'fused', batch 32) over 69 bench
     pairs (seeds 100-168: two batches and a tail of 5), every pair bitwise
     to the unsharded pipeline, 3 `batch_done` and one `tail_batch` log
     events, its Mpx/s beside the step's, every batch padded on the host;
     the same pairs as uint8 colour images: every batch padded on the card
     (PREP, two launches a side), the outputs bitwise the unsharded
     pipeline on the host's padding; again with a match step that
     fails once (1 retry, same outputs); again in bfloat16 over 37 pairs
     (K1 bf16, bitwise the unsharded bf16 pipeline); and through
     `parallel.pairs_from_paths` over the pairs written as PGM (the native
     loader must build; planes bitwise equal to the in-memory path's);
  7. the port's bench (`bench.py`) and KITTI bench (`tools/bench_large.py`)
     rows in this process, each a path of its own that must launch exactly
     its kernels and hold its gates: `step_mpxs` (K1), `parity_gate` on
     'exact' (K2, K3: 4 bench pairs bitwise the oracle on disparity_raw,
     valid, disparity and disparity_right, scores rtol 1e-5) and 'fused'
     (K1: within 0.005), `bf16_mpxs` (K1 bf16), `grad_hist_mpxs` (K1b),
     `adversarial_row` (K2, K3: 240x360, D=64, seeds 0-1, decisions and
     validity <= 0.01 off the oracle, occlusion rejection >= 0.6, kept bad
     <= 0.15), and each `bench_large` row (K4, K5; K4 bf16, K5 bf16 in
     bfloat16: float32 parity <= 0.005, bf16 kept bad - the oracle's <=
     0.05); then `python -m ...bench` in its own process (its sharded smoke
     on a world of one NCCL rank): exit 0 and one stdout line naming the
     card;
  8. the roofline rows in this process (`tools.roofline.run`, whose hook
     makes each timed row a path of its own): `full_step_fused` and
     `fused_kernel` launch exactly K1, `descriptors_xla` nothing,
     `costvol_kernel` exactly K2, `pyramid_kernel` exactly K3,
     `calibrated` exactly P1; each row's ms, bound and share logged to
     stderr, every share in (0, 1.05]; then the tool in
     its own process (`--out` a temporary file: exit 0, one stdout line,
     the headline naming the card) and `tools.dcn_budget --roofline` on
     that file (exit 0, the table and the card).
Then the total wall time, one JSON line with the kernels' numbers (each
with its bound from the port's work model, `work.py`: the larger
of its bytes, each input read once and each output written once, over
3.35 TB/s and its operations over 67 TFLOP/s, 33.5 for the probes P1-P3,
which forbid FMA;
K2 also at C=128 and at KITTI D=256, rows of their own over K2's count;
K1 at the KITTI grid over K1's count on the eval tool's D=64 path; K5's
exact mode over its own count, `K5 exact`;
K1, K1b, K2 (C=16 and C=128), K3, K4 and K5 bf16 rows of their own, each
with its own launch count;
library_ms the yardstick where there is one; K5's rows with device_ms,
P3's with issue_ceiling_ms, PREP's with numpy_ms, PLANES's and EPI's with
device_ms; PREP, K4b, PLANES and EPI carry no max_abs_err: their card tests
hold them bitwise or within 2e-5; `roofline`: phase 8's headline and rows),
and as the last line {"ok": true, "device": {...}}.  Needs one CUDA
device; imports nothing of JAX or the JAX package.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, MAX_D, BATCH = 375, 450, 64, 32
KH, KW = 375, 1242
KITTI = {128: 8, 256: 4}               # max_disparity -> batch of pairs
KITTI_SEED = 7
RAGGED_HW, RAGGED_D = (100, 300), 99   # L=2: a 28x76-patch grid, D0=100
MAIN_PATH_SEEDS = (100, 101)
SLAB = 64                              # K6 check: D=256 in four slabs
FUSED_DECISION_TOL = 0.005
# bf16 against float32 on the same route, on pixels valid in both: the JAX
# package's own 'fused' bf16 agrees with its float32 on 0.97794 of them at
# bench pair 100 (and the port's plain K1 bf16 is bitwise JAX's there;
# tests/test_torch_bf16.py), below tests/test_bf16.py's 0.98, which holds
# on its smaller pairs; hence 0.97 here.
BF16_F32_AGREE = 0.97
# K1 and K1b as measured before the fused kernel's redesign (PERF.md,
# H100 @700 W), printed beside this run's.
EARLIER_MS = {"K1": 1.5673, "K1b": 2.1742}
# ... and K2/K6 before the cost-volume kernel's redesign (PERF.md, the
# same card): bench, grad_hist C=128 x 64 instances, KITTI D=256 x 8.
EARLIER_MS.update({"K2": 4.4331, "K2 C=128": 110.9849, "K6": 6.4251})
# ... and K3/K4 before their redesign (PERF.md, the same card): K3 at the
# bench, K4 at KITTI D=128 x 16 instances.
EARLIER_MS.update({"K3": 0.4879, "K4": 1.3301})
# ... and K5 (one launch per level) and P3 before their redesign (PERF.md,
# the same card): K5 at KITTI D=128 x 16 instances, fast, event time.
EARLIER_MS.update({"K5": 0.1826, "K5 bf16": 0.1944, "P3": 0.1100})
# Centred descriptors on adversarial (tie-heavy, flat-window) pairs.
ADV_HW, ADV_D, ADV_SEEDS = (97, 141), 24, (0, 1, 5)
STREAM_PAIRS, STREAM_TAIL = 69, 5       # two batches of BATCH and a tail
# The prep kernel's timed shape (csrc/prep.cu), (images, H, W, C, Hp, Wp):
# a side of a stream batch.
PREP_SHAPE = (BATCH, H, W, 3, 384, 512)
PREP_SETS = 4      # distinct input batches cycled while timed: 65 MB > L2
# The planes kernel's timed stack (csrc/planes.cu): the grad_hist KITTI
# step's two stacks as one, 128 images of 384 x 1536.
PLANES_STACK = (128, 384, 1536)
# The epilogue kernel's timed maps (csrc/epilogue.cu), (pairs, H0, W0, D):
# the Middlebury step cell's 128 pairs.
EPI_GRID = (128, 96, 128, 64)
PROBE_SASS = {"P1": "stream_kernelILi384", "P2": "stream_kernelILi96",
              "P3": "shift_kernel"}
PROBE_NAMES = {"P1": "stream", "P2": "small", "P3": "shift"}
KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")
# Phase 4e, the dataset evaluation tool on `profile_steps.eval_pairs`:
# each run (layout, D, route, --oracle-check N, more flags) and the
# kernels it launches, once per pair.
EVAL_RUNS = (("kitti", 64, "fused", 4, ()),
             ("kitti", 128, "fused", 4, ()),
             ("kitti", 128, "exact", 4, ()),
             ("kitti", 256, "fused", 1, ("--save-disparity",)),
             ("middlebury", 64, "fused", 2, ("--gt-scale", "0.25")),
             ("middlebury", 64, "exact", 2, ("--gt-scale", "0.25")))
EVAL_KERNELS = {("kitti", 64, "fused"): {"K1"},
                ("kitti", 128, "fused"): {"K4", "K5"},
                ("kitti", 128, "exact"): {"K2", "K5 exact"},
                ("kitti", 256, "fused"): {"K4", "K5"},
                ("middlebury", 64, "fused"): {"K1"},
                ("middlebury", 64, "exact"): {"K2", "K3"}}
PKG = "deepmatching_stereo_matching_tpu_torch"
JAX_PKG = "deepmatching_stereo_matching_tpu"


class SmokeFailure(Exception):
    pass


def require(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def make_pair(seed):
    """The bench's synthetic pair recipe (seed 100 + i)."""
    from deepmatching_stereo_matching_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(H, W, MAX_D, rng, block=32)
    return synthetic.make_pair(H, W, field, seed=seed)


def make_kitti_pair(seed, max_d):
    """tools/bench_large.py's KITTI-size recipe."""
    from deepmatching_stereo_matching_tpu_torch.data import synthetic

    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(KH, KW, max_d, rng, block=48)
    return synthetic.make_pair(KH, KW, field, seed=seed)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def probe_sass(so):
    """{kernel: {FMUL, FADD, FFMA, LDS: count}} of the probe kernels in the
    built library's SASS (LDS: shared-memory loads; instructions under the
    never-true predicate @!PT, which ptxas pads cp.async loops with, are
    not counted), or None where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True)
    counts, cur = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            cur = next((k for k, tag in PROBE_SASS.items() if tag in fn),
                       None)
            if cur is not None:
                counts[cur] = dict.fromkeys(("FMUL", "FADD", "FFMA", "LDS"),
                                            0)
        elif cur is not None and "@!PT" not in line:  # never executed
            for op in counts[cur]:
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    return counts


def ptxas(log, pattern, key):
    """{key(match): (registers, spill store B, spill load B)} of each
    instantiation of the kernel whose mangled name `pattern` matches, in
    nvcc's -Xptxas -v output."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            cur = key(k) if k else None
            continue
        if cur is None:
            continue
        # A kernel's section may hold the properties of the out-of-line
        # functions it calls too: keep its registers, the largest spills.
        regs, st, ld = out.get(cur, (None, 0, 0))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur] = (regs, max(st, int(m.group(1))),
                        max(ld, int(m.group(2))))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur] = (int(m.group(1)), st, ld)
    return out


def cuda_ms(torch, fn, reps, warmup=1):
    """Per-call device time of fn() in ms: CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    require(ms > 0, f"non-positive timing sample {ms}")
    return ms


def write_eval_datasets(root):
    """Phase 4e's fixtures under `root` (`profile_steps.eval_pairs`): the
    KITTI layout, ground truth as 16-bit PNGs in disp_occ_0/, and the
    Middlebury layout, ground truth as disparity x 4 in an 8-bit disp2.pgm.
    Returns {layout: (directory, [(name, image size)])}."""
    from deepmatching_stereo_matching_tpu_torch.io import writers
    from deepmatching_stereo_matching_tpu_torch.profile_steps import (
        eval_pairs)

    out = {"kitti": (os.path.join(root, "kitti"), []),
           "middlebury": (os.path.join(root, "middlebury"), [])}
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "kitti", sub))
    for layout, name, left, right, gt in eval_pairs():
        top, written = out[layout]
        written.append((name, left.shape))
        if layout == "kitti":
            for sub, img in (("image_2", left), ("image_3", right)):
                writers._to_png(os.path.join(top, sub, f"{name}.png"), img)
            writers.write_disparity_png16(
                os.path.join(top, "disp_occ_0", f"{name}.png"),
                np.where(gt >= 0, gt, np.nan).astype(np.float32))
            continue
        require(int(gt.max()) * 4 <= 255, f"Middlebury {name}: disparity "
                f"{gt.max()} x 4 does not fit an 8-bit PGM")
        scene = os.path.join(top, name)
        os.makedirs(scene)
        writers._to_png(os.path.join(scene, "im2.png"), left)
        writers._to_png(os.path.join(scene, "im6.png"), right)
        disp4 = np.where(gt >= 0, gt * 4, 0).astype(np.uint8)  # 0: unknown
        h, w = gt.shape
        with open(os.path.join(scene, "disp2.pgm"), "wb") as f:
            f.write(f"P5\n{w} {h}\n255\n".encode() + disp4.tobytes())
    return out


def eval_phase(run_path, path_launches, card):
    """4e: `tools.eval_dataset.main(argv)` in this process over the KITTI
    and Middlebury fixtures, each run a path of its own; then a fresh
    process's first pairs, and an empty directory."""
    import contextlib
    import io

    from deepmatching_stereo_matching_tpu_torch import api
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.io import images, writers
    from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu_torch.tools import eval_dataset
    from deepmatching_stereo_matching_tpu_torch.utils import metrics

    with tempfile.TemporaryDirectory() as tmp:
        data = write_eval_datasets(tmp)
        oracle_bad = {}    # (layout, name, D) -> the oracle's kept bad rate

        def pair_files(layout, name):
            """(left, right, ground truth, its scale) of a written pair."""
            root = data[layout][0]
            if layout == "kitti":
                return (*(os.path.join(root, sub, f"{name}.png") for sub in
                          ("image_2", "image_3", "disp_occ_0")), 1.0)
            return (*(os.path.join(root, name, f) for f in
                      ("im2.png", "im6.png", "disp2.pgm")), 0.25)

        def oracle_kept_bad(layout, name, d):
            if (layout, name, d) not in oracle_bad:
                lp, rp, gtp, scale = pair_files(layout, name)
                want = oracle.match_stereo(*images.load_pair(lp, rp),
                                           Config(max_disparity=d))
                oracle_bad[layout, name, d] = metrics.bad_pixel_rate(
                    want.disparity, eval_dataset._read_gt(gtp, scale),
                    count_invalid=False)
            return oracle_bad[layout, name, d]

        saved = os.path.join(tmp, "saved")
        for layout, d, route, checked, extra in EVAL_RUNS:
            root, written = data[layout]
            n = len(written)
            out = os.path.join(tmp, f"{layout}_{d}_{route}.json")
            argv = [root, "-D", str(d), "--impl", route, "--oracle-check",
                    str(checked), "--out", out, *extra]
            if "--save-disparity" in extra:
                argv.append(saved)
            label = f"eval {layout} D={d} {route}"
            stdout = io.StringIO()

            def run(argv=argv, stdout=stdout):
                with contextlib.redirect_stdout(stdout):
                    return eval_dataset.main(argv)

            expected = EVAL_KERNELS[layout, d, route]
            rc = run_path(label, expected, run)
            require(rc == 0, f"[{label}] exit {rc}")
            counts = path_launches[label]
            require(all(counts[k] == n for k in expected),
                    f"[{label}] {counts}: expected {n} launches of each of "
                    f"{sorted(expected)}, one per pair")
            summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
            with open(out) as f:
                report = json.load(f)
            rows = report["pairs"]
            print(f"[{label}] summary {json.dumps(summary)} {card}")
            print(f"[{label}] per-pair seconds (host wall, in this "
                  f"process: the CUDA context and the kernels were made in "
                  f"phases 1-3): {[r['seconds'] for r in rows]} {card}")
            require(summary == report["summary"]
                    and summary["pairs"] == summary["with_gt"] == n,
                    f"[{label}] summary {summary}, {n} pairs written")
            require(report["config"]["device"] == "cuda:0"
                    and report["config"]["impl"] == route,
                    f"[{label}] ran {report['config']}")
            for (name, hw), row in zip(written, rows):
                require(row["pair"] == name and row["shape"] == list(hw),
                        f"[{label}] row {row['pair']} {row['shape']}")
                bad_o = oracle_kept_bad(layout, name, d)
                print(f"  [{label}] {name} {hw[1]}x{hw[0]}: "
                      f"{json.dumps(row)}; oracle kept bad {bad_o:.4f}")
                require(abs(row["bad_pixel_rate_kept"] - bad_o)
                        <= FUSED_DECISION_TOL,
                        f"[{label}] {name}: kept bad "
                        f"{row['bad_pixel_rate_kept']} against the oracle's "
                        f"{bad_o:.4f}")
            for row in rows[:checked]:
                raw, val = (row["oracle_decision_disagreement"],
                            row["oracle_valid_disagreement"])
                require(raw == val == 0.0 if route == "exact" else
                        max(raw, val) <= FUSED_DECISION_TOL,
                        f"[{label}] {row['pair']}: decision disagreement "
                        f"{raw}, valid {val} against the oracle")
            if "--save-disparity" not in extra:
                continue
            require(sorted(os.listdir(saved)) == sorted(
                f"{name}.{ext}" for name, _ in written
                for ext in ("pfm", "png")),
                f"[{label}] --save-disparity wrote {os.listdir(saved)}")
            for name, _ in written:
                lp, rp, _, _ = pair_files(layout, name)
                want = api.match_stereo(*images.load_pair(lp, rp),
                                        Config(max_disparity=d), impl=route,
                                        device="cuda").disparity
                got = writers.read_pfm(os.path.join(saved, f"{name}.pfm"))
                require(got.dtype == want.dtype and np.array_equal(
                    np.isnan(got), np.isnan(want)) and np.array_equal(
                    got, want, equal_nan=True),
                    f"[{label}] {name}.pfm differs from match_stereo's "
                    f"disparity")
            print(f"[{label}] --save-disparity: {len(written)} PFMs bitwise "
                  f"match_stereo's disparity, NaN where NaN")

        # A fresh process: its first pair holds the CUDA context and the
        # load of the library built in phase 2.
        kitti = data["kitti"][0]
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.tools.eval_dataset", kitti,
             "--max-pairs", "2"], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        require(proc.returncode == 0, f"eval in its own process: exit "
                f"{proc.returncode}\n{proc.stderr[-2000:]}")
        secs = [json.loads(line)["seconds"]
                for line in proc.stderr.splitlines() if line.startswith("{")]
        require(len(secs) == 2, f"eval in its own process: rows {secs}")
        print(f"[eval kitti D=64 fused, own process] first pair {secs[0]} s "
              f"(CUDA context, library load, first call), second {secs[1]} "
              f"s (host wall) {card}")
        empty = os.path.join(tmp, "empty")
        os.makedirs(empty)
        with contextlib.redirect_stdout(io.StringIO()) as none:
            rc = eval_dataset.main([empty])
        require(rc == 2 and not none.getvalue(),
                f"an empty directory gave exit {rc}")
        print("eval on an empty directory: exit 2, no summary")
    print(flush=True)


def prep_batch(rng, n, h, w, c):
    """uint8 images for the prep kernel: uniform bytes, image 1 dark
    (channels 0 and 1: grayscale at most 1.0, so left undivided) and
    image 2 dark but for its last pixel (2 in every channel: lit)."""
    shape = (n, h, w) if c == 1 else (n, h, w, c)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    if n > 1:
        raw[1] = rng.integers(0, 2, shape[1:], dtype=np.uint8)
    if n > 2:
        raw[2] = 0
        raw[2, -1, -1] = 2
    return raw


def prep_phase(run_path, dev, card, rows):
    """3e: the prep kernel (PREP, csrc/prep.cu) at a stream batch's side,
    a path of its own (PREP alone): its event time, its kernels' device time and its time as the host
    issues it, beside the host's NumPy path and the plain version.
    tests/test_torch_prep_card.py holds it bitwise to its plain version
    and the oracle."""
    import torch
    from types import SimpleNamespace
    from deepmatching_stereo_matching_tpu_torch import work
    from deepmatching_stereo_matching_tpu_torch.ops import prep_cuda
    from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu_torch.profile_steps import device_ms

    rng = np.random.default_rng(17)
    n, h, w, c, hp, wp = PREP_SHAPE
    host = [prep_batch(rng, n, h, w, c) for _ in range(PREP_SETS)]
    sets = [torch.from_numpy(x).to(dev) for x in host]
    order = iter(range(10 ** 9))

    def call():
        return prep_cuda.gray_pad(sets[next(order) % PREP_SETS], hp, wp)
    run_path(f"prep {n}x{h}x{w}x{c}", {"PREP"}, call)
    # A call's host issue (two allocations, the ctypes launch) outlasts its
    # device time, so the timed calls queue behind a sleep kernel that
    # covers their issue: the events then time the device alone.
    reps = 200
    for _ in range(PREP_SETS):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    require(ms > 0, f"non-positive timing sample {ms}")
    dev_ms = device_ms(torch, call, "bright_kernel", reps) + device_ms(
        torch, call, "gray_pad_kernel", reps)
    issue_ms = cuda_ms(torch, call, reps)
    t0 = time.perf_counter()
    prep_cuda.gray_pad(torch.from_numpy(host[0]), hp, wp)
    plain_ms = (time.perf_counter() - t0) * 1e3
    geom = SimpleNamespace(padded_height=hp, padded_width=wp)
    t0 = time.perf_counter()
    np.stack([oracle.pad_image(oracle.to_grayscale_f32(x), geom)
              for x in host[0]])
    numpy_ms = (time.perf_counter() - t0) * 1e3
    model = work.gray_pad(n, h, w, c, hp, wp)
    bound_ms = work.bound(model)[0] * 1e3
    print(f"PREP {n} x {h}x{w}x{c} -> {hp}x{wp}: {ms:.4f} ms a call "
          f"({PREP_SETS} inputs cycled, queued), its two kernels "
          f"{dev_ms:.4f} ms on the device (profiler), back to back as "
          f"issued {issue_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes), "
          f"{ms / bound_ms:.2f}x; plain version {plain_ms:.1f} ms, the "
          f"host's NumPy grayscale and pad {numpy_ms:.1f} ms {card}")
    rows["PREP"] = dict(ms=ms, plain=plain_ms, work=model, device_ms=dev_ms,
                        numpy_ms=numpy_ms)
    print(flush=True)


def k4b_phase(run_path, dev, card, rows):
    """3f: K4b (csrc/costrows.cu: costrows_magbin_kernel), the cost volume
    on grad_hist (magnitude, bin) planes: the grad_hist KITTI D=256 step
    on 4 pairs, in each dtype a path of its own (K4b and K5, or their bf16
    instances) and timed, and K4b's event time at the 32-pair
    step's 64 instances beside work.k4b's bound, with its blocks per SM.
    tests/test_torch_cost_magbin_card.py holds it to its plain version,
    its mirror, K1b and the oracle."""
    import dataclasses
    import torch
    from deepmatching_stereo_matching_tpu_torch import work
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.models import (descriptors,
                                                               pipeline)
    from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda
    from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle

    cfg = Config(max_disparity=256, descriptor="grad_hist")
    geom = cfg.geometry(KH, KW)
    pairs = [make_kitti_pair(s, 256)[:2] for s in range(4)]
    lp, rp = (torch.from_numpy(np.stack([
        oracle.pad_image(oracle.to_grayscale_f32(p[j]), geom)
        for p in pairs])).to(dev) for j in (0, 1))
    # The step: planes, K4b, K5, the walk, the LR check.
    for dt, kernels in (("float32", {"K4b", "K5"}),
                        ("bfloat16", {"K4b bf16", "K5 bf16"})):
        c = dataclasses.replace(cfg, dtype=dt)
        run_path(f"K4b step grad_hist KITTI D=256 {dt}", kernels,
                 lambda: pipeline.match_padded_core(lp, rp, c, geom, "fused"))
        ms = cuda_ms(torch, lambda: pipeline.match_padded_core(
            lp, rp, c, geom, "fused"), 5)
        print(f"grad_hist KITTI D=256 step ({dt}), {lp.shape[0]} pairs: "
              f"{ms:.4f} ms = {lp.shape[0] * KH * KW * 1e-6 / (ms * 1e-3):.1f}"
              f" Mpx/s {card}")

    # Timed at the 32-pair step's 64 instances.
    (lm, lb), (rm, rb) = (descriptors.grad_hist_magbin(x) for x in (
        torch.cat([lp, rp.flip(-1)]), torch.cat([rp, lp.flip(-1)])))
    big = [x.repeat(8, 1, 1) for x in (lm, rm, lb, rb)]
    for key, dt in (("K4b", "float32"), ("K4b bf16", "bfloat16")):
        c = dataclasses.replace(cfg, dtype=dt)
        rows[key] = dict(
            ms=cuda_ms(torch, lambda: fused_cuda.cost_volume_rows(
                big[0], big[1], c, geom, big[2], big[3]), 10),
            plain=cuda_ms(torch, lambda: fused_cuda.cost_volume_torch(
                big[0], big[1], c, geom, big[2], big[3]), 1),
            work=work.k4b(c, geom, big[0].shape[0]),
            blocks_per_sm=fused_cuda.cost_blocks_per_sm(
                cfg.patch_size, cfg.max_disparity, dt == "bfloat16",
                magbin=True))
        bound_ms = work.bound(rows[key]["work"])[0] * 1e3
        print(f"{key} x{big[0].shape[0]} KITTI D=256: {rows[key]['ms']:.4f} ms"
              f", bound {bound_ms:.4f} ms, {bound_ms / rows[key]['ms']:.4f} of "
              f"it; plain {rows[key]['plain']:.4f} ms; "
              f"{rows[key]['blocks_per_sm']} blocks per SM {card}")
        require(bound_ms / rows[key]["ms"] <= work.MERGED_WORK,
                f"{key} above {work.MERGED_WORK} of its bound")
    print(flush=True)


def planes_images(rng, shape):
    """float32 images of `shape` (..., H, W) in stripes of 8 columns:
    halves in [-1, 1] (flat runs, |gx| == |gy|, gx or gy exactly 0),
    +0.0 and -0.0 mixed, uniform noise."""
    kinds = [(rng.integers(-2, 3, shape) / 2).astype(np.float32),
             np.where(rng.random(shape) < 0.5, np.float32(-0.0),
                      np.float32(0.0)),
             rng.random(shape, dtype=np.float32)]
    stripe = (np.arange(shape[-1]) // 8) % len(kinds)
    return np.choose(np.broadcast_to(stripe, shape), kinds).astype(np.float32)


def planes_phase(run_path, dev, card, rows):
    """3g: PLANES (csrc/planes.cu), grad_hist's (magnitude, bin) planes, at
    the grad_hist KITTI step's 128 images of 384 x 1536 (two inputs of
    302 MB cycled, past the L2), a path of its own (PLANES alone): its
    event time, its device time and the
    step's two 64-image calls, beside work.magbin_planes's bound and the
    plain version's time on the card.  tests/test_torch_planes_card.py
    holds it bitwise to its plain version."""
    import torch
    from deepmatching_stereo_matching_tpu_torch import work
    from deepmatching_stereo_matching_tpu_torch.models import descriptors
    from deepmatching_stereo_matching_tpu_torch.ops import planes_cuda
    from deepmatching_stereo_matching_tpu_torch.profile_steps import device_ms

    rng = np.random.default_rng(19)
    shape = PLANES_STACK
    sets = [torch.from_numpy(planes_images(rng, shape)).to(dev)
            for _ in range(2)]
    order = iter(range(10 ** 9))

    def call():
        return descriptors.grad_hist_magbin(sets[next(order) % 2])
    run_path(f"planes {shape}", set(), call)
    ms = cuda_ms(torch, call, 20, warmup=2)
    dev_ms = device_ms(torch, call, planes_cuda.KERNEL, 20)
    half = shape[0] // 2
    step_ms = cuda_ms(torch, lambda: [descriptors.grad_hist_magbin(x) for x
                                      in sets[next(order) % 2].split(half)],
                      20, warmup=2)
    plain_ms = cuda_ms(torch, lambda: descriptors.grad_hist_magbin_torch(
        sets[next(order) % 2]), 5)
    model = work.magbin_planes(*shape)
    bound_ms = work.bound(model)[0] * 1e3
    print(f"PLANES {shape}: {ms:.4f} ms a call, device {dev_ms:.4f} ms "
          f"(profiler), as the step's two calls of {half} {step_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms (bytes), {ms / bound_ms:.2f}x; the plain "
          f"torch build on the card {plain_ms:.4f} ms {card}")
    require(bound_ms / ms <= work.MERGED_WORK,
            f"PLANES above {work.MERGED_WORK} of its bound")
    rows["PLANES"] = dict(ms=ms, plain=plain_ms, work=model,
                          device_ms=dev_ms)
    print(flush=True)


def epilogue_phase(dev, card, rows):
    """3i: EPI (csrc/epilogue.cu), the step's LR check, densify and five
    outputs, at the Middlebury step cell's 128 pairs of 96 x 128 patches
    (two sets of maps cycled; 447 MB of outputs a call), one launch a
    call: its event time and its device time beside work.epilogue's bound
    and the plain chain's time on the card.  tests/test_torch_epilogue_card.py
    holds it bitwise to the plain chain."""
    import torch
    from deepmatching_stereo_matching_tpu_torch import work
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.models import pipeline
    from deepmatching_stereo_matching_tpu_torch.ops import _build, epilogue_cuda
    from deepmatching_stereo_matching_tpu_torch.profile_steps import device_ms

    n, h0, w0, d = EPI_GRID
    rng = np.random.default_rng(23)
    sets = [tuple(torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, d, (n, h0, w0), dtype=np.int32),
        rng.random((n, h0, w0), dtype=np.float32),
        rng.integers(0, d, (n, h0, w0), dtype=np.int32))) for _ in range(2)]
    cfg = Config(max_disparity=d)
    order = iter(range(10 ** 9))

    def call():
        return pipeline.lr_outputs(*sets[next(order) % 2], cfg, d)

    def plain():
        disp, score, right = sets[next(order) % 2]
        return pipeline.pixel_outputs(disp, score, cfg, right,
                                      pipeline.lr_consistency_patch(
                                          disp, right, cfg.tau, d,
                                          cfg.patch_size))
    before = _build.launches["EPI"]
    call()
    torch.cuda.synchronize()
    require(_build.launches["EPI"] - before == 1, "EPI: not one launch")
    ms = cuda_ms(torch, call, 20, warmup=2)
    dev_ms = device_ms(torch, call, epilogue_cuda.KERNEL, 20)
    plain_ms = cuda_ms(torch, plain, 5)
    model = work.epilogue(n, h0, w0, cfg.patch_size)
    bound_ms = work.bound(model)[0] * 1e3
    print(f"EPI {EPI_GRID}: {ms:.4f} ms a call, device {dev_ms:.4f} ms "
          f"(profiler); bound {bound_ms:.4f} ms (bytes), {ms / bound_ms:.2f}x;"
          f" the plain chain on the card {plain_ms:.4f} ms {card}")
    require(bound_ms / ms <= work.MERGED_WORK,
            f"EPI above {work.MERGED_WORK} of its bound")
    rows["EPI"] = dict(ms=ms, plain=plain_ms, work=model, device_ms=dev_ms)
    print(flush=True)


def card_tests_phase(card):
    """3h: every tests/test_torch_*_card.py in one pytest process of its
    own, with --noconftest (tests/conftest.py imports JAX, which the
    card's machine need not have): exit 0, every test passed and none
    skipped.  The card tests are where a kernel is held to its plain
    version on the card; chip_smoke times it.  Returns the passes."""
    import glob
    import re

    files = sorted(glob.glob(os.path.join(REPO, "tests",
                                          "test_torch_*_card.py")))
    require(files, "no card tests under tests/")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", *files], cwd=REPO, capture_output=True,
        text=True, timeout=1200)
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    passed = re.search(r"(\d+) passed", summary)
    print(f"card tests, {len(files)} files in their own process "
          f"({time.perf_counter() - t0:.1f} s): {summary} {card}")
    require(proc.returncode == 0 and passed is not None
            and not re.search(r"skipped|failed|error", summary),
            f"card tests: exit {proc.returncode}\n{proc.stdout[-3000:]}"
            f"{proc.stderr[-2000:]}")
    print(flush=True)
    return int(passed.group(1))


def bench_phase(run_path, dev, card, card_line):
    """7: the port's bench rows (`bench.py`, `tools/bench_large.py`) in this
    process, each a path of its own with its gates; then the bench in its
    own process (its sharded smoke makes and destroys a world of one rank
    there).  Returns what the kernels line records of it."""
    from deepmatching_stereo_matching_tpu_torch import bench
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu_torch.tools import bench_large

    t_phase = time.perf_counter()
    pairs = bench.make_pairs(bench.BATCH)
    t0 = time.perf_counter()
    want = [oracle.match_stereo(left, right, bench.bench_config())
            for left, right, _ in pairs[:bench.PARITY_PAIRS]]
    print(f"bench: the oracle on {len(want)} parity pairs took "
          f"{time.perf_counter() - t0:.1f} s on {bench.oracle_host()}")
    rows = {}

    def row(label, expected, fn):
        got, fails = run_path(label, expected, fn)
        require(not fails, f"[{label}] gate failures: {fails}")
        rows[label] = got
        return got

    step = row("bench step", {"K1"}, lambda: bench.step_mpxs(pairs, dev))
    for route, kernels in (("exact", {"K2", "K3"}), ("fused", {"K1"})):
        row(f"bench parity {route}", kernels, lambda route=route:
            bench.parity_gate(pairs, want, dev, routes=(route,)))
    f32 = bench.match_batch(pairs, bench.bench_config(), dev)
    row("bench bf16", {"K1 bf16"},
        lambda: bench.bf16_mpxs(pairs, want, dev, f32=f32))
    row("bench grad_hist", {"K1b"}, lambda: bench.grad_hist_mpxs(pairs, dev))
    adv = row("bench adversarial", {"K2", "K3"},
              lambda: bench.adversarial_row(dev))
    for label in ("bench step", "bench bf16", "bench grad_hist"):
        r = rows[label]
        print(f"[{label}] {r['batch']} pairs {r['width']}x{r['height']} "
              f"{r['dtype']} {r['descriptor']}: median "
              f"{r['timing']['median'] * 1e3:.4f} ms [{r['timing']['min'] * 1e3:.4f}"
              f"..{r['timing']['max'] * 1e3:.4f}] ({r['timing']['repeats']} x "
              f"{r['timing']['reps']} steps) = {r['mpx_per_s']:.1f} Mpx/s "
              f"[{r['range_mpx_per_s'][0]:.1f}..{r['range_mpx_per_s'][1]:.1f}]; "
              f"mean kept bad {r['mean_kept_bad']:.4f} {card}")
    print(f"[bench bf16] kept bad - the oracle's "
          f"{rows['bench bf16']['kept_bad_minus_oracle']}, decisions equal "
          f"to float32 on pixels valid in both "
          f"{rows['bench bf16']['f32_agreement']:.5f}")
    print(f"[bench adversarial] {adv['width']}x{adv['height']} D="
          f"{adv['max_disparity']}: {adv['seeds']}, occ_rejection "
          f"{adv['occ_rejection']:.4f}, kept non-occluded bad "
          f"{adv['kept_nonocc_bad']:.4f} (oracle on {adv['oracle_host']})")

    oracle_at = {}
    for max_d, batch, dtype in bench_large.ROWS:
        if max_d not in oracle_at:
            gl, gr, _ = bench_large.kitti_pair(bench_large.PARITY_SEED, max_d)
            oracle_at[max_d] = oracle.match_stereo(
                gl, gr, Config(max_disparity=max_d))
        b = " bf16" if dtype == "bfloat16" else ""
        label = f"bench_large D={max_d} {dtype}"
        r = row(label, {f"K4{b}", f"K5{b}"},
                lambda max_d=max_d, batch=batch, dtype=dtype: bench_large.
                bench_row(max_d, batch, dtype, dev, want=oracle_at[max_d]))
        tm = r["timing"]
        print(f"[{label}] {batch} pairs {r['width']}x{r['height']}, "
              f"{r['impl']}: median {tm['median'] * 1e3:.4f} ms "
              f"[{tm['min'] * 1e3:.4f}..{tm['max'] * 1e3:.4f}] = "
              f"{r['mpx_per_s']:.1f} Mpx/s; parity raw_neq "
              f"{r['parity_raw_neq']:.2e}, val_neq {r['parity_val_neq']:.2e},"
              f" kept bad {r['kept_bad_rate']:.4f} (oracle "
              f"{r['oracle_kept_bad']:.4f}); first call {r['compile_s']:.3f}"
              f" s {card}")
    in_process = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    own = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if not line.startswith("{"):
            print(f"  [bench, own process] {line}")
    require(proc.returncode == 0, f"the bench in its own process: exit "
            f"{proc.returncode}\n{proc.stderr[-3000:]}")
    out = proc.stdout.strip().splitlines()
    require(len(out) == 1, f"the bench printed {len(out)} stdout lines")
    line = json.loads(out[0])
    require(line["metric"] == "full_pipeline_throughput_per_chip"
            and line["unit"] == "Mpx/s" and line["device"] == card_line
            and line["value"] > 0 and len(line["range"]) == 2,
            f"the bench's line: {line}")
    print(f"bench (own process, {own:.1f} s): {out[0]}")
    print(f"phase 7 wall: {in_process:.1f} s in this process, {own:.1f} s "
          f"the bench's own process {card}", flush=True)
    return {"bench_line": line, "bench_wall_s": in_process + own,
            "bench_rows_ms": {
                label: [r["timing"][k] * 1e3 for k in ("median", "min", "max")]
                for label, r in rows.items() if "timing" in r}}


def roofline_phase(run_path, dev, card, card_line):
    """8: the roofline rows (`tools.roofline.run`) in this process, each
    timed row and the calibration a path of its own with the launch counts
    zeroed just before it, every share of the bound in (0, MERGED_WORK];
    then the tool in its own process (`--out` a file in a temporary
    directory) and the cross-host budget (`tools.dcn_budget --roofline`) on
    that file.  Returns the headline."""
    from deepmatching_stereo_matching_tpu_torch.tools import roofline

    expected = {"full_step_fused": {"K1"}, "fused_kernel": {"K1"},
                "descriptors_xla": set(), "costvol_kernel": {"K2"},
                "pyramid_kernel": {"K3"}, "calibrated": {"P1"}}
    t_phase = time.perf_counter()
    out = roofline.run(dev, card_line, **roofline.bench_size(),
                       wrap=lambda name, fn: run_path(f"roofline {name}",
                                                      expected[name], fn))
    rows = out["rows"]
    cal = rows["fused_kernel"].get("calibrated")
    require(cal is not None, "roofline: no calibration on the card")
    modelled = {k: r for k, r in (*rows.items(), ("calibrated", cal))
                if "sol_seconds" in r}
    require(sorted(modelled) == sorted(
        ("full_step_fused", "fused_kernel", "costvol_kernel",
         "pyramid_kernel", "twokernel_path_sum", "calibrated")),
        f"roofline: modelled rows {sorted(modelled)}")
    shares = {k: r["sol_fraction"] for k, r in modelled.items()}
    require(not roofline.shares_over(out)
            and all((v or 0) > 0 for v in shares.values()),
            f"roofline: shares outside (0, {roofline.MERGED_WORK}]: {shares}")
    in_process = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "roofline.json")
        procs = {}
        for tool, argv in (("roofline", ["--out", path]),
                           ("dcn_budget", ["--roofline", path])):
            proc = subprocess.run(
                [sys.executable, "-m", f"{PKG}.tools.{tool}", *argv],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            for line in proc.stderr.splitlines():
                print(f"  [{tool}, own process] {line}")
            require(proc.returncode == 0, f"tools.{tool} in its own process: "
                    f"exit {proc.returncode}\n{proc.stderr[-3000:]}")
            procs[tool] = proc.stdout
        with open(path) as f:
            written = json.load(f)
        require(os.listdir(tmp) == ["roofline.json"],
                f"the tools wrote {os.listdir(tmp)}")
    lines = procs["roofline"].strip().splitlines()
    require(len(lines) == 1, f"roofline printed {len(lines)} stdout lines")
    headline = json.loads(lines[0])
    require(headline["chip"] == card_line == written["chip"]
            and headline["fused_sol_fraction"] is not None
            and sorted(written["rows"]) == sorted(rows),
            f"roofline's headline {headline} on {written['chip']!r}")
    for line in procs["dcn_budget"].splitlines():
        print(f"  [dcn_budget] {line}")
    require(card_line in procs["dcn_budget"], "dcn_budget does not name "
            "the card its compute was measured on")
    print(f"roofline headline (own process): {json.dumps(headline)}")
    print(f"phase 8 wall: {in_process:.1f} s in this process, "
          f"{time.perf_counter() - t0:.1f} s the tools' own processes {card}",
          flush=True)
    return {**headline,
            "in_process": {k: {f: r[f] for f in ("seconds", "sol_seconds",
                                                  "sol_fraction",
                                                  "bounding_resource")
                               if f in r}
                           for k, r in (*rows.items(), ("calibrated", cal))}}


def main():
    import torch

    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    import torch.nn.functional as F
    from deepmatching_stereo_matching_tpu_torch import api, native
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu_torch.utils import checks, metrics
    from deepmatching_stereo_matching_tpu_torch.utils.logging import JsonlLogger
    from deepmatching_stereo_matching_tpu_torch.models import descriptors
    from deepmatching_stereo_matching_tpu_torch.models import pipeline
    from deepmatching_stereo_matching_tpu_torch.ops import (
        _build, costvol, costvol_cuda, fused_cuda, pool, prep_cuda,
        probe_cuda, pyramid_cuda)
    from deepmatching_stereo_matching_tpu_torch.parallel import (
        launch, mesh as mesh_lib, runner, sharded, wtiled)
    from deepmatching_stereo_matching_tpu_torch import work
    from deepmatching_stereo_matching_tpu_torch.tools import vpu_probe
    from deepmatching_stereo_matching_tpu_torch.data import synthetic
    from deepmatching_stereo_matching_tpu_torch.profile_steps import (
        SMALL_TILES, STRATEGIES as STRATEGY_RUNS, costvol_cases,
        costvol_inputs, costvol_launch, device_ms, eval_pairs, k5_launch,
        k5_volume, rows_cases, rows_inputs, rows_launch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    card = f"[{card_line}]"
    print(f"device: {name}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line, flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    so = _build.build(force=True)
    print(f"build: {os.path.relpath(so, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                     or "spill" in line):
            print("  " + line.strip())
        elif "bytes stack frame" in line:
            print("  " + line.strip())
    _build.library()
    # fused_kernel<p, magbin, bf16> (p 0: the runtime-p instance) and
    # costvol_kernel<rows, 16-byte staging>.
    fused_ptxas = ptxas(_build.build_log(),
                        r"fused_kernelILi(\d+)ELb([01])ELb([01])E",
                        lambda m: (int(m.group(1)), "magbin"
                                   if m.group(2) == "1" else "patch",
                                   "bf16" if m.group(3) == "1" else "f32"))
    for fn, (regs, spill_st, spill_ld) in sorted(fused_ptxas.items()):
        print(f"fused_kernel<p={fn[0]}, {fn[1]}, {fn[2]}>: {regs} registers, "
              f"spill stores {spill_st} B, spill loads {spill_ld} B")
    require(len(fused_ptxas) == 8 and all(
        v[1] == 0 and v[2] == 0 for v in fused_ptxas.values()),
        f"fused_kernel instantiations missing or spilling: {fused_ptxas}")
    # costvol_kernel<rows, 16-byte staging, element type>.
    costvol_ptxas = ptxas(_build.build_log(),
                          r"costvol_kernelILb([01])ELb([01])E(f|13__nv_bfloat16)E",
                          lambda m: (m.group(1) == "1", m.group(2) == "1",
                                     "f32" if m.group(3) == "f" else "bf16"))
    for (rows_, vec16, ty), (regs, spill_st, spill_ld) in sorted(
            costvol_ptxas.items()):
        print(f"costvol_kernel<{'rows' if rows_ else 'D-major'}, "
              f"{'16-byte' if vec16 else 'narrow'} staging, {ty}>: {regs} "
              f"registers, spill stores {spill_st} B, spill loads "
              f"{spill_ld} B")
    require(len(costvol_ptxas) == 6 and all(
        v[1] == 0 and v[2] == 0 for v in costvol_ptxas.values()),
        f"costvol_kernel instantiations missing or spilling: {costvol_ptxas}")
    # costrows_kernel<p, volume type>, pyramid_kernel<bf16>,
    # aggregate_kernel<bf16, 16-byte form, fast>.
    rows_ptxas = ptxas(_build.build_log(),
                       r"(costrows_kernelILi\d+E(?:f|13__nv_bfloat16)E"
                       r"|pyramid_kernelILb[01]E"
                       r"|aggregate_kernelILb[01]ELb[01]ELb[01]E)",
                       lambda m: m.group(1).replace("13__nv_bfloat16", "bf16"))
    for fn, (regs, spill_st, spill_ld) in sorted(rows_ptxas.items()):
        print(f"{fn}: {regs} registers, spill stores {spill_st} B, spill "
              f"loads {spill_ld} B")
    require(len(rows_ptxas) == 14 and all(
        v[1] == 0 and v[2] == 0 for v in rows_ptxas.values()),
        f"costrows_kernel / pyramid_kernel / aggregate_kernel missing or "
        f"spilling: {rows_ptxas}")
    # costrows_magbin_kernel<p, volume type> (K4b).
    magbin_ptxas = ptxas(_build.build_log(),
                         r"(costrows_magbin_kernelILi\d+E"
                         r"(?:f|13__nv_bfloat16)E)",
                         lambda m: m.group(1).replace("13__nv_bfloat16",
                                                      "bf16"))
    for fn, (regs, spill_st, spill_ld) in sorted(magbin_ptxas.items()):
        print(f"{fn}: {regs} registers, spill stores {spill_st} B, spill "
              f"loads {spill_ld} B")
    require(len(magbin_ptxas) == 4 and all(
        v[1] == 0 and v[2] == 0 for v in magbin_ptxas.values()),
        f"costrows_magbin_kernel missing or spilling: {magbin_ptxas}")
    # lr_outputs_kernel<P, LR> (EPI): P 4 (16-byte stores) or 0 (any p).
    epi_ptxas = ptxas(_build.build_log(), r"lr_outputs_kernelILi(\d+)ELb([01])E",
                      lambda m: (int(m.group(1)), m.group(2) == "1"))
    for (p_, lr), (regs, spill_st, spill_ld) in sorted(epi_ptxas.items()):
        print(f"lr_outputs_kernel<{p_}, {lr}>: {regs} registers, spill "
              f"stores {spill_st} B, spill loads {spill_ld} B")
    require(len(epi_ptxas) == 4 and all(
        v[1] == 0 and v[2] == 0 for v in epi_ptxas.values()),
        f"lr_outputs_kernel missing or spilling: {epi_ptxas}")
    # magbin_planes_kernel<16-byte form> (PLANES).
    planes_ptxas = ptxas(_build.build_log(), r"magbin_planes_kernelILb([01])E",
                         lambda m: m.group(1) == "1")
    for vec, (regs, spill_st, spill_ld) in sorted(planes_ptxas.items()):
        print(f"magbin_planes_kernel<{'16' if vec else '4'}-byte>: {regs} "
              f"registers, spill stores {spill_st} B, spill loads "
              f"{spill_ld} B")
    require(len(planes_ptxas) == 2 and all(
        v[1] == 0 and v[2] == 0 for v in planes_ptxas.values()),
        f"magbin_planes_kernel missing or spilling: {planes_ptxas}")
    # The probes: a spill would add local loads to the measured mix.
    probe_ptxas = ptxas(_build.build_log(),
                        r"(stream_kernelILi\d+E|shift_kernel)",
                        lambda m: m.group(1))
    for fn, (regs, spill_st, spill_ld) in sorted(probe_ptxas.items()):
        print(f"{fn}: {regs} registers, spill stores {spill_st} B, spill "
              f"loads {spill_ld} B")
    require(len(probe_ptxas) == 3 and all(
        v[1] == 0 and v[2] == 0 for v in probe_ptxas.values()),
        f"probe kernels missing or spilling: {probe_ptxas}")
    print(flush=True)

    def to_dev(imgs, cfg, h, w):
        return torch.from_numpy(np.stack([api.preprocess(x, cfg, h, w)
                                          for x in imgs])).to(dev)

    def both_directions(lp, rp):
        return torch.stack([lp, rp.flip(-1)]), torch.stack([rp, lp.flip(-1)])

    rows = {}

    def record(key, err, kernel_fn, plain_fn, model, reps=10, plain_reps=3):
        """`model`: one kernel call's `work.Work` (the port's work model)."""
        rows[key] = dict(err=err, ms=cuda_ms(torch, kernel_fn, reps),
                         plain=cuda_ms(torch, plain_fn, plain_reps),
                         work=model)

    def corr_yardstick(key, src, tgt, d0, p):
        """The library yardstick of a cost-volume row, which the port
        never calls: the forward correlation alone (no relu, no mask) as
        one batched torch.matmul of the source descriptors against an
        as_strided window view of the target, zero-padded by d0 - 1
        columns on the left (bin d0 - 1 - m at window row m).  Times it,
        and records the device memory the call took beyond its operands
        and output: torch.matmul copies a window view that does not fold
        into one batch dimension."""
        *lead, h0, w0, c = src.shape
        right = max(0, p * (w0 - 1) + 1 - tgt.shape[-2])
        tp = F.pad(tgt, (0, 0, d0 - 1, right))
        st = tp.stride()
        win = tp.as_strided((*lead, h0, w0, c, d0),
                            (*st[:-2], p * st[-2], st[-1], st[-2]))

        def call():
            return torch.matmul(src.unsqueeze(-2), win)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = call()
        sync()
        extra = torch.cuda.max_memory_allocated() - base - nbytes(out)
        del out
        ms = cuda_ms(torch, call, 3)
        rows[key]["library"] = ms
        rows[key]["library_extra_bytes"] = extra
        print(f"  {key} library yardstick (torch.matmul on a window view, "
              f"correlation only): {ms:.4f} ms, {extra / 2**20:.1f} MiB "
              f"beyond its operands and output {card}")
        del tp, win

    def scores_agree(cfg, s, sp, same):
        """Scores where decisions agree: within 2e-5 in float32; in
        bfloat16 within one bf16 ulp (2^-7 of the value), since the kernel's
        and the plain version's float32 costs, which differ in their last
        bits, may round to neighbouring bf16 values."""
        if cfg.dtype == "bfloat16":
            return bool(((s - sp).abs() <= sp.abs() * 2.0 ** -7)[same].all())
        return float((s - sp).abs()[same].max()) <= 2e-5

    def fused_vs_plain(key, lefts, rights, cfg, geom):
        """K1 on pixel planes (in cfg.dtype), K1b on (magnitude, bin)
        planes."""
        if cfg.descriptor == "grad_hist":
            (lm, lb), (rm, rb) = map(descriptors.grad_hist_magbin,
                                     (lefts, rights))
            planes = (lm, rm, cfg, geom, lb, rb)
        else:
            planes = (lefts, rights, cfg, geom)
        d, s = fused_cuda.match_planes(*planes)
        sync()
        dp, sp = fused_cuda.match_planes_torch(*planes)
        same = d == dp
        flips = float((~same).float().mean())
        serr = float((s - sp).abs()[same].max())
        print(f"{key} fused [{cfg.descriptor}, {cfg.dtype}] "
              f"{tuple(lefts.shape)} -> {tuple(d.shape)}: decisions flipped "
              f"{flips:.3e}, max |score diff| where equal {serr:.3e}, "
              f"scores equal where decisions agree "
              f"{float((s == sp)[same].float().mean()):.6f}")
        require(flips <= FUSED_DECISION_TOL
                and scores_agree(cfg, s, sp, same),
                f"{key} disagrees with its plain version")
        record(key, serr, lambda: fused_cuda.match_planes(*planes),
               lambda: fused_cuda.match_planes_torch(*planes),
               work.k1(cfg, geom, math.prod(d.shape[:-2])))
        rows[key]["flips"] = flips
        return d, s

    def witness(label, lefts, rights, cfg, geom, d, s, required=True):
        """K1's scores against K4's volume on the same planes, gathered at
        K1's disparities: both compile cost.cuh's cost block, which rounds
        alike wherever the patch has no fifth pixel row (at p >= 5 K4's
        window norms round that row's squares before adding them)."""
        vol = fused_cuda.cost_volume_rows(lefts, rights, cfg, geom)
        at = vol.gather(-3, d.long().unsqueeze(-3)).squeeze(-3).float()
        same = torch.equal(at, s)
        print(f"{label} scores vs K4's volume at K1's disparities: bitwise "
              f"{same}, mismatch rate {float((at != s).float().mean()):.3e}, "
              f"max |diff| {float((at - s).abs().max()):.3e}")
        require(same or not required,
                f"{label}: K1's scores are not K4's costs")
        return same

    def blocks_agree(label, fcfg, fgeom):
        n = fused_cuda.blocks_per_sm(fcfg, fgeom)
        print(f"{label} blocks per SM (occupancy API): {n}")
        require(n >= 2, f"{label}: {n} blocks per SM, fewer than 2")
        return n

    bf16 = torch.bfloat16

    def k2_bf16(label, src, tgt, *args):
        """K2's bf16 instance on bf16 descriptors: bitwise the float32
        kernel on their widenings, rounded; beside it the float32 kernel's
        max |error| against plain on the widenings (the sums before the
        rounding) and the share of bins that round alike with plain bf16
        (whose sum order differs)."""
        vol = costvol_cuda.cost_volume_dmajor(src, tgt, *args)
        wide = costvol_cuda.cost_volume_dmajor(src.float(), tgt.float(),
                                               *args)
        sync()
        same = vol.dtype == bf16 and torch.equal(vol, wide.to(bf16))
        err = float((wide - costvol_cuda.cost_volume_dmajor_torch(
            src.float(), tgt.float(), *args)).abs().max())
        alike = float((vol == costvol_cuda.cost_volume_dmajor_torch(
            src, tgt, *args)).float().mean())
        print(f"{label} {tuple(src.shape)} -> {tuple(vol.shape)} "
              f"{vol.dtype}: bitwise the float32 kernel on the widened "
              f"descriptors, rounded {same}; max |float32 kernel - plain| "
              f"on them {err:.3e}; bins rounding alike with plain bf16 "
              f"{alike:.6f}")
        require(same and err <= 1e-6, f"{label}: K2 bf16 is not the float32 "
                f"kernel's volume of the widened descriptors, rounded")
        return vol, err

    def k3_bf16(label, vol, levels):
        """K3's bf16 instance: decisions and scores bitwise plain, and
        equal to K5 bf16 (exact) + backtrack_top on the same volume.
        Returns its decisions, scores and largest |score - plain|."""
        d, s_ = pyramid_cuda.pyramid_backtrack(vol, levels, 1.4)
        sync()
        dp, sp = pyramid_cuda.pyramid_body(vol, levels, 1.4, fast=False)
        d5, s5 = pyramid_cuda.backtrack_top(
            vol, *pyramid_cuda.aggregate_dmajor(vol, levels, 1.4))
        same = torch.equal(d, dp) and torch.equal(s_, sp)
        same5 = torch.equal(d, d5) and torch.equal(s_, s5)
        print(f"{label} K3 bf16 {tuple(vol.shape)}: decisions and scores "
              f"bitwise plain {same} (decision mismatch rate "
              f"{float((d != dp).float().mean()):.3e}), equal to K5 bf16 "
              f"(exact) + backtrack_top {same5}")
        require(same and same5, f"{label}: K3 bf16 disagrees")
        return d, s_, float((s_.float() - sp.float()).abs().max())

    # 3a. Kernels vs their plain versions at the bench shapes.
    cfg = Config(max_disparity=MAX_D)
    geom = cfg.geometry(H, W)
    require((geom.levels, geom.padded_height, geom.padded_width,
             geom.disparities) == (4, 384, 512, 64), f"geometry {geom}")
    require(fused_cuda.supported(cfg, geom), "fused kernel must cover the bench")
    pairs = [make_pair(100 + i) for i in range(BATCH)]
    lp = to_dev([l for l, _, _ in pairs], cfg, H, W)
    rp = to_dev([r for _, r, _ in pairs], cfg, H, W)
    lefts, rights = both_directions(lp, rp)     # (2, 32, Hp, Wp): 64 instances

    ds = descriptors.left_descriptors(lefts, cfg)
    dt = descriptors.right_sliding_descriptors(rights, cfg)
    args2 = (geom.disparities, cfg.patch_size, cfg.max_disparity)
    vol = costvol_cuda.cost_volume_dmajor(ds, dt, *args2)
    sync()
    vol_p = costvol_cuda.cost_volume_dmajor_torch(ds, dt, *args2)
    err2 = float((vol - vol_p).abs().max())
    print(f"K2 cost volume {tuple(vol.shape)}: max |kernel - plain| = {err2:.3e}")
    require(err2 <= 1e-6, f"K2 disagrees with its plain version: {err2}")
    del vol_p
    record("K2", err2,
           lambda: costvol_cuda.cost_volume_dmajor(ds, dt, *args2),
           lambda: costvol_cuda.cost_volume_dmajor_torch(ds, dt, *args2),
           work.k2(cfg, geom, 2 * BATCH))
    corr_yardstick("K2", ds, dt, geom.disparities, cfg.patch_size)

    d3, s3 = pyramid_cuda.pyramid_backtrack(vol, geom.levels, cfg.lam)
    sync()
    d3p, s3p = pyramid_cuda.pyramid_body(vol, geom.levels, cfg.lam, fast=False)
    flip3 = float((d3 != d3p).float().mean())
    serr3 = float((s3 - s3p).abs().max())
    print(f"K3 pyramid: decision mismatch rate {flip3:.3e}, "
          f"score mismatch rate {float((s3 != s3p).float().mean()):.3e}, "
          f"max |score diff| {serr3:.3e}")
    require(flip3 == 0.0 and serr3 == 0.0, "K3 disagrees with its plain version")
    record("K3", serr3,
           lambda: pyramid_cuda.pyramid_backtrack(vol, geom.levels, cfg.lam),
           lambda: pyramid_cuda.pyramid_body(vol, geom.levels, cfg.lam),
           work.k3(cfg, geom, 2 * BATCH))
    # K2's and K3's bf16 instances on the bench's descriptors rounded, as
    # the descriptor routes round them.
    ds16, dt16 = ds.to(bf16), dt.to(bf16)
    vol16, err2b = k2_bf16("K2 bf16 bench", ds16, dt16, *args2)
    record("K2 bf16", err2b,
           lambda: costvol_cuda.cost_volume_dmajor(ds16, dt16, *args2),
           lambda: costvol_cuda.cost_volume_dmajor_torch(ds16, dt16, *args2),
           work.k2(cfg, geom, 2 * BATCH, "bfloat16"))
    corr_yardstick("K2 bf16", ds16, dt16, geom.disparities, cfg.patch_size)
    try:
        costvol_cuda.cost_volume_rows(ds16, dt16, *args2)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    print(f"K6 on bf16 descriptors: raises {refused!r}")
    require(refused is not None and "row-layout" in refused,
            "K6 took bf16 descriptors")
    d3b, s3b, serr3b = k3_bf16("bench (K2 bf16's volume)", vol16,
                               geom.levels)
    record("K3 bf16", serr3b,
           lambda: pyramid_cuda.pyramid_backtrack(vol16, geom.levels, cfg.lam),
           lambda: pyramid_cuda.pyramid_body(vol16, geom.levels, cfg.lam),
           work.k3(cfg, geom, 2 * BATCH, "bfloat16"))
    rows["K3 bf16"]["blocks_per_sm"] = pyramid_cuda.blocks_per_sm(
        geom.disparities, geom.levels, bf16=True)
    print(f"K3 bf16 bench blocks per SM (occupancy API): "
          f"{rows['K3 bf16']['blocks_per_sm']}; decisions agree with K3 on "
          f"the float32 volume {float((d3b == d3).float().mean()):.5f}")
    require(rows["K3 bf16"]["blocks_per_sm"] >= 2,
            "K3 bf16: fewer than 2 blocks per SM")
    del vol, ds, dt, ds16, dt16, vol16, d3b, s3b
    # K3: shared memory against its mirror, blocks per SM, and bitwise to
    # plain at every rows_cases shape, in float32 and in bf16 (the volume
    # rounded).
    for seed, (cname, kind, shape) in enumerate(rows_cases()):
        if kind != "K3":
            continue
        n_, d0_, h0_, w0_, lv_ = shape
        require(pyramid_cuda.supported(d0_, lv_), f"{cname} not routed")
        lib_b = _build.library().dm_pyramid_smem(d0_, lv_)
        occ3 = pyramid_cuda.blocks_per_sm(d0_, lv_)
        inputs_ = rows_inputs(torch, kind, shape, seed)
        dk, sk = rows_launch(kind, shape, inputs_, cname)
        sync()
        dp_, sp_ = rows_launch(kind, shape, inputs_, cname, plain=True)
        same = torch.equal(dk, dp_) and torch.equal(sk, sp_)
        print(f"{cname} {shape}: decisions and scores bitwise equal to "
              f"plain {same} (decision mismatch rate "
              f"{float((dk != dp_).float().mean()):.3e}); shared memory "
              f"{lib_b} B (library), {pyramid_cuda.smem_bytes(d0_, lv_)} B "
              f"(mirror); {occ3} blocks per SM")
        require(same, f"{cname} disagrees with its plain version")
        require(lib_b == pyramid_cuda.smem_bytes(d0_, lv_),
                f"{cname}: the shared-memory mirror disagrees")
        require(occ3 >= 2, f"{cname}: {occ3} blocks per SM, fewer than 2")
        if cname == "K3 bench":
            rows["K3"]["blocks_per_sm"] = occ3
        k3_bf16(cname, (inputs_[1] if "ties" in cname else inputs_[0]).to(
            bf16), lv_)
        del inputs_, dk, sk, dp_, sp_

    def smem_agrees(label, lib_bytes, mirror_bytes):
        """The routing rules' shared-memory mirror equals the library's."""
        print(f"{label} shared memory per block: {lib_bytes} B (library), "
              f"{mirror_bytes} B (the Python mirror)")
        require(lib_bytes == mirror_bytes,
                f"{label}: the Python shared-memory mirror disagrees with "
                f"the library")

    def fused_smem_agrees(label, fcfg, fgeom):
        args = (fcfg.patch_size, fgeom.disparities, fcfg.max_disparity,
                fgeom.levels)
        magbin = fcfg.descriptor == "grad_hist"
        smem_agrees(label, _build.library().dm_fused_smem(*args, int(magbin)),
                    fused_cuda.smem_bytes(*args, magbin=magbin))

    fused_smem_agrees("K1 bench", cfg, geom)
    gh = Config(max_disparity=MAX_D, descriptor="grad_hist")
    require(fused_cuda.supported(gh, geom), "K1b must cover the bench")
    fused_smem_agrees("K1b bench", gh, geom)
    rows_occ = {"K1": blocks_agree("K1 bench", cfg, geom),
                "K1b": blocks_agree("K1b bench", gh, geom)}
    d1, s1 = fused_vs_plain("K1", lefts, rights, cfg, geom)
    witness("K1 bench (64 instances)", lefts, rights, cfg, geom, d1, s1)
    # K1's bfloat16 instance: the same layout, so the same mirror.
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    require(fused_cuda.supported(cfg16, geom), "K1 bf16 must cover the bench")
    fused_smem_agrees("K1 bf16 bench", cfg16, geom)
    rows_occ["K1 bf16"] = blocks_agree("K1 bf16 bench", cfg16, geom)
    d16, s16 = fused_vs_plain("K1 bf16", lefts, rights, cfg16, geom)
    witness("K1 bf16 bench (64 instances)", lefts, rights, cfg16, geom, d16,
            s16)
    agree16 = float((d16 == d1).float().mean())
    print(f"K1 bf16 vs K1 on the bench's 64 instances: decisions agree "
          f"{agree16:.5f}")
    del d1, s1, d16, s16
    fused_vs_plain("K1b", lefts, rights, gh, geom)
    # K1b's bfloat16 instance: the same layout, so the same mirror.
    gh16 = dataclasses.replace(gh, dtype="bfloat16")
    require(fused_cuda.supported(gh16, geom), "K1b bf16 must cover the bench")
    fused_smem_agrees("K1b bf16 bench", gh16, geom)
    rows_occ["K1b bf16"] = blocks_agree("K1b bf16 bench", gh16, geom)
    fused_vs_plain("K1b bf16", lefts, rights, gh16, geom)
    for k in ("K1", "K1 bf16", "K1b", "K1b bf16"):
        rows[k]["blocks_per_sm"] = rows_occ[k]
    planes_ms = cuda_ms(torch, lambda: (
        descriptors.grad_hist_magbin_torch(lefts),
        descriptors.grad_hist_magbin_torch(rights)), 10)
    kernel_planes_ms = cuda_ms(torch, lambda: (
        descriptors.grad_hist_magbin(lefts),
        descriptors.grad_hist_magbin(rights)), 10)
    print(f"  K1b's (magnitude, bin) planes before it, per 64-instance call: "
          f"the plain torch build {planes_ms:.4f} ms, PLANES "
          f"{kernel_planes_ms:.4f} ms {card}")
    # Small tiles (levels 2 and 3, where the 2x2 quads fill a warp only in
    # part), and the runtime-p instance (p 3 and 8).
    for h0, w0, max_d, levels, p in SMALL_TILES:
        srng = np.random.default_rng(h0 + w0 + max_d + p)
        sl_, sr_ = (torch.from_numpy((srng.standard_normal(
            (4, h0 * p, w0 * p)) * 0.3 + 0.5).astype(np.float32)).to(dev)
            for _ in range(2))
        for kind, sdtype in (("patch", "float32"), ("grad_hist", "float32"),
                             ("patch", "bfloat16"),
                             ("grad_hist", "bfloat16")):
            scfg = Config(max_disparity=max_d, levels=levels, patch_size=p,
                          descriptor=kind, dtype=sdtype)
            sgeom = scfg.geometry(h0 * p, w0 * p)
            require((sgeom.grid_h, sgeom.grid_w) == (h0, w0)
                    and fused_cuda.supported(scfg, sgeom),
                    f"small tile {sgeom} not covered")
            fused_smem_agrees(f"K1 small p={p} {kind} {sdtype}", scfg, sgeom)
            if kind == "patch":
                planes = (sl_, sr_, scfg, sgeom)
            else:
                (lm, lb), (rm, rb) = map(descriptors.grad_hist_magbin,
                                         (sl_, sr_))
                planes = (lm, rm, scfg, sgeom, lb, rb)
            d, s_ = fused_cuda.match_planes(*planes)
            sync()
            dp, sp = fused_cuda.match_planes_torch(*planes)
            same = d == dp
            flips = float((~same).float().mean())
            serr = float((s_ - sp).abs()[same].max())
            print(f"K1 small tiles [{kind}, {sdtype}] p={p} {h0}x{w0} "
                  f"patches, max_d={max_d}, L={levels}: decisions flipped "
                  f"{flips:.3e}, max |score diff| where equal {serr:.3e}")
            require(flips <= FUSED_DECISION_TOL
                    and scores_agree(scfg, s_, sp, same),
                    f"K1 small tiles {kind} {sdtype} p={p} disagree with "
                    f"plain")
            if kind == "patch":
                witness(f"K1 small p={p} {h0}x{w0} {sdtype}", sl_, sr_, scfg,
                        sgeom, d, s_, required=p < 5)

    # 3a'. The cost-volume kernel (K2, K6): its shared memory as the
    # library computes it against costvol_cuda's mirror, at least 2 blocks
    # per SM at the bench, grad_hist and KITTI shapes, K2 at grad_hist
    # (C=128, 64 instances), and both layouts at small ragged shapes on
    # every staging form (profile_steps.costvol_cases).
    for label, c_, d0_, p_ in (("bench", 16, 64, 4), ("grad_hist", 128, 64, 4),
                               ("KITTI D=128", 16, 128, 4),
                               ("KITTI D=256", 16, 256, 4),
                               ("KITTI D=256 slab", 16, SLAB, 4)):
        smem_agrees(f"K2/K6 {label}", _build.library().dm_costvol_smem(
            c_, d0_, p_), costvol_cuda.smem_bytes(c_, d0_, p_))
        occ = {k: costvol_cuda.blocks_per_sm(c_, d0_, p_, rows=k == "K6",
                                             bf16=k == "K2 bf16")
               for k in ("K2", "K6", "K2 bf16")}
        print(f"K2/K6 {label} blocks per SM (occupancy API): {occ}")
        require(min(occ.values()) >= 2, f"K2/K6 {label}: fewer than 2 "
                f"blocks per SM")
        if label == "bench":
            rows["K2"]["blocks_per_sm"] = occ["K2"]
            rows["K2 bf16"]["blocks_per_sm"] = occ["K2 bf16"]
        if label == "grad_hist":
            occ_gh = occ
        if label == "KITTI D=256":
            occ_kitti = occ
    dsg = descriptors.left_descriptors(lefts, gh)
    dtg = descriptors.right_sliding_descriptors(rights, gh)
    volg = costvol_cuda.cost_volume_dmajor(dsg, dtg, *args2)
    sync()
    errg = float((volg - costvol_cuda.cost_volume_dmajor_torch(
        dsg, dtg, *args2)).abs().max())
    print(f"K2 C={dsg.shape[-1]} (grad_hist) {tuple(dsg.shape)} -> "
          f"{tuple(volg.shape)}: max |kernel - plain| = {errg:.3e}")
    require(errg <= 1e-6, f"K2 at grad_hist disagrees with its plain "
            f"version: {errg}")
    record("K2 C=128", errg,
           lambda: costvol_cuda.cost_volume_dmajor(dsg, dtg, *args2),
           lambda: costvol_cuda.cost_volume_dmajor_torch(dsg, dtg, *args2),
           work.k2(gh, geom, 2 * BATCH), plain_reps=1)
    corr_yardstick("K2 C=128", dsg, dtg, geom.disparities, cfg.patch_size)
    rows["K2 C=128"]["blocks_per_sm"] = occ_gh["K2"]
    dsg16, dtg16 = dsg.to(bf16), dtg.to(bf16)
    volg16, errg16 = k2_bf16("K2 C=128 bf16 (grad_hist)", dsg16, dtg16,
                             *args2)
    record("K2 C=128 bf16", errg16,
           lambda: costvol_cuda.cost_volume_dmajor(dsg16, dtg16, *args2),
           lambda: costvol_cuda.cost_volume_dmajor_torch(dsg16, dtg16,
                                                         *args2),
           work.k2(gh, geom, 2 * BATCH, "bfloat16"), plain_reps=1)
    rows["K2 C=128 bf16"]["blocks_per_sm"] = occ_gh["K2 bf16"]
    corr_yardstick("K2 C=128 bf16", dsg16, dtg16, geom.disparities,
                   cfg.patch_size)
    del dsg, dtg, volg, dsg16, dtg16, volg16
    small_err = 0.0
    for seed, (cname, kind, shape) in enumerate(costvol_cases()):
        if "p=" not in cname and "unaligned" not in cname:
            continue        # the full-width shapes are checked in 3a and 3c
        lead_, h0_, w0_, wt_, c_, d0_, p_, max_d_, rev_, oo_, dofs_, _ = shape
        src_, tgt_ = costvol_inputs(torch, shape, seed)
        got_ = costvol_launch(costvol_cuda, kind, shape, src_, tgt_)
        sync()
        if kind == "K2":
            want_ = costvol_cuda.cost_volume_dmajor_torch(
                src_, tgt_, d0_, p_, max_d_, rev_, oo_)
            same = True
        else:
            want_ = costvol.cost_volume_rows_torch(
                src_, tgt_, d0_, p_, max_d_, rev_, oo_, dofs_)
            same = torch.equal(got_.movedim(-2, -3),
                               costvol_cuda.cost_volume_dmajor(
                                   src_, tgt_, d0_ + dofs_, p_, max_d_, rev_,
                                   oo_)[..., dofs_:, :, :])
        err = float((got_ - want_).abs().max())
        small_err = max(small_err, err)
        print(f"{cname} (w0 {w0_}, wt {wt_}, d_offset {dofs_}): max |kernel "
              f"- plain| = {err:.3e}" + ("" if kind == "K2" else
                                         f"; bitwise K2's bins {same}"))
        require(err <= 1e-6 and same, f"{cname} disagrees")
    # K2's bf16 instance at every D-major shape, on the descriptors rounded
    # (both staging forms: C a multiple of 8 or not, and the pair off
    # 16-byte alignment; origin_offset 2 there).
    for seed, (cname, kind, shape) in enumerate(costvol_cases()):
        if kind == "K2":
            lead_, h0_, w0_, wt_, c_, d0_, p_, max_d_, rev_, oo_, _, _ = shape
            src_, tgt_ = costvol_inputs(torch, shape, seed, dtype=bf16)
            k2_bf16(f"{cname} bf16 (origin_offset {oo_})", src_, tgt_, d0_,
                    p_, max_d_, rev_, oo_)
            del src_, tgt_
    print()

    # 3b. K1 at the KITTI grid (the eval tool's -D 64 route, phase 4e):
    # both directions of the tool's first KITTI pair, as the tool pads it.
    _, _, el, er, _ = next(p_ for p_ in eval_pairs() if p_[0] == "kitti")
    ecfg = Config(max_disparity=64)
    egeom = ecfg.geometry(*el.shape)
    require((egeom.levels, egeom.grid_h, egeom.grid_w, egeom.disparities)
            == (4, 96, 384, 64) and fused_cuda.supported(ecfg, egeom),
            f"KITTI D=64 must take K1 on the 96x384 grid: {egeom}")
    fused_smem_agrees("K1 KITTI D=64", ecfg, egeom)
    el, er = both_directions(*(to_dev([x], ecfg, *x.shape)[0]
                               for x in (el, er)))
    fused_vs_plain("K1 KITTI", el, er, ecfg, egeom)
    del el, er

    # ... then K4 and K5 at the KITTI shapes, full width.
    kitti = {}
    for max_d, batch in KITTI.items():
        kcfg = Config(max_disparity=max_d)
        kgeom = kcfg.geometry(KH, KW)
        require((kgeom.levels, kgeom.padded_height, kgeom.padded_width,
                 kgeom.disparities) == (5, 384, 1536, max_d),
                f"KITTI geometry {kgeom}")
        require(not fused_cuda.supported(kcfg, kgeom)
                and not pyramid_cuda.supported(kgeom.disparities, kgeom.levels)
                and fused_cuda.cost_supported(kcfg, kgeom),
                f"KITTI D={max_d} must take the large-D route")
        fused_smem_agrees(f"K1 KITTI D={max_d}", kcfg, kgeom)
        smem_agrees(f"K4 KITTI D={max_d}",
                    _build.library().dm_cost_rows_smem(kcfg.patch_size, max_d),
                    fused_cuda.cost_smem_bytes(kcfg.patch_size, max_d))
        occ4 = fused_cuda.cost_blocks_per_sm(kcfg.patch_size, max_d)
        occ4b = fused_cuda.cost_blocks_per_sm(kcfg.patch_size, max_d,
                                              bf16=True)
        print(f"K4 KITTI D={max_d} blocks per SM (occupancy API): {occ4}; "
              f"its bf16 instance (the same layout): {occ4b}")
        require(min(occ4, occ4b) >= 2, f"K4 KITTI D={max_d}: "
                f"{(occ4, occ4b)} blocks per SM, fewer than 2")
        kp =[make_kitti_pair(i, max_d) for i in range(batch)]
        klp = to_dev([l for l, _, _ in kp], kcfg, KH, KW)
        krp = to_dev([r for _, r, _ in kp], kcfg, KH, KW)
        kitti[max_d] = (kcfg, kgeom, klp, krp)
        kl, kr = both_directions(klp, krp)
        kvol = fused_cuda.cost_volume_rows(kl, kr, kcfg, kgeom)
        sync()
        kvol_p = fused_cuda.cost_volume_torch(kl, kr, kcfg, kgeom)
        err4 = float((kvol - kvol_p).abs().max())
        print(f"K4 D={max_d} {tuple(kl.shape)} -> {tuple(kvol.shape)}: "
              f"max |kernel - plain| = {err4:.3e}")
        require(err4 <= 2e-5, f"K4 disagrees with its plain version: {err4}")
        if max_d == 128:
            k4_occ = occ4
            record("K4", err4,
                   lambda: fused_cuda.cost_volume_rows(kl, kr, kcfg, kgeom),
                   lambda: fused_cuda.cost_volume_torch(kl, kr, kcfg, kgeom),
                   work.k4(kcfg, kgeom, 2 * batch), plain_reps=1)
        # K4's bfloat16 instance: the same costs, each rounded as stored.
        kcfg16 = dataclasses.replace(kcfg, dtype="bfloat16")
        kvol16 = fused_cuda.cost_volume_rows(kl, kr, kcfg16, kgeom)
        sync()
        same16 = kvol16.dtype == torch.bfloat16 and torch.equal(
            kvol16, kvol.to(torch.bfloat16))
        err16 = float((kvol16.float() - kvol_p.to(torch.bfloat16).float())
                      .abs().max())
        del kvol_p
        print(f"K4 bf16 D={max_d} -> {tuple(kvol16.shape)} "
              f"{kvol16.dtype}: bitwise K4's float32 volume rounded {same16}, "
              f"max |bf16 - plain rounded| = {err16:.3e} "
              f"({nbytes(kvol16) / 1e6:.1f} MB against {nbytes(kvol) / 1e6:.1f}"
              f" MB)")
        require(same16, "K4 bf16 is not K4's volume rounded to bf16")
        if max_d == 128:
            k4b_occ = occ4b
            record("K4 bf16", err16,
                   lambda: fused_cuda.cost_volume_rows(kl, kr, kcfg16, kgeom),
                   lambda: fused_cuda.cost_volume_torch(
                       kl, kr, kcfg, kgeom).to(torch.bfloat16),
                   work.k4(kcfg16, kgeom, 2 * batch), plain_reps=1)
            # The port never calls torch.pow on a bf16 tensor (pool.rectify
            # takes the exponent as given); whether torch on the card rounds
            # a scalar exponent to bf16 there, as it does on the CPU, is
            # printed for the record.
            sample = kvol16[0, :4].reshape(-1)
            lam16 = pool.map_lam(kcfg.lam, torch.bfloat16)
            cuda_pow = torch.pow(sample, kcfg.lam)
            eq16, eq32 = (float((cuda_pow == pool.rectify(sample, e))
                                .float().mean()) for e in (lam16, kcfg.lam))
            print(f"torch.pow on a bf16 CUDA tensor at lam {kcfg.lam}: equal "
                  f"to the f32 pow rounded at {lam16} on {eq16:.6f}, at "
                  f"{kcfg.lam} on {eq32:.6f} of {sample.numel()} values")
            del sample, cuda_pow   # a view of the volume: it would outlive it
        for key, vol_ in (("K5", kvol), ("K5 bf16", kvol16)):
            for fast in (True, False):
                _build.launches.clear()
                top, args = pyramid_cuda.aggregate_dmajor(
                    vol_, kgeom.levels, kcfg.lam, fast)
                sync()
                n_l = sum(_build.launches.values())
                require(n_l == 1, f"{key}: {n_l} launches for one call")
                top_p, args_p = pyramid_cuda.aggregate_dmajor_torch(
                    vol_, kgeom.levels, kcfg.lam, fast)
                args_eq = all(torch.equal(a, b) for a, b in zip(args, args_p))
                top_eq = top.dtype == vol_.dtype and torch.equal(top, top_p)
                err5 = float((top.float() - top_p.float()).abs().max())
                print(f"{key} D={max_d} {'fast' if fast else 'exact'}: top "
                      f"{tuple(top.shape)} {top.dtype} bitwise {top_eq}, max "
                      f"|diff| {err5:.3e}; offsets equal {args_eq}")
                require(args_eq and top_eq,
                        f"{key} disagrees with its plain version")
                if max_d == 128 and fast:
                    record(key, err5,
                           lambda vol_=vol_: pyramid_cuda.aggregate_dmajor(
                               vol_, kgeom.levels, kcfg.lam, True),
                           lambda vol_=vol_:
                           pyramid_cuda.aggregate_dmajor_torch(
                               vol_, kgeom.levels, kcfg.lam, True),
                           work.k5(kcfg, kgeom, 2 * batch,
                                       "bfloat16" if vol_.dtype == bf16
                                       else "float32"))
                    rows[key]["device_ms"] = device_ms(
                        torch, lambda vol_=vol_: pyramid_cuda.aggregate_dmajor(
                            vol_, kgeom.levels, kcfg.lam, True), "aggregate")
                    require(rows[key]["device_ms"] > 0,
                            f"{key}: no device time in the profiler")
                if max_d == 128 and not fast and key == "K5":
                    # The exact mode (KITTI `exact`, dslab): a row of its own.
                    record("K5 exact", err5,
                           lambda: pyramid_cuda.aggregate_dmajor(
                               kvol, kgeom.levels, kcfg.lam, False),
                           lambda: pyramid_cuda.aggregate_dmajor_torch(
                               kvol, kgeom.levels, kcfg.lam, False),
                           work.k5(kcfg, kgeom, 2 * batch))
        # K5's block: shared memory against its mirror and blocks per SM,
        # in each dtype and mode (the 16-byte form these volumes take).
        for key, dt in (("K5", torch.float32), ("K5 bf16", bf16)):
            smem_agrees(f"{key} L={kgeom.levels}",
                        _build.library().dm_aggregate_smem(
                            kgeom.levels, int(dt == bf16)),
                        pyramid_cuda.aggregate_smem_bytes(kgeom.levels, dt))
            occ5 = {mode: pyramid_cuda.aggregate_blocks_per_sm(
                        kgeom.levels, dt == bf16, mode == "fast")
                    for mode in ("fast", "exact")}
            print(f"{key} KITTI D={max_d}: blocks per SM (occupancy API) "
                  f"{occ5}; {pyramid_cuda.aggregate_blocks(2 * batch, 96, 384)}"
                  f" blocks of {pyramid_cuda.aggregate_threads()} threads in "
                  f"one launch")
            require(min(occ5.values()) >= 2,
                    f"{key}: {occ5} blocks per SM, fewer than 2")
            if max_d == 128:
                rows[key]["blocks_per_sm"] = occ5["fast"]
                if key == "K5":
                    rows["K5 exact"]["blocks_per_sm"] = occ5["exact"]
        del kvol, kvol16, top, top_p, args, args_p

    # K4 on a grid of ragged 8x32-patch tiles, with a masked plane.
    rcfg = Config(max_disparity=RAGGED_D, levels=2)
    rgeom = rcfg.geometry(*RAGGED_HW)
    require(rgeom.grid_h % 8 and rgeom.grid_w % 32
            and rgeom.disparities > rcfg.max_disparity,
            f"ragged K4 geometry {rgeom}")
    rng = np.random.default_rng(5)
    rl, rr = (torch.from_numpy(rng.random(
        (4, rgeom.padded_height, rgeom.padded_width), dtype=np.float32)).to(dev)
        for _ in range(2))
    rvol = fused_cuda.cost_volume_rows(rl, rr, rcfg, rgeom)
    sync()
    err4r = float((rvol - fused_cuda.cost_volume_torch(rl, rr, rcfg, rgeom))
                  .abs().max())
    print(f"K4 ragged grid {rgeom.grid_h}x{rgeom.grid_w} D0="
          f"{rgeom.disparities} max_d={rcfg.max_disparity} {tuple(rl.shape)}: "
          f"max |kernel - plain| = {err4r:.3e}")
    require(err4r <= 2e-5, f"K4 disagrees with its plain version on a "
            f"ragged grid: {err4r}")
    rvol16 = fused_cuda.cost_volume_rows(
        rl, rr, dataclasses.replace(rcfg, dtype="bfloat16"), rgeom)
    sync()
    same16 = torch.equal(rvol16, rvol.to(torch.bfloat16))
    print(f"K4 bf16 ragged grid: bitwise K4's volume rounded {same16}")
    require(same16, "K4 bf16 on a ragged grid is not K4's volume rounded")
    del rvol, rvol16
    rows["K4"]["blocks_per_sm"] = k4_occ
    rows["K4 bf16"]["blocks_per_sm"] = k4b_occ
    # ... and on ragged grids at the runtime-p instance (p 3, 5, 6, 7) and
    # at D0 not a multiple of 4.
    for seed, (cname, kind, shape) in enumerate(rows_cases()):
        if not cname.startswith("K4 ragged") or "28x76" in cname:
            continue
        n_, h0_, w0_, p_, d0_, max_d_ = shape
        smem_agrees(cname, _build.library().dm_cost_rows_smem(p_, max_d_),
                    fused_cuda.cost_smem_bytes(p_, max_d_))
        inputs_ = rows_inputs(torch, kind, shape, seed)
        got_ = rows_launch(kind, shape, inputs_)
        sync()
        err = float((got_ - rows_launch(kind, shape, inputs_, plain=True))
                    .abs().max())
        got16 = rows_launch(kind, shape, inputs_, dtype="bfloat16")
        sync()
        same16 = torch.equal(got16, got_.to(torch.bfloat16))
        print(f"{cname} {shape}: max |kernel - plain| = {err:.3e}; bf16 "
              f"instance bitwise the float32 volume rounded {same16}")
        require(err <= 2e-5, f"{cname} disagrees with its plain version: "
                f"{err}")
        require(same16, f"{cname}: K4 bf16 is not K4's volume rounded")
        del inputs_, got_, got16

    # ... and K5 at every other K5 shape of rows_cases (L 1-6, ragged tile
    # counts, D0 = 2^L and D0 not a multiple of 32, the narrow form at W0 =
    # 2 mod 4 (L = 1), 4 mod 8 (L = 2, bf16) and off 16-byte alignment,
    # dslab's bench volume): top and offsets bitwise plain in both modes
    # and dtypes, on real-valued and tie-heavy volumes, one launch a call
    # (two at L = 6).
    for seed, (cname, kind, shape) in enumerate(rows_cases()):
        if kind != "K5" or cname.startswith("K5 kitti"):
            continue
        flat_ = rows_inputs(torch, kind, shape, seed)
        forms = set()
        for dtype in ("float32", "bfloat16"):
            for fast in (True, False):
                for x_ in flat_:
                    vol_ = k5_volume(shape, x_, dtype)
                    forms.add(pyramid_cuda.aggregate_vec(
                        shape[3], vol_.dtype, vol_.data_ptr()))
                    _build.launches.clear()
                    out_ = k5_launch(shape, vol_, fast)
                    sync()
                    n_l = sum(_build.launches.values())
                    same = all(torch.equal(a, b) for a, b in zip(
                        out_, k5_launch(shape, vol_, fast, plain=True)))
                    require(same, f"{cname} {dtype} "
                            f"{'fast' if fast else 'exact'} disagrees with "
                            f"its plain version")
                    require(n_l == pyramid_cuda.aggregate_launches(shape[4]),
                            f"{cname}: {n_l} launches for one call")
        print(f"{cname} {shape[:5]} offset {shape[5]}: top and offsets "
              f"bitwise plain in both modes and dtypes, on real and tie-heavy "
              f"volumes; {pyramid_cuda.aggregate_launches(shape[4])} "
              f"launch(es) a call; forms "
              f"{sorted('16-byte' if f else 'narrow' for f in forms)}")
        del flat_, vol_, out_

    # 3c. K6, the row-layout slab cost volume: KITTI D=256, whole range and
    # 64-bin slabs, against its plain version and K2.
    kcfg6, kgeom6, klp6, krp6 = kitti[256]
    kl6, kr6 = both_directions(klp6, krp6)      # (2, 4, Hp, Wp): 8 instances
    ds6 = descriptors.left_descriptors(kl6, kcfg6)
    dt6 = descriptors.right_sliding_descriptors(kr6, kcfg6)
    d6, args6 = kgeom6.disparities, (kcfg6.patch_size, kcfg6.max_disparity)

    def k6_vs_plain(label, src, tgt, d, p_max, **kw):
        vol = costvol_cuda.cost_volume_rows(src, tgt, d, *p_max, **kw)
        sync()
        err = float((vol - costvol.cost_volume_rows_torch(
            src, tgt, d, *p_max, **kw)).abs().max())
        print(f"K6 {label} {tuple(vol.shape)}: max |kernel - plain| = "
              f"{err:.3e}")
        require(err <= 1e-6, f"K6 {label} disagrees with its plain version: "
                f"{err}")
        return vol, err

    err6 = 0.0
    for reverse in (False, True):
        way = "reverse" if reverse else "forward"
        whole, err = k6_vs_plain(f"D={d6} {way}", ds6, dt6, d6, args6,
                                 reverse=reverse)
        err6 = max(err6, err)
        slabs = []
        for k in range(d6 // SLAB):
            vol, err = k6_vs_plain(f"slab d_offset={k * SLAB} {way}", ds6,
                                   dt6, SLAB, args6, reverse=reverse,
                                   d_offset=k * SLAB)
            slabs.append(vol)
            err6 = max(err6, err)
        k2 = costvol_cuda.cost_volume_dmajor(ds6, dt6, d6, *args6,
                                             reverse=reverse)
        joined = torch.equal(torch.cat(slabs, -2).movedim(-2, -3), k2)
        same = torch.equal(whole.movedim(-2, -3), k2)
        print(f"K6 {way}: slabs joined along D bitwise equal to K2 {joined}; "
              f"whole range bitwise equal to K2 {same}")
        require(joined and same, "K6 is not bitwise K2's volume")
        del whole, slabs, k2
    record("K6", err6,
           lambda: costvol_cuda.cost_volume_rows(ds6, dt6, d6, *args6),
           lambda: costvol.cost_volume_rows_torch(ds6, dt6, d6, *args6),
           work.k6(kcfg6, kgeom6, math.prod(kl6.shape[:-2])),
           plain_reps=1)
    rows["K6"]["blocks_per_sm"] = occ_kitti["K6"]
    corr_yardstick("K6", ds6, dt6, d6, kcfg6.patch_size)
    # K2 on the same KITTI D=256 descriptors: one kernel in both layouts.
    k2k = costvol_cuda.cost_volume_dmajor(ds6, dt6, d6, *args6)
    sync()
    errk = float((k2k - costvol_cuda.cost_volume_dmajor_torch(
        ds6, dt6, d6, *args6)).abs().max())
    require(errk <= 1e-6, f"K2 at KITTI D=256 disagrees: {errk}")
    record("K2 KITTI", errk,
           lambda: costvol_cuda.cost_volume_dmajor(ds6, dt6, d6, *args6),
           lambda: costvol_cuda.cost_volume_dmajor_torch(ds6, dt6, d6,
                                                         *args6),
           work.k2(kcfg6, kgeom6, math.prod(kl6.shape[:-2])),
           plain_reps=1)
    rows["K2 KITTI"]["blocks_per_sm"] = occ_kitti["K2"]
    rows["K2 KITTI"]["library"] = rows["K6"]["library"]
    rows["K2 KITTI"]["library_extra_bytes"] = rows["K6"]["library_extra_bytes"]
    print(f"K2 D={d6} {tuple(k2k.shape)}: max |kernel - plain| = "
          f"{errk:.3e}; kernel {rows['K2 KITTI']['ms']:.4f} ms beside K6's "
          f"{rows['K6']['ms']:.4f} ms on the same descriptors {card}")
    del ds6, dt6, k2k
    # At the bench shapes, on a target extended by a W-tile's halo.
    halo_q = wtiled.halo_patches(cfg)
    dsb = descriptors.left_descriptors(lefts, cfg)
    dtb = descriptors.right_sliding_descriptors(rights, cfg)
    pad_px = cfg.patch_size * halo_q
    dtb_ext = F.pad(dtb, (0, 0, pad_px, pad_px))
    for reverse in (False, True):
        vol, err = k6_vs_plain(
            f"bench halo origin_offset={halo_q} "
            f"{'reverse' if reverse else 'forward'}", dsb, dtb_ext,
            geom.disparities, (cfg.patch_size, cfg.max_disparity),
            reverse=reverse, origin_offset=halo_q)
        err6 = max(err6, err)
        same = torch.equal(vol.movedim(-2, -3), costvol_cuda.cost_volume_dmajor(
            dsb, dtb, *args2, reverse=reverse))
        print(f"  bitwise equal to K2 on the unextended target: {same}")
        require(same, "K6 on a halo target is not K2's volume")
    rows["K6"]["err"] = err6
    del dsb, dtb, dtb_ext, vol
    for k in ("K1", "K1b", "K2", "K3"):
        was = f" (earlier: {EARLIER_MS[k]} ms)" if k in EARLIER_MS else ""
        print(f"  {k}: kernel {rows[k]['ms']:.4f} ms{was}, plain "
              f"{rows[k]['plain']:.4f} ms per 64-instance bench call {card}")
    print(f"  K4: kernel {rows['K4']['ms']:.4f} ms (earlier: "
          f"{EARLIER_MS['K4']} ms), "
          f"plain {rows['K4']['plain']:.4f} ms per 16-instance KITTI D=128 "
          f"call {card}")
    print(f"  K1 KITTI: kernel {rows['K1 KITTI']['ms']:.4f} ms, plain "
          f"{rows['K1 KITTI']['plain']:.4f} ms per 2-instance KITTI D=64 "
          f"call (one eval pair, both directions) {card}")
    print(f"  K5 exact: kernel {rows['K5 exact']['ms']:.4f} ms beside K5 "
          f"fast's {rows['K5']['ms']:.4f} ms, plain "
          f"{rows['K5 exact']['plain']:.4f} ms per 16-instance KITTI D=128 "
          f"call {card}")
    for k in ("K5", "K5 bf16"):
        print(f"  {k}: kernel {rows[k]['ms']:.4f} ms event, "
              f"{rows[k]['device_ms']:.4f} ms device (earlier: "
              f"{EARLIER_MS[k]} ms event, five launches), plain "
              f"{rows[k]['plain']:.4f} ms per 16-instance KITTI D=128 call "
              f"(fast, 5 levels, one launch) {card}")
    for k, what in (("K1", "64-instance bench"),
                    ("K1b", "64-instance grad_hist bench"),
                    ("K2", "64-instance bench"),
                    ("K2 C=128", "64-instance grad_hist"),
                    ("K3", "64-instance bench"),
                    ("K4", "16-instance KITTI D=128"),
                    ("K5", "16-instance KITTI D=128 (fast)")):
        b = rows[f"{k} bf16"]
        print(f"  {k} bf16: kernel {b['ms']:.4f} ms beside {k}'s "
              f"{rows[k]['ms']:.4f} ms (float32), plain {b['plain']:.4f} ms "
              f"per {what} call {card}")
    print(f"  K2 C=128: kernel {rows['K2 C=128']['ms']:.4f} ms (earlier: "
          f"{EARLIER_MS['K2 C=128']} ms), plain "
          f"{rows['K2 C=128']['plain']:.4f} ms per 64-instance grad_hist "
          f"call {card}")
    for k in ("K6", "K2 KITTI"):
        was = f" (earlier: {EARLIER_MS[k]} ms)" if k in EARLIER_MS else ""
        print(f"  {k}: kernel {rows[k]['ms']:.4f} ms{was}, plain "
              f"{rows[k]['plain']:.4f} ms per 8-instance KITTI D=256 call "
              f"(whole range) {card}")
    print(flush=True)

    path_launches = {}     # path -> its launches (a Counter), by kernel

    def clear_and_run(label, fn):
        """fn() with the launch counts cleared just before it and read just
        after, into path_launches[label]."""
        _build.launches.clear()
        out = fn()
        sync()
        path_launches[label] = _build.launches.copy()
        return out, path_launches[label]

    def launched(counts):
        """The kernels of a path's counts but PLANES and EPI, which are
        counted on every path and held to their launches by their card
        tests (one a call; EPI one a step), not to each path's set."""
        return {k for k, n in counts.items() if n > 0} - {"PLANES", "EPI"}

    def run_path(label, expected, fn):
        """fn() as a path of its own, which must launch exactly the
        `expected` kernels."""
        out, counts = clear_and_run(label, fn)
        print(f"launch counts [{label}]: {dict(counts)}")
        require(launched(counts) == set(expected),
                f"path [{label}] launched {sorted(launched(counts))}, "
                f"expected {sorted(expected)}")
        return out

    # 3d. P1-P3 through the probe's entry point, then each against its
    # plain version at its full repetitions.
    sass = probe_sass(so)
    if sass is None:
        print("probe SASS: no cuobjdump in the toolkit, not checked")
    for key in PROBE_SASS:
        if sass is not None:
            c = sass.get(key)
            print(f"probe SASS {key}: {c}")
            require(c is not None and c["FFMA"] == 0 and c["FMUL"] >= 256
                    and c["FMUL"] % 256 == 0,
                    f"{key}: products merged or contracted in SASS: {c}")
    if sass is not None:
        # P3's mix per repetition (its body may be compiled more than once):
        # 256 FMUL and the 31 + 88 shared loads of its operands and windows.
        reps_ = sass["P3"]["FMUL"] // 256
        lds = sass["P3"]["LDS"] / reps_
        print(f"P3 per repetition in SASS: {sass['P3']['FMUL'] // reps_} FMUL,"
              f" {sass['P3']['FADD'] / reps_:g} FADD, "
              f"{sass['P3']['FFMA']} FFMA, {lds:g} LDS")
        require(lds == probe_cuda.SHIFT_ALIGNED_READS
                + probe_cuda.SHIFT_WINDOW_READS,
                f"P3 reads {lds} shared words a repetition, not 119")
    p3_occ, p3_grid = probe_cuda.shift_occupancy()
    print(f"P3: {p3_occ} blocks per SM (occupancy API), {p3_grid} persistent "
          f"blocks over {probe_cuda.SHIFT_ROWS} x "
          f"{2 * probe_cuda.GRID // probe_cuda.PROBES['shift'][3]} items; "
          f"{probe_ptxas['shift_kernel'][0]} registers, no spills")
    with tempfile.TemporaryDirectory() as tmp:
        probe_out = os.path.join(tmp, "probe.jsonl")
        probe_rc = run_path("probe", PROBE_NAMES,
                            lambda: vpu_probe.main(["--out", probe_out]))
        with open(probe_out) as f:
            probe_rows = [json.loads(line) for line in f]
    require(probe_rc == 0, f"vpu_probe exited {probe_rc}")
    probe_rows = {r["probe"]: r for r in probe_rows}
    for key, probe in PROBE_NAMES.items():
        r = probe_rows[probe]
        require(r["fraction_of_67_tflops"] <= vpu_probe.MERGED_WORK,
                f"{key} above {vpu_probe.MERGED_WORK} of 67 TFLOP/s")
        a = probe_cuda.make_input(probe, dev)
        got = probe_cuda.KERNELS[probe](a)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = probe_cuda.PLAIN[probe](a)
        end.record()
        sync()
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        print(f"{key} probe [{probe}] {tuple(a.shape)} -> {tuple(got.shape)} "
              f"x{r['repetitions']} ({r['repetitions_per_thread']} per "
              f"thread): bitwise equal to plain {same}; median "
              f"{r['seconds']['median'] * 1e3:.4f} ms "
              f"[{r['seconds']['min'] * 1e3:.4f}.."
              f"{r['seconds']['max'] * 1e3:.4f}] = "
              f"{r['achieved_flop_per_s'] / 1e12:.3f} TFLOP/s, "
              f"{r['fraction_of_67_tflops']:.4f} of 67, "
              f"{r['fraction_of_33_5_tflops']:.4f} of 33.5 (no FMA); "
              f"{r['bytes_read']} B read, {r['l2_bytes']} B from L2; plain "
              f"{start.elapsed_time(end):.1f} ms {card}")
        require(same, f"{key} disagrees with its plain version: {err}")
        rows[key] = dict(err=err, ms=r["seconds"]["median"] * 1e3,
                         plain=start.elapsed_time(end),
                         work=work.probe(probe))
    for key, fn in (("P1", "stream_kernelILi384E"),
                    ("P2", "stream_kernelILi96E"), ("P3", "shift_kernel")):
        rows[key]["registers"] = probe_ptxas[fn][0]
    # P3's issue-rate ceiling: its warp-instructions (FP32 and shared loads
    # of every repetition) at one per scheduler, four per SM, per clock of
    # the card's top SM clock.  A ceiling of the mix, not a bound.
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    per_rep = (probe_cuda.SHIFT_FMUL + probe_cuda.SHIFT_FADD
               + probe_cuda.SHIFT_ALIGNED_READS + probe_cuda.SHIFT_WINDOW_READS
               if sass is None else (sass["P3"]["FMUL"] + sass["P3"]["FADD"]
                                     + sass["P3"]["LDS"]) / reps_)
    warp_reps = (2 * probe_cuda.GRID * probe_cuda.SHIFT_ROWS * probe_cuda.W0
                 // 32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ceiling = warp_reps * per_rep / (sms * 4 * clock_mhz * 1e6) * 1e3
    rows["P3"].update(blocks_per_sm=p3_occ, issue_ceiling_ms=ceiling)
    print(f"P3: {rows['P3']['ms']:.4f} ms (earlier: {EARLIER_MS['P3']} ms); "
          f"issue-rate ceiling {ceiling:.4f} ms ({per_rep:g} warp-instructions"
          f" a repetition, {sms} SMs x 4 at {clock_mhz:g} MHz), "
          f"{ceiling / rows['P3']['ms']:.3f} of it {card}")
    print(flush=True)

    # 3e. The prep kernel: the stream's grayscale and pad on the card.
    prep_phase(run_path, dev, card, rows)
    # 3f. K4b: grad_hist's large-D cost volume.
    k4b_phase(run_path, dev, card, rows)
    # 3g. PLANES: grad_hist's (magnitude, bin) planes.
    planes_phase(run_path, dev, card, rows)
    # 3h. The card tests, in their own process.
    card_tests_passed = card_tests_phase(card)
    # 3i. EPI: the step's LR check, densify and five outputs.
    epilogue_phase(dev, card, rows)

    # 4. Main path through the public API, against the oracle.
    kcfg = kitti[128][0]
    kleft, kright, kgt = make_kitti_pair(KITTI_SEED, 128)
    cases = [("bench", s, cfg, make_pair(s)) for s in MAIN_PATH_SEEDS]
    cases.append(("kitti", KITTI_SEED, kcfg, (kleft, kright, kgt)))
    cases += [("grad_hist", s, gh, make_pair(s)) for s in MAIN_PATH_SEEDS]
    want = {}
    for case, seed, ccfg, (left, right, _) in cases:
        t0 = time.perf_counter()
        want[case, seed] = oracle.match_stereo(left, right, ccfg)
        print(f"oracle [{case}] pair {seed}: "
              f"{time.perf_counter() - t0:.1f} s (host)")
    # The kernels each path launches, and no others (routing is decided by
    # the configuration).  Each path's counts are set to 0 just before it
    # runs and read just after.
    path_kernels = {("bench", "fused"): {"K1"},
                    ("bench", "exact"): {"K2", "K3"},
                    ("kitti", "fused"): {"K4", "K5"},
                    ("kitti", "exact"): {"K2", "K5 exact"},
                    ("grad_hist", "fused"): {"K1b"},
                    ("grad_hist", "exact"): {"K2", "K3"}}
    results = {}

    def drive(path, route):
        for case, seed, ccfg, (left, right, _) in cases:
            if case == path:
                results[case, seed, route] = api.match_stereo(
                    left, right, ccfg, impl=route, device="cuda")

    for (path, route), expected in path_kernels.items():
        run_path(f"{path} {route}", expected,
                 lambda path=path, route=route: drive(path, route))
    for case, seed, ccfg, (left, right, gt) in cases:
        w_ = want[case, seed]
        hh, ww = left.shape[:2]
        d0 = ccfg.geometry(hh, ww).disparities
        for route in ("fused", "exact"):
            got = results[case, seed, route]
            require(got.disparity.shape == (hh, ww),
                    f"shape {got.disparity.shape}")
            require(np.isfinite(got.score).all(), "non-finite scores")
            require(((got.disparity_raw >= 0)
                     & (got.disparity_raw < d0)).all(),
                    "disparity bin out of range")
            raw_neq = float(np.mean(got.disparity_raw != w_.disparity_raw))
            val_neq = float(np.mean(got.valid != w_.valid))
            bad_g = metrics.bad_pixel_rate(got.disparity, gt,
                                           count_invalid=False)
            bad_o = metrics.bad_pixel_rate(w_.disparity, gt,
                                           count_invalid=False)
            serr = float(np.abs(got.score - w_.score).max())
            print(f"main path [{case}, {route}] pair {seed}: "
                  f"raw_neq={raw_neq:.3e} valid_neq={val_neq:.3e} "
                  f"bad_gpu={bad_g:.4f} bad_oracle={bad_o:.4f} "
                  f"coverage={metrics.coverage(got.disparity):.4f} "
                  f"max|dscore|={serr:.3e}")
            within_gate = (raw_neq <= FUSED_DECISION_TOL
                           and val_neq <= FUSED_DECISION_TOL
                           and abs(bad_g - bad_o) <= FUSED_DECISION_TOL)
            if case == "bench" and route == "exact":
                require(raw_neq == 0.0 and val_neq == 0.0
                        and np.array_equal(got.disparity, w_.disparity,
                                           equal_nan=True)
                        and np.array_equal(got.disparity_right,
                                           w_.disparity_right)
                        and np.allclose(got.score, w_.score, rtol=1e-5),
                        f"exact route not bitwise on decisions on pair {seed}")
            elif case == "kitti" and route == "exact":
                require(raw_neq == 0.0 and val_neq == 0.0,
                        f"KITTI exact route off the oracle on pair {seed}")
            else:
                require(within_gate, f"{case} {route} route beyond the "
                        f"decision gate on pair {seed}")
    print(flush=True)

    # 4b. Centred descriptors: 'fused' takes the descriptor route.
    ccfg = Config(max_disparity=MAX_D, center_descriptors=True)
    bench_pairs = [c[3] for c in cases if c[0] == "bench"]
    centred = run_path("centred fused", {"K2", "K3"}, lambda: [
        api.match_stereo(l, r, ccfg, impl="fused", device="cuda")
        for l, r, _ in bench_pairs])
    for seed, (l, r, _), got in zip(MAIN_PATH_SEEDS, bench_pairs, centred):
        w_ = oracle.match_stereo(l, r, ccfg)
        raw_neq = float(np.mean(got.disparity_raw != w_.disparity_raw))
        val_neq = float(np.mean(got.valid != w_.valid))
        print(f"centred [bench, fused] pair {seed}: raw_neq={raw_neq:.3e} "
              f"valid_neq={val_neq:.3e} max|dscore|="
              f"{float(np.abs(got.score - w_.score).max()):.3e}")
        require(raw_neq == 0.0 and val_neq == 0.0,
                f"centred descriptors off the oracle on pair {seed}")
    # ... and on adversarial pairs, whose flat windows centre to exact
    # zeros only where the patch mean is summed in the oracle's order.
    acfg = Config(max_disparity=ADV_D, center_descriptors=True)
    ageom = acfg.geometry(*ADV_HW)
    adv = [synthetic.adversarial_pair(*ADV_HW, ADV_D, s)[:2]
           for s in ADV_SEEDS]
    adv_want = [oracle.match_stereo(l, r, acfg) for l, r in adv]
    adv_kernels = {"K2", "K3" if pyramid_cuda.supported(
        ageom.disparities, ageom.levels) else "K5 exact"}
    for route in ("exact", "fused"):
        got_adv = run_path(f"centred adversarial {route}", adv_kernels,
                           lambda route=route: [
                               api.match_stereo(l, r, acfg, impl=route,
                                                device="cuda")
                               for l, r in adv])
        for seed, got, w_ in zip(ADV_SEEDS, got_adv, adv_want):
            raw_neq = int(np.sum(got.disparity_raw != w_.disparity_raw))
            val_neq = int(np.sum(got.valid != w_.valid))
            print(f"centred [adversarial {ADV_HW[1]}x{ADV_HW[0]} D="
                  f"{ADV_D}, {route}] seed {seed}: raw_neq={raw_neq} "
                  f"valid_neq={val_neq} of {got.valid.size} px")
            require(raw_neq == 0 and val_neq == 0, f"centred adversarial "
                    f"{route} off the oracle on seed {seed}")

    # 4b'. bfloat16 through the public API (the JAX package's bf16 rows:
    # bench.py's at the bench geometry, tools/bench_large.py's at KITTI
    # D=256), held to the oracle's kept bad rate + 0.05 and to
    # BF16_F32_AGREE with the port's float32 run of the same route.
    def check_bf16(label, route, got, f32, ora, gt):
        hh, ww = gt.shape
        bad = metrics.bad_pixel_rate(got.disparity, gt, count_invalid=False)
        bad_o = metrics.bad_pixel_rate(ora.disparity, gt, count_invalid=False)
        both = got.valid & f32.valid
        agree = float(np.mean(got.disparity_raw[both]
                              == f32.disparity_raw[both]))
        agree_all = float(np.mean(got.disparity_raw == f32.disparity_raw))
        print(f"bf16 [{label}, {route}]: kept bad {bad:.4f} (oracle "
              f"{bad_o:.4f}, delta {bad - bad_o:+.4f}); disparity_raw agrees "
              f"with float32 on {agree:.5f} of pixels valid in both "
              f"({agree_all:.5f} of all; {int(both.sum())} px valid in "
              f"both, {int((got.disparity_raw[both] != f32.disparity_raw[both]).sum())} "
              f"differ); valid_neq vs float32 "
              f"{float(np.mean(got.valid != f32.valid)):.3e}; coverage "
              f"{metrics.coverage(got.disparity):.4f}")
        require(got.disparity.shape == (hh, ww)
                and got.disparity.dtype == np.float32
                and got.score.dtype == np.float32
                and np.isfinite(got.score).all(),
                f"bf16 {label}: outputs not finite float32 of the image's "
                f"shape")
        require(bad - bad_o <= 0.05 and agree >= BF16_F32_AGREE,
                f"bf16 {label} {route} beyond its gates")

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    bf16_paths = {("bench", "fused"): (cfg16, {"K1 bf16"}),
                  ("bench", "exact"): (cfg16, {"K2 bf16", "K3 bf16"}),
                  ("grad_hist", "fused"): (gh16, {"K1b bf16"}),
                  ("grad_hist", "exact"): (gh16, {"K2 bf16", "K3 bf16"})}
    for (path, route), (pcfg, expected) in bf16_paths.items():
        got16 = run_path(f"{path} bf16 {route}", expected,
                         lambda pcfg=pcfg, route=route: [
                             api.match_stereo(l, r, pcfg, impl=route,
                                              device="cuda")
                             for l, r, _ in bench_pairs])
        for seed, (_, _, gt), got in zip(MAIN_PATH_SEEDS, bench_pairs, got16):
            check_bf16(f"{path} pair {seed}", route, got,
                       results[path, seed, route], want[path, seed], gt)
    k256 = Config(max_disparity=256)
    k256_16 = dataclasses.replace(k256, dtype="bfloat16")
    kl7, kr7, kgt7 = make_kitti_pair(KITTI_SEED, 256)
    kitti_runs = {}
    for route, k32, k16 in (("fused", {"K4", "K5"}, {"K4 bf16", "K5 bf16"}),
                            ("exact", {"K2", "K5 exact"},
                             {"K2 bf16", "K5 bf16"})):
        kitti_runs[route] = [
            run_path(f"kitti D=256 {tag}{route}", exp,
                     lambda kc=kc, route=route: api.match_stereo(
                         kl7, kr7, kc, impl=route, device="cuda"))
            for tag, kc, exp in (("", k256, k32), ("bf16 ", k256_16, k16))]
    t0 = time.perf_counter()
    kora = oracle.match_stereo(kl7, kr7, k256)
    print(f"oracle [kitti D=256] pair {KITTI_SEED}: "
          f"{time.perf_counter() - t0:.1f} s (host)")
    for route, (k32_, k16_) in kitti_runs.items():
        check_bf16(f"KITTI D=256 pair {KITTI_SEED}", route, k16_, k32_, kora,
                   kgt7)
    try:
        api.match_stereo(*bench_pairs[0][:2],
                         dataclasses.replace(cfg, dtype="float16"),
                         impl="exact", device="cuda")
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    print(f"float16: raises {refused!r}")
    require(refused is not None and "float16" in refused,
            "a float16 config did not raise its NotImplementedError")
    del kitti_runs, kora

    # 4b''. Centred descriptors and lr_mode 'direct' in bf16 (the descriptor
    # route, K2 bf16 -> K3 bf16) on bench pairs 100/101 and the adversarial
    # pairs, against the port's plain route on the CPU: the kernels and the
    # plain versions sum each bin in other orders, so a bin may round to a
    # neighbouring bf16 value; decisions within the 0.5% gate.
    for label, route, kw in (("centred", "fused",
                              dict(center_descriptors=True)),
                             ("direct", "exact", dict(lr_mode="direct"))):
        for pname, pairs_, max_d in (
                ("bench", [p_[:2] for p_ in bench_pairs], MAX_D),
                (f"adversarial {ADV_HW[1]}x{ADV_HW[0]}", adv, ADV_D)):
            ccfg16 = Config(max_disparity=max_d, dtype="bfloat16", **kw)
            g_ = ccfg16.geometry(*pairs_[0][0].shape[:2])
            exp = {"K2 bf16", "K3 bf16" if pyramid_cuda.supported(
                g_.disparities, g_.levels) else "K5 bf16"}
            got_ = run_path(f"{label} bf16 {pname} {route}", exp,
                            lambda pairs_=pairs_, c=ccfg16, route=route: [
                                api.match_stereo(l, r, c, impl=route,
                                                 device="cuda")
                                for l, r in pairs_])
            for i, ((l, r), got) in enumerate(zip(pairs_, got_)):
                plain = api.match_stereo(l, r, ccfg16, impl=route,
                                         device="cpu")
                raw_neq = int(np.sum(got.disparity_raw != plain.disparity_raw))
                val_neq = int(np.sum(got.valid != plain.valid))
                print(f"{label} bf16 [{pname}, {route}] pair {i}: raw_neq="
                      f"{raw_neq} valid_neq={val_neq} of {got.valid.size} px "
                      f"against the port's plain route on the CPU")
                require(got.score.dtype == np.float32
                        and max(raw_neq, val_neq)
                        <= FUSED_DECISION_TOL * got.valid.size,
                        f"{label} bf16 {pname} beyond the gate on pair {i}")

    # 4c. The invariant checks on the card, on bench pair 100.
    l0, r0, _ = bench_pairs[0]
    lp0, rp0 = (torch.from_numpy(api.preprocess(x, cfg, H, W)).to(dev)
                for x in (l0, r0))
    bad = lp0.clone()
    bad[3, 5] = float("nan")

    def checked():
        out = checks.checked_match_padded(lp0, rp0, cfg, H, W, "fused")
        try:
            checks.checked_match_padded(bad, rp0, cfg, H, W, "fused")
        except checks.InvariantError as e:
            return out, str(e)
        return out, None

    chk, err_msg = run_path("checks fused", {"K1"}, checked)
    ref = pipeline.match_padded(lp0, rp0, cfg, H, W, "fused")
    same = all(torch.equal(chk[k], ref[k]) for k in KEYS if k != "disparity")
    same = same and bool(((chk["disparity"] == ref["disparity"])
                          | (chk["disparity"].isnan()
                             & ref["disparity"].isnan())).all())
    print(f"checked_match_padded [bench, fused] pair {MAIN_PATH_SEEDS[0]}: "
          f"passes, equal to the unchecked pipeline {same}; on a NaN plane "
          f"raises: {err_msg}")
    require(same, "the checked pipeline differs from the unchecked one")
    require(err_msg is not None and "non-finite values in padded input "
            "images" in err_msg, "a NaN input passed the checks")

    # 4d. The CLI in its own process on the card, in float32 and bfloat16.
    for dtype, impl in (("float32", "fused"), ("bfloat16", "fused"),
                        ("bfloat16", "exact")):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli",
                                   "--demo", "--dtype", dtype, "--impl", impl,
                                   "-o", tmp],
                                  cwd=REPO, capture_output=True, text=True,
                                  timeout=600)
            print(f"cli --demo --dtype {dtype} --impl {impl} -o DIR: exit "
                  f"{proc.returncode} in {time.perf_counter() - t0:.1f} s "
                  f"(host): {proc.stdout.strip()[-300:]}")
            require(proc.returncode == 0, f"the CLI failed:\n{proc.stderr}")
            files = sorted(os.listdir(tmp))
            with open(os.path.join(tmp, "metrics.json")) as f:
                meta = json.load(f)
        require(files == ["disparity.pfm", "disparity_16bit.png",
                          "disparity_color.png", "metrics.json", "valid.png"],
                f"the CLI wrote {files}")
        require(meta.get("impl") == impl and meta.get("engine") == "cuda:0"
                and meta["config"]["dtype"] == dtype,
                f"the CLI ran impl {meta.get('impl')} on "
                f"{meta.get('engine')} in {meta['config']['dtype']}")
    print(flush=True)

    # 4e. The dataset evaluation tool over KITTI- and Middlebury-layout
    # pairs on disk, at their real image sizes.
    eval_phase(run_path, path_launches, card)

    # 5. Timing of the batched steps, each with its peak device memory; the
    # bf16 steps beside the float32 ones.
    steps = [("bench", cfg, geom, lp, rp), ("grad_hist", gh, geom, lp, rp)]
    steps += [(f"kitti D={d}", *kitti[d]) for d in KITTI]
    steps += [("bench bf16", cfg16, geom, lp, rp),
              ("grad_hist bf16", gh16, geom, lp, rp),
              ("kitti D=256 bf16",
               dataclasses.replace(kitti[256][0], dtype="bfloat16"),
               *kitti[256][1:])]
    step_ms, step_range, step_peak, peak = {}, {}, {}, 0
    for label, scfg, sgeom, slp, srp in steps:
        for route in ("fused", "exact"):
            def step(route=route):
                return pipeline.match_padded_core(slp, srp, scfg, sgeom, route)
            sync()
            torch.cuda.reset_peak_memory_stats()
            step()
            sync()
            samples = [cuda_ms(torch, step, 1, warmup=0) for _ in range(7)]
            med = float(np.median(samples))
            key = f"{label} {route}"
            step_ms[key] = med
            step_range[key] = (min(samples), max(samples))
            step_peak[key] = torch.cuda.max_memory_allocated()
            peak = max(peak, step_peak[key])
            n, hh, ww = slp.shape[0], sgeom.height, sgeom.width
            print(f"step [{label}, {route}] {n} pairs {ww}x{hh}: median "
                  f"{med:.4f} ms [{min(samples):.4f}..{max(samples):.4f}] "
                  f"over 7 samples = {n * hh * ww * 1e-6 / (med * 1e-3):.1f} "
                  f"Mpx/s; peak device memory "
                  f"{step_peak[key] / 2**20:.1f} MiB {card}")
    for label in ("bench", "grad_hist", "kitti D=256"):
        for route in ("fused", "exact"):
            a, b = f"{label} {route}", f"{label} bf16 {route}"
            print(f"  step [{label}, {route}] bf16 {step_ms[b]:.4f} ms "
                  f"[{step_range[b][0]:.4f}..{step_range[b][1]:.4f}] beside "
                  f"float32 {step_ms[a]:.4f} ms [{step_range[a][0]:.4f}.."
                  f"{step_range[a][1]:.4f}] ({step_ms[b] / step_ms[a]:.3f}x); "
                  f"peak memory {step_peak[b] / 2**20:.1f} MiB beside "
                  f"{step_peak[a] / 2**20:.1f} MiB {card}")
    print(f"peak device memory over the timed steps: {peak / 2**20:.1f} MiB {card}")
    print(flush=True)

    # 6. The sharded strategies on a world of one rank over NCCL: the
    # collectives degenerate, the shard bodies and their kernels run.
    def in_f32(strategy, merge_level):
        """dslab, ringd and wtiled below the top level build their volumes
        from float32 descriptors in either dtype, as in the JAX package."""
        return strategy in ("dslab", "ringd") or (
            strategy == "wtiled" and merge_level is not None)

    def strategy_kernels(strategy, merge_level, mode, dtype="float32"):
        b = " bf16" if dtype == "bfloat16" else ""
        if strategy == "tiled":     # 'direct' takes the descriptor route
            return {f"K1{b}"} if mode == "flip" else {f"K2{b}", f"K3{b}"}
        if strategy == "dslab":
            return {"K6", "K5 exact"}
        if strategy == "wtiled" and merge_level is None:
            return {f"K2{b}", f"K3{b}"}
        return {"K6"}

    def label_of(strategy, merge_level):
        return (f"wtiled({merge_level})" if strategy == "wtiled"
                else strategy)

    def stream_phase(smesh):
        """run_stream over STREAM_PAIRS bench pairs (tiled, 'fused'), with
        and without an injected failure, in bf16 over a batch and the
        tail, and pairs_from_paths over the same pairs as PGM files;
        returns the stream's Mpx/s."""
        stream_pairs = [(l, r) for l, r, _ in pairs]
        stream_pairs += [make_pair(100 + i)[:2]
                         for i in range(BATCH, STREAM_PAIRS)]
        sglob = sharded.strategy_geometry(cfg, H, W, smesh, "tiled")

        def unsharded_batches(scfg, spairs):
            want = []
            for i in range(0, len(spairs), BATCH):
                chunk = spairs[i:i + BATCH]
                lps, rps = (torch.from_numpy(sharded.pad_batch(
                    [p[j] for p in chunk], scfg, H, W, smesh, "tiled")).to(
                        dev) for j in (0, 1))
                out = pipeline.apply_postfilter(pipeline.crop(
                    pipeline.match_padded_core(lps, rps, scfg, sglob,
                                               "fused"), H, W), scfg)
                want.append({k: v.cpu().numpy() for k, v in out.items()})
            return want

        def run(source, scfg, want, **kw):
            got = {}
            with tempfile.TemporaryDirectory() as tmp:
                log_path = os.path.join(tmp, "stream.jsonl")
                with JsonlLogger(log_path) as logger:
                    rep = runner.run_stream(
                        source, scfg, H, W, smesh, "tiled", BATCH, "fused",
                        on_result=lambda i, out: got.update({i: out}),
                        logger=logger, **kw)
                with open(log_path) as f:
                    recs = [json.loads(line) for line in f]
            events = [r["event"] for r in recs]
            pads = {r["pad"] for r in recs if r["event"] == "batch_done"}
            same = sorted(got) == list(range(len(want))) and all(
                np.array_equal(got[b][k], w_[k], equal_nan=k == "disparity")
                for b, w_ in enumerate(want) for k in KEYS)
            return rep, events, same, pads

        want = unsharded_batches(cfg, stream_pairs)
        rep, events, same, pads = run_path(
            "stream tiled fused", {"K1"}, lambda: run(stream_pairs, cfg, want))
        print(f"stream [tiled, fused] {STREAM_PAIRS} pairs {W}x{H}, batch "
              f"{BATCH}: {rep}; log events batch_done "
              f"{events.count('batch_done')}, tail_batch "
              f"{events.count('tail_batch')}; every pair bitwise equal to "
              f"the unsharded pipeline {same}")
        print(f"  stream {rep.mpx_per_s:.1f} Mpx/s (host wall over the "
              f"stream, one batch ahead) beside the step [bench, "
              f"fused] {step_ms['bench fused']:.4f} ms = "
              f"{BATCH * H * W * 1e-3 / step_ms['bench fused']:.1f} Mpx/s "
              f"{card}")
        require(same and rep.pairs_completed == STREAM_PAIRS
                and rep.batches_completed == 3 and rep.retries == 0
                and events.count("batch_done") == 3
                and events.count("tail_batch") == 1 and pads == {"host"},
                "the stream's outputs or accounting are wrong")
        # The same pairs as uint8 colour images: each batch copied in as
        # bytes and padded on the card (PREP, two launches a side).
        rgb = [tuple(np.repeat(np.round(x * 255).astype(np.uint8)[..., None],
                               3, -1) for x in pair) for pair in stream_pairs]
        want8 = unsharded_batches(cfg, rgb)
        rep8, events8, same8, pads8 = run_path(
            "stream tiled fused uint8", {"PREP", "K1"},
            lambda: run(rgb, cfg, want8))
        prep_launches = path_launches["stream tiled fused uint8"]["PREP"]
        print(f"stream [tiled, fused] uint8 colour {STREAM_PAIRS} pairs: "
              f"{rep8}; pad {sorted(pads8)}, {prep_launches} PREP launches; "
              f"every pair bitwise equal to the unsharded pipeline on the "
              f"host's padding {same8}; {rep8.mpx_per_s:.1f} Mpx/s against "
              f"{rep.mpx_per_s:.1f} padded on the host {card}")
        require(same8 and pads8 == {"device"}
                and rep8.pairs_completed == STREAM_PAIRS
                and prep_launches == 2 * prep_cuda.LAUNCHES
                * rep8.batches_completed,
                "the uint8 stream's outputs or accounting are wrong")
        calls = {"n": 0}

        def flaky(lp, rp):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected: lost rank")
            return sharded.match_batch_sharded(lp, rp, cfg, H, W, smesh,
                                               "tiled", "fused")

        rep2, events2, same2, _ = run_path(
            "stream retry", {"K1"}, lambda: run(stream_pairs, cfg, want,
                                                _match_fn=flaky))
        print(f"stream with one injected failure: retries {rep2.retries}, "
              f"pairs {rep2.pairs_completed}, batch_retry events "
              f"{events2.count('batch_retry')}, outputs the same {same2}")
        require(rep2.retries == 1 and same2
                and rep2.pairs_completed == STREAM_PAIRS,
                "the stream did not recover from one failure")
        # In bf16, over one batch and the tail: the tiled strategy runs the
        # bf16 pipeline (K1 bf16) in its tiles.
        n16 = BATCH + STREAM_TAIL
        cfg16s = dataclasses.replace(cfg, dtype="bfloat16")
        want16 = unsharded_batches(cfg16s, stream_pairs[:n16])
        rep16, events16, same16, _ = run_path(
            "stream tiled fused bf16", {"K1 bf16"},
            lambda: run(stream_pairs[:n16], cfg16s, want16))
        print(f"stream [tiled, fused] bf16 {n16} pairs: {rep16}; every pair "
              f"bitwise equal to the unsharded bf16 pipeline {same16}")
        require(same16 and rep16.pairs_completed == n16
                and rep16.batches_completed == 2
                and events16.count("tail_batch") == 1,
                "the bf16 stream's outputs or accounting are wrong")

        built = native.available()
        print(f"native loader: {'built' if built else native.build_error()}")
        require(built, f"the native loader did not build: "
                f"{native.build_error()}")
        u8 = [tuple(np.round(x * 255).astype(np.uint8) for x in pair)
              for pair in stream_pairs]
        with tempfile.TemporaryDirectory() as tmp:
            paths = ([], [])
            for i, pair in enumerate(u8):
                for side, img in enumerate(pair):
                    path = os.path.join(tmp, f"{i:03d}_{'lr'[side]}.pgm")
                    native.write_pnm(path, img)
                    paths[side].append(path)
            planes = list(runner.pairs_from_paths(*paths, cfg, H, W, smesh,
                                                  "tiled"))
        same3 = len(planes) == STREAM_PAIRS and all(
            np.array_equal(plane, sharded.pad_batch([img], cfg, H, W, smesh,
                                                    "tiled")[0])
            for pl, pair in zip(planes, u8) for plane, img in zip(pl, pair))
        print(f"pairs_from_paths: {len(planes)} pairs from PGM through the "
              f"native loader, planes bitwise equal to the in-memory path's "
              f"{same3}")
        require(same3, "the native loader's planes differ")
        return rep.mpx_per_s

    strategy_ms = {}
    spairs = [make_pair(s) for s in MAIN_PATH_SEEDS]
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as rdzv:
        launch.init("nccl", 0, 1, os.path.join(rdzv, "rendezvous"),
                    timeout=120)
        try:
            meshes = {"2d": mesh_lib.make_mesh(1, 1),
                      "3d": mesh_lib.make_mesh2d(1, 1, 1)}
            for mode in ("flip", "direct"):
                scfg = Config(max_disparity=MAX_D, lr_mode=mode)
                ora = [want["bench", s] if mode == "flip"
                       else oracle.match_stereo(l, r, scfg)
                       for s, (l, r, _) in zip(MAIN_PATH_SEEDS, spairs)]
                for strategy, route, ml in STRATEGY_RUNS.values():
                    mesh = meshes["3d" if strategy == "wtiled" else "2d"]
                    label = label_of(strategy, ml)
                    sl, sr = (sharded.pad_batch([x[i] for x in spairs], scfg,
                                                H, W, mesh, strategy, ml)
                              for i in (0, 1))
                    got, counts = clear_and_run(
                        f"{label} {mode}", lambda: sharded.match_batch_sharded(
                            sl, sr, scfg, H, W, mesh, strategy, route, ml))
                    glob = sharded.strategy_geometry(scfg, H, W, mesh,
                                                     strategy, ml)
                    ref = pipeline.apply_postfilter(pipeline.crop(
                        pipeline.match_padded_core(
                            torch.from_numpy(sl).to(dev),
                            torch.from_numpy(sr).to(dev), scfg, glob, route),
                        H, W), scfg)
                    g = {k: v.cpu().numpy() for k, v in got.items()}
                    r = {k: v.cpu().numpy() for k, v in ref.items()}
                    neq = {k: float(np.mean(g[k] != r[k])) for k in
                           ("disparity_raw", "valid", "disparity_right")}
                    disp_eq = np.array_equal(g["disparity"], r["disparity"],
                                             equal_nan=True)
                    score_eq = np.array_equal(g["score"], r["score"])
                    score_close = np.allclose(g["score"], r["score"],
                                              rtol=1e-5)
                    print(f"strategy [{label}, {route}, {mode}] pairs "
                          f"{MAIN_PATH_SEEDS} {tuple(g['disparity'].shape)} "
                          f"vs unsharded at {glob.padded_height}x"
                          f"{glob.padded_width} D0={glob.disparities}: "
                          f"mismatch rates {neq}, disparity equal {disp_eq}, "
                          f"scores bitwise {score_eq}; launches "
                          f"{dict(counts)}")
                    decisions_eq = disp_eq and not any(neq.values())
                    if strategy == "wtiled" and ml is not None:
                        # Its merge levels run the torch pyramid (torch.pow)
                        # where K3 runs powf: scores rtol 1e-5, and decisions
                        # within the 0.5% gate if the two pows disagree.
                        require(score_close or not decisions_eq,
                                f"{label} scores beyond rtol 1e-5")
                        require(max(neq.values()) <= FUSED_DECISION_TOL,
                                f"{label} beyond the decision gate")
                    else:
                        require(decisions_eq and score_eq,
                                f"{label} {mode} is not bitwise the "
                                f"unsharded pipeline")
                    if strategy in ("dslab", "ringd"):
                        for seed, o, i in zip(MAIN_PATH_SEEDS, ora, range(2)):
                            raw_neq = float(np.mean(g["disparity_raw"][i]
                                                    != o.disparity_raw))
                            val_neq = float(np.mean(g["valid"][i] != o.valid))
                            print(f"  vs oracle pair {seed}: raw_neq="
                                  f"{raw_neq:.3e} valid_neq={val_neq:.3e}")
                            require(raw_neq == 0.0 and val_neq == 0.0,
                                    f"{label} {mode} off the oracle")
                    expected = strategy_kernels(strategy, ml, mode)
                    require(launched(counts) == expected,
                            f"{label} {mode} launched "
                            f"{sorted(launched(counts))}, expected "
                            f"{sorted(expected)}")
                    # Again in bf16, as the JAX package runs it: held to
                    # its own float32 run, or to the unsharded bf16
                    # pipeline.
                    scfg16 = dataclasses.replace(scfg, dtype="bfloat16")
                    got16, counts16 = clear_and_run(
                        f"{label} bf16 {mode}",
                        lambda: sharded.match_batch_sharded(
                            sl, sr, scfg16, H, W, mesh, strategy, route, ml))
                    if in_f32(strategy, ml):
                        ref16, what = g, "its own float32 run"
                    else:
                        ref16, what = {
                            k: v.cpu().numpy() for k, v in
                            pipeline.apply_postfilter(pipeline.crop(
                                pipeline.match_padded_core(
                                    torch.from_numpy(sl).to(dev),
                                    torch.from_numpy(sr).to(dev), scfg16,
                                    glob, route), H, W), scfg16).items()
                        }, "the unsharded bf16 pipeline"
                    g16 = {k: v.cpu().numpy() for k, v in got16.items()}
                    same16 = all(np.array_equal(g16[k], ref16[k],
                                                equal_nan=k == "disparity")
                                 for k in KEYS)
                    expected16 = strategy_kernels(strategy, ml, mode,
                                                  "bfloat16")
                    print(f"strategy [{label}, {route}, {mode}] bf16: "
                          f"bitwise {what} {same16}; launches "
                          f"{dict(counts16)}")
                    require(same16, f"{label} {mode} bf16 is not bitwise "
                            f"{what}")
                    require(launched(counts16) == expected16,
                            f"{label} {mode} bf16 launched "
                            f"{sorted(launched(counts16))}, expected "
                            f"{sorted(expected16)}")
            print(flush=True)

            kcfg, kgeom, klp, krp = kitti[256]
            for strategy, route, ml in STRATEGY_RUNS.values():
                mesh = meshes["3d" if strategy == "wtiled" else "2d"]
                label = label_of(strategy, ml)
                glob = sharded.strategy_geometry(kcfg, KH, KW, mesh,
                                                 strategy, ml)
                require((glob.padded_height, glob.padded_width,
                         glob.disparities) == (kgeom.padded_height,
                                               kgeom.padded_width,
                                               kgeom.disparities),
                        f"{label} pads KITTI differently: {glob}")

                def sstep(strategy=strategy, route=route, ml=ml, mesh=mesh):
                    return sharded.match_batch_sharded(
                        klp, krp, kcfg, KH, KW, mesh, strategy, route, ml)
                sstep()
                sync()
                samples = [cuda_ms(torch, sstep, 1, warmup=0)
                           for _ in range(5)]
                med = float(np.median(samples))
                strategy_ms[f"kitti D=256 {label} {route}"] = med
                n = klp.shape[0]
                print(f"strategy step [{label}, {route}] {n} pairs {KW}x{KH} "
                      f"D=256, one rank: median {med:.4f} ms "
                      f"[{min(samples):.4f}..{max(samples):.4f}] over 5 "
                      f"samples = {n * KH * KW * 1e-6 / (med * 1e-3):.1f} "
                      f"Mpx/s (unsharded: fused "
                      f"{step_ms['kitti D=256 fused']:.4f} ms, exact "
                      f"{step_ms['kitti D=256 exact']:.4f} ms) {card}")
            print(flush=True)
            stream_mpx = stream_phase(meshes["2d"])
        finally:
            dist.destroy_process_group()

    # 7. The port's bench and its KITTI bench: each row a path of its own.
    bench_summary = bench_phase(run_path, dev, card, card_line)
    # 8. The roofline and the cross-host budget.
    roofline_summary = roofline_phase(run_path, dev, card, card_line)
    jax_mods = sorted(m for m in sys.modules if m == "jax"
                      or m.startswith("jax.") or m == JAX_PKG
                      or m.startswith(JAX_PKG + "."))
    require(not jax_mods, f"imported {jax_mods}")
    launches = {k: sum(c[k] for c in path_launches.values())
                for k in _build.KERNELS}
    # K2 at grad_hist width and at the KITTI geometry are rows of their
    # own over K2's count: its launches on the paths of that kind.
    shape_rows = {"K2 C=128": ("K2", "grad_hist"), "K2 KITTI": ("K2", "kitti"),
                  "K2 C=128 bf16": ("K2 bf16", "grad_hist"),
                  "K1 KITTI": ("K1", "eval kitti D=64")}
    for key, (kernel, prefix) in shape_rows.items():
        launches[key] = sum(c[kernel] for p, c in path_launches.items()
                            if p.startswith(prefix))

    sources = {
        "K1": ("K1 fused image->disparity (patch)", "csrc/fused.cu",
               "ops/fused_pallas.py:572"),
        "K1 KITTI": ("K1 fused image->disparity (patch), KITTI grid D=64",
                     "csrc/fused.cu", "ops/fused_pallas.py:572"),
        "K1b": ("K1b fused image->disparity (magbin, grad_hist)",
                "csrc/fused.cu", "ops/fused_pallas.py:572"),
        "K2": ("K2 D-major cost volume", "csrc/costvol.cu",
               "ops/costvol_pallas.py:86"),
        "K2 C=128": ("K2 D-major cost volume, grad_hist C=128",
                     "csrc/costvol.cu", "ops/costvol_pallas.py:86"),
        "K2 KITTI": ("K2 D-major cost volume, KITTI D=256",
                     "csrc/costvol.cu", "ops/costvol_pallas.py:86"),
        "K3": ("K3 pyramid + backtracking", "csrc/pyramid.cu",
               "ops/pyramid_pallas.py:257"),
        "K4": ("K4 image->D-major cost volume", "csrc/costrows.cu",
               "ops/fused_pallas.py:808"),
        "K5": ("K5 level aggregation", "csrc/aggregate.cu",
               "ops/pyramid_pallas.py:346"),
        "K5 exact": ("K5 level aggregation, exact mode", "csrc/aggregate.cu",
                     "ops/pyramid_pallas.py:346"),
        "K1 bf16": ("K1 fused image->disparity (patch, bfloat16)",
                    "csrc/fused.cu", "ops/fused_pallas.py:572"),
        "K4 bf16": ("K4 image->D-major cost volume (bfloat16)",
                    "csrc/costrows.cu", "ops/fused_pallas.py:808"),
        # The JAX package sends grad_hist past K1b's block to its
        # descriptor route, whose cost volume is K2's.
        "K4b": ("K4b image->D-major cost volume (magbin, grad_hist)",
                "csrc/costrows.cu", "ops/costvol_pallas.py:86"),
        "K4b bf16": ("K4b image->D-major cost volume (magbin, grad_hist, "
                     "bfloat16)", "csrc/costrows.cu",
                     "ops/costvol_pallas.py:86"),
        "K5 bf16": ("K5 level aggregation (bfloat16)", "csrc/aggregate.cu",
                    "ops/pyramid_pallas.py:346"),
        "K1b bf16": ("K1b fused image->disparity (magbin, grad_hist, "
                     "bfloat16)", "csrc/fused.cu", "ops/fused_pallas.py:572"),
        "K2 bf16": ("K2 D-major cost volume (bfloat16)", "csrc/costvol.cu",
                    "ops/costvol_pallas.py:86"),
        "K2 C=128 bf16": ("K2 D-major cost volume, grad_hist C=128 "
                          "(bfloat16)", "csrc/costvol.cu",
                          "ops/costvol_pallas.py:86"),
        "K3 bf16": ("K3 pyramid + backtracking (bfloat16)", "csrc/pyramid.cu",
                    "ops/pyramid_pallas.py:257"),
        "K6": ("K6 row-layout slab cost volume", "csrc/costvol.cu",
               "ops/costvol_pallas.py:57"),
        "P1": ("P1 streaming probe (stream)", "csrc/probe.cu",
               "tools/vpu_ceiling.py:59"),
        "P2": ("P2 streaming probe (small)", "csrc/probe.cu",
               "tools/vpu_ceiling.py:120"),
        "P3": ("P3 streaming probe (shifted window)", "csrc/probe.cu",
               "tools/vpu_ceiling.py:165"),
        "PREP": ("PREP grayscale and zero pad of raw uint8 images",
                 "csrc/prep.cu", "none: the JAX package pads on the host"),
        "PLANES": ("PLANES grad_hist (magnitude, bin) planes",
                   "csrc/planes.cu",
                   "none: the JAX package builds the planes in XLA "
                   "(models/descriptors.py: magbin_from_gradients)"),
        "EPI": ("EPI LR check, densify and the five outputs",
                "csrc/epilogue.cu",
                "none: the JAX package runs them in XLA "
                "(models/pipeline.py: lr_consistency_patch_padded, densify)"),
    }
    regs = {"K1": fused_ptxas.get((4, "patch", "f32")),
            "K1 KITTI": fused_ptxas.get((4, "patch", "f32")),
            "K1 bf16": fused_ptxas.get((4, "patch", "bf16")),
            "K1b": fused_ptxas.get((4, "magbin", "f32")),
            "K1b bf16": fused_ptxas.get((4, "magbin", "bf16")),
            "K2": costvol_ptxas.get((False, True, "f32")),
            "K2 C=128": costvol_ptxas.get((False, True, "f32")),
            "K2 bf16": costvol_ptxas.get((False, True, "bf16")),
            "K2 C=128 bf16": costvol_ptxas.get((False, True, "bf16")),
            "K3": rows_ptxas.get("pyramid_kernelILb0E"),
            "K3 bf16": rows_ptxas.get("pyramid_kernelILb1E"),
            "K4": rows_ptxas.get("costrows_kernelILi4EfE"),
            "K4 bf16": rows_ptxas.get("costrows_kernelILi4Ebf16E"),
            "K4b": magbin_ptxas.get("costrows_magbin_kernelILi4EfE"),
            "K4b bf16": magbin_ptxas.get("costrows_magbin_kernelILi4Ebf16E"),
            "PLANES": planes_ptxas.get(True),
            "EPI": epi_ptxas.get((4, True)),
            "K5": rows_ptxas.get("aggregate_kernelILb0ELb1ELb1E"),
            "K5 exact": rows_ptxas.get("aggregate_kernelILb0ELb1ELb0E"),
            "K5 bf16": rows_ptxas.get("aggregate_kernelILb1ELb1ELb1E")}
    for k, v in regs.items():
        if v is not None:
            rows[k]["registers"] = v[0]
    kernels = []
    for k, (label, src, rep) in sources.items():
        # The model counts the probes, which forbid FMA (csrc/probe.cu),
        # against 33.5 TFLOP/s, half the FMA-counted float32 peak.
        bound_s, bound_by = work.bound(rows[k]["work"])
        bound_ms = bound_s * 1e3
        kernels.append({
            "name": label, "route": "cuda", "source": f"{PKG}/{src}",
            "replaces": (rep if k.startswith("P") or rep.startswith("none")
                         else f"{JAX_PKG}/{rep}"),
            "launches": launches[k],
            "launches_by_path": {
                p: c[shape_rows.get(k, (k,))[0]]
                for p, c in path_launches.items()
                if c[shape_rows.get(k, (k,))[0]]
                and p.startswith(shape_rows.get(k, (k, ""))[1])},
            **({"max_abs_err": rows[k]["err"]} if "err" in rows[k] else {}),
            "ms": rows[k]["ms"],
            "plain_ms": rows[k]["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": rows[k].get("library"),
            "bytes": rows[k]["work"].total_bytes,
            "operations": rows[k]["work"].total_ops,
            **{key: rows[k][key] for key in ("flips", "blocks_per_sm",
                                             "library_extra_bytes",
                                             "registers", "issue_ceiling_ms",
                                             "device_ms", "numpy_ms")
               if key in rows[k]}})
        print(f"  {k}: kernel {rows[k]['ms']:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}), {rows[k]['ms'] / bound_ms:.1f}x its bound; "
              f"{launches[k]} launches on the paths {card}")
    print(f"chip_smoke wall time: {time.perf_counter() - wall0:.1f} s {card}")
    print(json.dumps({"kernels": kernels, "step_ms": step_ms,
                      "step_range_ms": step_range, "step_peak_bytes": step_peak,
                      "strategy_ms": strategy_ms,
                      "stream_mpx_per_s": stream_mpx, "peak_bytes": peak,
                      "card_tests_passed": card_tests_passed,
                      **bench_summary, "roofline": roofline_summary,
                      "card": card_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
