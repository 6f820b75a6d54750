"""K4b (csrc/costrows.cu: costrows_magbin_kernel) on the card: held to its
plain version as K4 is held to its own, at KITTI's geometry and at ragged
shapes, with its launches (`_build.launches`), shared-memory mirror and
occupancy; its costs are K1b's, bitwise; the `fused` step on a grad_hist
KITTI batch runs the planes, K4b and K5 and nothing else, in either dtype;
its event time beside work.k4b's bound.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_cost_magbin_card.py --noconftest -s`: the machine with
the card has no JAX, and tests/conftest.py imports it.  The reference is
the port's NumPy copy of the oracle; tests/test_torch_cost_magbin.py holds
the plain version to the JAX package's oracle on the CPU.

Tolerances: float32 volumes within 2e-5 of the plain version (K4's gate:
the kernel sums a patch row by row in a fixed order with explicit
roundings, torch in its own order); the bfloat16 volume bitwise the
float32 volume rounded; K1b's scores bitwise K4b's volume at K1b's
decisions (one cost block); the step within the fused routes' 0.5%
decision gate of the oracle.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import (descriptors,
                                                           pipeline)
from deepmatching_stereo_matching_tpu_torch.ops import _build, fused_cuda
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle

pytestmark = pytest.mark.card

KH, KW = 375, 1242
PLAIN_ATOL = 2e-5
FUSED_DECISION_TOL = 0.005
# name -> (n, height, width, Config fields): both KITTI ranges, a grid of
# ragged 8 x 32-patch tiles with a masked plane, the runtime-p instance.
CASES = {
    "kitti256": (4, KH, KW, dict(max_disparity=256)),
    "kitti128": (4, KH, KW, dict(max_disparity=128)),
    "ragged": (3, 112, 304, dict(max_disparity=99, levels=2)),
    "p3": (2, 75, 200, dict(max_disparity=45, levels=2, patch_size=3)),
    "p5": (2, 80, 330, dict(max_disparity=61, levels=1, patch_size=5)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def kitti_pair(seed, h, w, max_d):
    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(h, w, max_d, rng, block=48)
    return synthetic.make_pair(h, w, field, seed=seed)


def planes(n, h, w, cfg, dev):
    """(magnitude, bin) planes of n pairs' padded images, both
    directions stacked as the step stacks them: (2n, Hp, Wp) each."""
    geom = cfg.geometry(h, w)
    pairs = [kitti_pair(s, h, w, cfg.max_disparity) for s in range(n)]
    lp, rp = (torch.from_numpy(np.stack([
        oracle.pad_image(oracle.to_grayscale_f32(p[j]), geom)
        for p in pairs])).to(dev) for j in (0, 1))
    srcs = torch.cat([lp, rp.flip(-1)])
    tgts = torch.cat([rp, lp.flip(-1)])
    lm, lb = descriptors.grad_hist_magbin(srcs)
    rm, rb = descriptors.grad_hist_magbin(tgts)
    return geom, lm, rm, lb, rb


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_is_its_plain_version(card, case):
    n, h, w, fields = CASES[case]
    cfg = Config(descriptor="grad_hist", **fields)
    geom, lm, rm, lb, rb = planes(n, h, w, cfg, card)
    assert fused_cuda.cost_supported(cfg, geom)
    before = _build.launches.copy()
    got = fused_cuda.cost_volume_rows(lm, rm, cfg, geom, lb, rb)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter({"K4b": 1})
    plain = fused_cuda.cost_volume_torch(lm, rm, cfg, geom, lb, rb)
    err = float((got - plain).abs().max())
    print(f"K4b {case} {tuple(lm.shape)} -> {tuple(got.shape)}: max |kernel "
          f"- plain| = {err:.3e}")
    assert err <= PLAIN_ATOL
    assert not got[:, cfg.max_disparity:].any()

    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    before = _build.launches.copy()
    got16 = fused_cuda.cost_volume_rows(lm, rm, c16, geom, lb, rb)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter({"K4b bf16": 1})
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))


@pytest.mark.parametrize("p,max_d", [(4, 256), (4, 128), (4, 99), (3, 45),
                                     (5, 61), (8, 200)])
def test_layout_mirror_and_occupancy(card, p, max_d):
    lib = _build.library()
    assert lib.dm_cost_rows_magbin_smem(p, max_d) == \
        fused_cuda.cost_smem_bytes(p, max_d, magbin=True)
    assert lib.dm_cost_rows_smem(p, max_d) == fused_cuda.cost_smem_bytes(
        p, max_d)
    occ = [fused_cuda.cost_blocks_per_sm(p, max_d, bf16, magbin=True)
           for bf16 in (False, True)]
    print(f"K4b p={p} max_d={max_d}: {fused_cuda.cost_smem_bytes(p, max_d, magbin=True)}"
          f" B a block, blocks per SM (f32, bf16) {occ}")
    # KITTI's two ranges must keep two blocks an SM, whatever their tile.
    if (p, max_d) in ((4, 256), (4, 128)) or \
            fused_cuda.cost_tile_rows(p, max_d, magbin=True) > 1:
        assert min(occ) >= 2


def test_costs_are_k1bs(card):
    """At the Middlebury quarter-size geometry, where K1b runs, K1b's
    scores are K4b's volume at K1b's decisions, bitwise: one cost block,
    one rounding of the window norms."""
    cfg = Config(max_disparity=64, descriptor="grad_hist")
    geom, lm, rm, lb, rb = planes(8, 375, 450, cfg, card)
    assert fused_cuda.supported(cfg, geom)
    disp, score = fused_cuda.match_planes(lm, rm, cfg, geom, lb, rb)
    vol = fused_cuda.cost_volume_rows(lm, rm, cfg, geom, lb, rb)
    at = vol.gather(1, disp.long()[:, None])[:, 0]
    torch.cuda.synchronize()
    assert torch.equal(at, score)


def kitti_step(cfg, dev):
    """match_padded_core(route='fused') on two grad_hist KITTI D=256
    pairs: -> (pairs, outputs, the launches it made)."""
    geom = cfg.geometry(KH, KW)
    pairs = [kitti_pair(100 + s, KH, KW, 256) for s in range(2)]
    lp, rp = (torch.from_numpy(np.stack([
        oracle.pad_image(oracle.to_grayscale_f32(p[j]), geom)
        for p in pairs])).to(dev) for j in (0, 1))
    before = _build.launches.copy()
    out = pipeline.match_padded_core(lp, rp, cfg, geom, "fused")
    torch.cuda.synchronize()
    return pairs, out, _build.launches - before


def test_step_runs_k4b_and_matches_the_oracle(card):
    """match_padded_core(route='fused') on a grad_hist KITTI D=256 batch:
    the planes (two launches), one K4b launch, one K5 launch, one EPI
    launch and nothing else; one pair against the NumPy oracle within the fused gate."""
    cfg = Config(max_disparity=256, descriptor="grad_hist")
    pairs, out, got = kitti_step(cfg, card)
    assert got == Counter({"PLANES": 2, "K4b": 1, "K5": 1, "EPI": 1}), got
    want = oracle.match_stereo(pairs[0][0], pairs[0][1], cfg)
    for k in ("disparity_raw", "valid", "disparity_right"):
        rate = float(np.mean(out[k][0, :KH, :KW].cpu().numpy()
                             != getattr(want, k)))
        print(f"K4b step vs oracle: {k} off on {rate:.6f}")
        assert rate <= FUSED_DECISION_TOL


def test_bf16_step_runs_k4b_bf16_and_k5_bf16(card):
    """The same step in bfloat16: the planes, then K4b's and K5's bf16
    instances and EPI, once each, and nothing else."""
    cfg = Config(max_disparity=256, descriptor="grad_hist",
                 dtype="bfloat16")
    _, out, got = kitti_step(cfg, card)
    assert got == Counter({"PLANES": 2, "K4b bf16": 1, "K5 bf16": 1,
                           "EPI": 1}), got
    assert out["disparity_raw"].shape[0] == 2


def test_k1b_step_builds_the_planes_in_the_pipeline(card):
    """Where K1b covers grad_hist (Middlebury quarter size, D=64),
    match_padded_core(route='fused') builds the planes in the pipeline
    and launches K1b once, no K4b, and EPI once; one pair against the NumPy oracle
    within the fused gate."""
    cfg = Config(max_disparity=64, descriptor="grad_hist")
    h, w = 375, 450
    geom = cfg.geometry(h, w)
    assert fused_cuda.supported(cfg, geom)
    pairs = [kitti_pair(200 + s, h, w, 64) for s in range(2)]
    lp, rp = (torch.from_numpy(np.stack([
        oracle.pad_image(oracle.to_grayscale_f32(p[j]), geom)
        for p in pairs])).to(card) for j in (0, 1))
    before = _build.launches.copy()
    out = pipeline.match_padded_core(lp, rp, cfg, geom, "fused")
    torch.cuda.synchronize()
    got = _build.launches - before
    assert got == Counter({"PLANES": 2, "K1b": 1, "EPI": 1}), got
    want = oracle.match_stereo(pairs[0][0], pairs[0][1], cfg)
    for k in ("disparity_raw", "valid", "disparity_right"):
        rate = float(np.mean(out[k][0, :h, :w].cpu().numpy()
                             != getattr(want, k)))
        print(f"K1b step vs oracle: {k} off on {rate:.6f}")
        assert rate <= FUSED_DECISION_TOL


def test_event_time_beside_its_bound(card):
    """K4b on a 32-pair KITTI step's 64 instances: CUDA events over 10
    launches after a warm-up, beside work.k4b's bound; the share of the
    bound cannot pass 1.05 (the model would count too little)."""
    cfg = Config(max_disparity=256, descriptor="grad_hist")
    geom, lm, rm, lb, rb = planes(4, KH, KW, cfg, card)
    reps = 8                      # 8 x 8 instances = the step's 64
    lm, rm, lb, rb = (x.repeat(reps, 1, 1) for x in (lm, rm, lb, rb))
    rows = {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dt)
        fused_cuda.cost_volume_rows(lm, rm, c, geom, lb, rb)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            fused_cuda.cost_volume_rows(lm, rm, c, geom, lb, rb)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        bound_s, by = work.bound(work.k4b(c, geom, lm.shape[0]))
        rows[dt] = (ms, bound_s * 1e3, by)
        print(f"K4b {dt} x{lm.shape[0]} KITTI D=256: {ms:.4f} ms, bound "
              f"{bound_s * 1e3:.4f} ms ({by}), {bound_s * 1e3 / ms:.4f} of "
              f"it [{torch.cuda.get_device_name(card)}]")
        assert bound_s * 1e3 / ms <= work.MERGED_WORK
