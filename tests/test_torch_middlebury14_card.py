"""Middlebury 2014 at full resolution (F: 2880x1988, max_disparity 290) on
the card, at the benchmark cell's batch of 16 pairs: L = 6, so K5 takes
two launches, and the step's cost volume holds 32 x 320 x 512 x 768 =
4.03e9 elements, past 2^31, where a 32-bit index product would wrap.

Each instance of the batched launch must equal the same launch on that
instance alone, bitwise: K4's volume, K5's top map and every level's pool
offsets (both passes), and the five outputs of each pair of the step.  A
wrapped index shows in the last instances and nowhere else; the
one-instance runs stay far below 2^31.  The one-instance K4 volume is held
to its plain version within K4's gate (2e-5: the kernel sums a patch row
by row in a fixed order with explicit roundings, torch in its own order),
and the one-instance K5 to its plain version bitwise, at this geometry's
max_disparity 290 (D0 = 320, planes 290..319 masked).  A step launches
one K4 and two K5.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_middlebury14_card.py --noconftest -s` (the machine with
the card has no JAX, and tests/conftest.py imports it).  It needs ~25 GB
of device memory.  tests/test_torch_middlebury14.py holds the plain
versions to the oracle at a small L = 6 geometry on the CPU.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import (_build, fused_cuda,
                                                        pyramid_cuda)
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle

pytestmark = pytest.mark.card

H, W, MAX_D, PAIRS, BLOCK = 1988, 2880, 290, 16, 128
PLAIN_ATOL = 2e-5


@pytest.fixture(scope="module")
def batch():
    """(cfg, geom, left, right): 16 padded F pairs on the card, from the
    benchmark's recipe (128 x 128 blocks of disparity)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    cfg = Config(max_disparity=MAX_D)
    geom = cfg.geometry(H, W)
    assert (geom.levels, geom.padded_height, geom.padded_width,
            geom.disparities) == (6, 2048, 3072, 320)
    sides = ([], [])
    for s in range(PAIRS):
        field = synthetic.block_disparity_field(
            H, W, MAX_D, np.random.default_rng(s), block=BLOCK)
        for side, img in zip(sides, synthetic.make_pair(H, W, field,
                                                        seed=s)[:2]):
            side.append(oracle.pad_image(oracle.to_grayscale_f32(img), geom))
    dev = torch.device("cuda", 0)
    left, right = (torch.from_numpy(np.stack(x)).to(dev) for x in sides)
    return cfg, geom, left, right


@pytest.fixture(autouse=True)
def free_memory():
    yield
    torch.cuda.empty_cache()


def instances(left, right):
    """Both directions of every pair, stacked as the step's flip stacks
    them: (2, n, Hp, Wp) sources and targets, 2n instances."""
    return (torch.stack([left, right.flip(-1)]),
            torch.stack([right, left.flip(-1)]))


def volume(batch):
    cfg, geom, left, right = batch
    srcs, tgts = instances(left, right)
    before = _build.launches.copy()
    vol = fused_cuda.cost_volume_rows(srcs, tgts, cfg, geom)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter({"K4": 1})
    assert vol.shape == (2, PAIRS, 320, 512, 768)
    assert vol.numel() > 2 ** 31
    return srcs, tgts, vol


def test_k4_each_instance_is_its_own_launch(batch):
    cfg, geom, _, _ = batch
    assert not fused_cuda.supported(cfg, geom)
    assert fused_cuda.cost_supported(cfg, geom)
    srcs, tgts, vol = volume(batch)
    for j in range(2):
        for i in range(PAIRS):
            one = fused_cuda.cost_volume_rows(srcs[j, i:i + 1],
                                              tgts[j, i:i + 1], cfg, geom)
            assert torch.equal(vol[j, i], one[0]), (j, i)
    plain = fused_cuda.cost_volume_torch(srcs[1, -1], tgts[1, -1], cfg, geom)
    err = float((vol[1, -1] - plain).abs().max())
    assert err <= PLAIN_ATOL, err
    assert not vol[:, :, MAX_D:].any()          # the masked planes


def test_k5_each_instance_is_its_own_launch(batch):
    cfg, geom, _, _ = batch
    _, _, vol = volume(batch)
    assert pyramid_cuda.aggregate_launches(geom.levels) == 2
    before = _build.launches.copy()
    top, args = pyramid_cuda.aggregate_dmajor(vol, geom.levels, cfg.lam,
                                              fast=True)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter({"K5": 2})
    assert top.shape == (2, PAIRS, 5, 8, 12) and len(args) == 6
    assert args[0].numel() > 2 ** 31 - 2 ** 28   # 2.01e9 int8 offsets
    for j in range(2):
        for i in range(PAIRS):
            top1, args1 = pyramid_cuda.aggregate_dmajor(
                vol[j, i:i + 1], geom.levels, cfg.lam, fast=True)
            assert torch.equal(top[j, i], top1[0]), (j, i)
            for lvl, (a, b) in enumerate(zip(args, args1)):
                assert torch.equal(a[j, i], b[0]), (j, i, lvl)
    ptop, pargs = pyramid_cuda.aggregate_dmajor_torch(
        vol[1, -1:], geom.levels, cfg.lam, fast=True)
    assert torch.equal(top1, ptop)
    assert all(torch.equal(a, b) for a, b in zip(args1, pargs))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_step_each_pair_is_its_own_step(batch):
    cfg, geom, left, right = batch
    before = _build.launches.copy()
    out = pipeline.match_padded_core(left, right, cfg, geom, "fused")
    torch.cuda.synchronize()
    assert _build.launches - before == Counter({"K4": 1, "K5": 2, "EPI": 1})
    for i in range(PAIRS):
        one = pipeline.match_padded_core(left[i:i + 1], right[i:i + 1], cfg,
                                         geom, "fused")
        for k, v in out.items():
            assert torch.equal(_bits(v[i]), _bits(one[k][0])), (i, k)
    valid = out["valid"][:, :H, :W].float().mean().item()
    print(f"\nF step, {PAIRS} pairs: LR-valid share {valid!r}")
