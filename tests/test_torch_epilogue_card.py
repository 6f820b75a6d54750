"""The epilogue kernel (EPI, csrc/epilogue.cu) on the card: the LR check,
densify and the five outputs bitwise the plain chain
(`pipeline.lr_consistency_patch`, then `pipeline.pixel_outputs`) run on
the same card, and on the CPU where the maps are small.

At each step cell's patch grid and batch (96 x 128 with D = 64 at 128
pairs, 96 x 384 with D = 256 at 32, 512 x 768 with D0 = 320 at 16); with
and without the LR check, min_score 0 and 0.25, tau 1, a fractional 1.5
and 16777216.5 (float32's 2^24, which a difference of 2^24 + 1 passes as
torch compares it), invalid_value NaN and -1; on maps with dL near and
past the left edge (the sentinel's columns, dL > x), dR tying |dL - dR|
at 1 and 2, differences past 2^24 and one that wraps in int32, NaN
scores; at patch size 4 (16-byte stores) and 3 (the scalar loop), with
several leading dimensions, on inputs that are views at odd offsets and
on an empty stack.  One launch a call.  Then one `match_padded_core`
step at each cell's route (K1; K4 -> K5; PLANES -> K4b -> K5; F's K4 ->
K5 in two passes), and at the bench without the check and in direct
mode: bitwise the same step with the plain chain, and one EPI launch
more.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_epilogue_card.py --noconftest` (the machine with the
card has no JAX, and tests/conftest.py imports it).
tests/test_torch_epilogue.py holds the plain chain and an emulation of
the kernel on the CPU.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import _build

from epilogue_cases import FAR_TAU, assert_same, config, patch_maps, plain

pytestmark = pytest.mark.card

# name -> (lead, H0, W0, number of disparities): each step cell's grid.
GRIDS = {"middlebury03_b128": ((128,), 96, 128, 64),
         "kitti15_b32": ((32,), 96, 384, 256),
         "middlebury14_f_b16": ((16,), 512, 768, 320)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    yield torch.device("cuda", 0)
    torch.cuda.empty_cache()


def kernel_and_plain(maps, cfg, d, dev, on_cpu=True):
    """EPI on `maps` (CPU tensors, the right map None without the check)
    against the plain chain on the card, and on the CPU with `on_cpu`."""
    card_maps = [None if t is None else t.to(dev) for t in maps]
    before = _build.launches.copy()
    got = pipeline.lr_outputs(*card_maps, cfg, d)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter(EPI=1)
    assert all(v.device == dev for v in got.values())
    assert_same(got, plain(*card_maps, cfg, d))
    if on_cpu:
        assert_same(got, plain(*maps, cfg, d))


def _maps(lead, h0, w0, d, p, seed, lr=True, far=True):
    disp, score, right = patch_maps(lead, h0, w0, d, p, seed, far)
    return (torch.from_numpy(disp), torch.from_numpy(score),
            torch.from_numpy(right) if lr else None)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_kernel_is_plain_at_the_cells_grids(card, grid):
    lead, h0, w0, d = GRIDS[grid]
    maps = _maps(lead, h0, w0, d, 4, seed=len(grid), far=False)
    kernel_and_plain(maps, config(4, 1.0, 0.0, float("nan")), d, card,
                     on_cpu=h0 < 512)


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("tau", [1.0, 1.5, FAR_TAU])
@pytest.mark.parametrize("min_score", [0.0, 0.25])
@pytest.mark.parametrize("lr", [True, False])
def test_kernel_is_plain_at_the_edges(card, lr, min_score, tau, p):
    invalid = float("nan") if p == 4 else -1.0
    maps = _maps((2, 3), 7, 37, 64, p, seed=p, lr=lr)
    kernel_and_plain(maps, config(p, tau, min_score, invalid), 64, card)


def test_views_at_odd_offsets(card):
    """Inputs one element past an allocation's start, and the right map a
    flipped copy, as the flip mode hands it over."""
    disp, score, right = _maps((4,), 9, 40, 64, 4, seed=7)
    maps = (disp, score, right.flip(-1))
    cfg = config(4, 1.0, 0.25, float("nan"))
    odd = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
           for t in (x.to(card) for x in maps)]
    assert all(t.data_ptr() % 16 == 4 for t in odd)
    got = pipeline.lr_outputs(*odd, cfg, 64)
    assert_same(got, plain(*maps, cfg, 64))


def test_empty_stack(card):
    maps = [t.to(card) for t in _maps((0,), 5, 8, 16, 4, seed=0)]
    before = _build.launches.copy()
    out = pipeline.lr_outputs(*maps, config(4, 1.0, 0.0, 0.0), 16)
    assert all(v.shape == (0, 20, 32) for v in out.values())
    assert _build.launches == before


def _pairs(n, h, w, geom, seed, dev):
    rng = np.random.default_rng(seed)
    sides = []
    for _ in range(2):
        imgs = np.zeros((n, geom.padded_height, geom.padded_width),
                        np.float32)
        imgs[:, :h, :w] = rng.random((n, h, w), dtype=np.float32)
        sides.append(torch.from_numpy(imgs).to(dev))
    return sides


# name -> (H, W, Config kwargs, pairs, route): each step cell's route, and
# the bench without the check and in direct mode.
STEPS = {
    "middlebury03_k1": (375, 450, {"max_disparity": 64}, 4, "fused"),
    "middlebury03_no_lr": (375, 450, {"max_disparity": 64,
                                      "lr_check": False}, 4, "fused"),
    "middlebury03_direct": (375, 450, {"max_disparity": 64,
                                       "lr_mode": "direct"}, 4, "fused"),
    "kitti15_k4_k5": (375, 1242, {"max_disparity": 256}, 2, "fused"),
    "kitti15_gradhist_k4b": (375, 1242, {"max_disparity": 256,
                                         "descriptor": "grad_hist"}, 2,
                             "fused"),
    "middlebury14_f_k4_k5x2": (1988, 2880, {"max_disparity": 290}, 2,
                               "fused"),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_is_the_plain_chains(card, name, monkeypatch):
    h, w, kw, n, route = STEPS[name]
    cfg = Config(**kw)
    geom = cfg.geometry(h, w)
    lp, rp = _pairs(n, h, w, geom, len(name), card)
    before = _build.launches.copy()
    got = pipeline.match_padded_core(lp, rp, cfg, geom, route)
    torch.cuda.synchronize()
    ours = _build.launches - before
    with monkeypatch.context() as m:
        m.setattr(pipeline, "run_kernel", lambda *t: False)
        before = _build.launches.copy()
        want = pipeline.match_padded_core(lp, rp, cfg, geom, route)
        torch.cuda.synchronize()
        theirs = _build.launches - before
    assert ours == theirs + Counter(EPI=1), (ours, theirs)
    assert_same(got, want)
