"""Patch maps for the epilogue kernel's tests (tests/test_torch_epilogue.py
on the CPU, tests/test_torch_epilogue_card.py on the card), the plain
chain they are held to, and a bitwise comparison.  Imports nothing of
JAX."""

import numpy as np
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.models import pipeline

KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")
INT32_MIN = -2 ** 31
# A tau that float32 rounds to 2^24, as torch compares int32 maps with a
# Python float: a difference of 2^24 + 1, rounded to 2^24, passes it, as
# it would not in exact arithmetic.
FAR_TAU = 16777216.5


def patch_maps(lead, h0, w0, num_disparities, p, seed, far=False):
    """(disp_fwd int32, score float32, disp_r int32) numpy patch maps of
    shape (*lead, h0, w0), built for the check's edges: disparities in
    [0, D) with a third of the patches at dL near the pixel column of
    their left edge (x - p - 1 .. x + p + 1, so dL > x and the sentinel's
    columns J - q < 0 are read); disp_r written at the columns the check
    reads, dL - 2 .. dL + 2, so |dL - dR| ties tau at 1 and 2; scores in
    [0, 1) with some exactly 0.25 and 0.5 and some NaN.  `far` sets a
    few of those dR to dL - 2^24 - 1 (a difference float32 rounds) and a
    few to dL - 2^31 (mod 2^32), whose difference wraps to INT32_MIN in
    int32, as torch computes it.  (A column left of the map, which reads
    the sentinel, lies past dL <= x: the sentinel never decides a pixel.)"""
    rng = np.random.default_rng(seed)
    shape = (*lead, h0, w0)
    d = num_disparities
    x = np.arange(w0) * p
    edge = np.clip(x + rng.integers(-p - 1, p + 2, shape), 0, d - 1)
    disp = np.where(rng.random(shape) < 1 / 3, edge,
                    rng.integers(0, d, shape)).astype(np.int32)
    right = rng.integers(0, d, shape).astype(np.int64)
    q = disp // p
    cols = np.arange(w0) - q - rng.integers(0, 2, shape)
    near = (disp + rng.integers(-2, 3, shape)).astype(np.int64)
    flat = right.reshape(-1, w0)
    rows = np.arange(flat.shape[0])[:, None]
    keep = (cols >= 0).reshape(-1, w0) & (rng.random(flat.shape) < 0.7)
    flat[np.broadcast_to(rows, flat.shape)[keep],
         cols.reshape(-1, w0)[keep]] = near.reshape(-1, w0)[keep]
    if far:
        pick = rng.random(flat.shape)
        for share, offset in (((0.0, 0.05), -2 ** 24 - 1),
                              ((0.05, 0.1), INT32_MIN)):
            odd = ((pick >= share[0]) & (pick < share[1])
                   & (cols.reshape(-1, w0) >= 0))
            flat[np.broadcast_to(rows, flat.shape)[odd],
                 cols.reshape(-1, w0)[odd]] = (disp.reshape(-1, w0)[odd]
                                               + offset)
    score = rng.random(shape, dtype=np.float32)
    pick = rng.random(shape)
    score[pick < 0.05] = 0.25
    score[(pick >= 0.05) & (pick < 0.1)] = 0.5
    score[(pick >= 0.1) & (pick < 0.12)] = np.nan
    return disp, score, right.astype(np.int32)


def config(p, tau, min_score, invalid):
    return Config(patch_size=p, tau=tau, min_score=min_score,
                  invalid_value=invalid)


def plain(disp, score, disp_r, cfg, num_disparities):
    """The plain chain, on the tensors' device: lr_consistency_patch (with
    a right map), then pixel_outputs."""
    lr_valid = None
    if disp_r is not None:
        lr_valid = pipeline.lr_consistency_patch(
            disp, disp_r, cfg.tau, num_disparities, cfg.patch_size)
    return pipeline.pixel_outputs(disp, score, cfg, disp_r, lr_valid)


def bits(t):
    """A tensor's bits on the CPU: float32 viewed as int32 (NaN payloads
    compared too)."""
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(bits(got[k]), bits(want[k])), k
