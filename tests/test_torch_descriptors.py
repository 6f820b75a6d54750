"""Descriptor normalisation in the oracle's summation order, on the CPU.

The oracle centres and normalises descriptors with NumPy's sums, which
add a float32 row pairwise; `descriptors.pairwise_sum` restates that
order with elementwise adds (which round the same way on the card).
With torch's own reduction order, a window of equal pixels centred to
rounding noise instead of exact zeros, and its unit-norm noise vector
correlated with its neighbours: on tie-heavy adversarial pairs the
`valid` map then differed from the oracle's at 1-2.5% of pixels.
"""

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch import api
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import descriptors
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("rows", ["random", "equal", "wide"])
@pytest.mark.parametrize("c", [9, 16, 64, 128, 512])
def test_pairwise_sum_is_numpys(c, rows):
    """Bitwise np.sum and np.mean over the last axis of float32 rows: C =
    9 (p = 3), 16, 64, 128 (the last single block) and 512 (grad_hist at
    p = 8: split recursively); random rows, rows of one value (a flat
    window), and rows spanning six decades."""
    rng = np.random.default_rng(c)
    if rows == "random":
        x = rng.standard_normal((6, 7, c)).astype(np.float32)
    elif rows == "equal":
        x = (np.ones((6, 7, c)) * rng.random((6, 7, 1))).astype(np.float32)
    else:
        x = (rng.standard_normal((6, 7, c))
             * 10.0 ** rng.integers(-3, 4, (6, 7, c))).astype(np.float32)
    got = descriptors.pairwise_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(np.sum(x, -1, keepdims=True)))
    mean = (descriptors.pairwise_sum(torch.from_numpy(x)) / c).numpy()
    np.testing.assert_array_equal(_bits(mean),
                                  _bits(x.mean(-1, keepdims=True)))


def test_flat_windows_centre_to_zero():
    """A window of equal pixels centres to exact zeros, as in the oracle,
    and so normalises to the zero descriptor."""
    cfg = Config(max_disparity=8, center_descriptors=True)
    img = np.full((8, 24), 0.37, np.float32)
    img[:, 12:] = np.linspace(0.1, 0.9, 12, dtype=np.float32)
    got = descriptors.right_sliding_descriptors(torch.from_numpy(img), cfg)
    want = oracle.right_sliding_descriptors(img, cfg)
    assert not got[:, :9].any()
    np.testing.assert_array_equal(got.numpy(), want)


# p = 3 seed 5 is a known near-tie in the cost volume's own order
# (ROADMAP queue 3 item 2): patch size 4 only here.
@pytest.mark.parametrize("route", ["exact", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_centred_adversarial_pair_matches_the_oracle(seed, route):
    """`adversarial_pair(97, 141, 24, seed)` with centred descriptors:
    `valid` and `disparity_raw` equal to the oracle's on the kernel route
    (plain versions on the CPU) and the stock-torch route."""
    cfg = Config(max_disparity=24, center_descriptors=True)
    left, right, _, _ = synthetic.adversarial_pair(97, 141, 24, seed)
    want = oracle.match_stereo(left, right, cfg)
    got = api.match_stereo(left, right, cfg, impl=route, device="cpu")
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.disparity_raw, want.disparity_raw)
