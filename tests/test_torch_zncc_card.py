"""ZNCC matching (centred patch descriptors) at Middlebury 2003 Q on the
card, at the benchmark cell's size: one 32-pair step of
`match_padded_core(route="fused")` at 450x375, max_disparity 64, which
centred descriptors send down the exact route (torch descriptors on the
card, one K2 launch over the 64 flip-stacked instances, one K3 launch,
then EPI).

The first and the last pair of the step are held to the port's NumPy
oracle on the host: decisions, LR validity, output and right-view
disparities bitwise (the exact route's contract: its descriptor sums run
in NumPy's pairwise order, elementwise on the card as on the host, and K2
and K3 round as the oracle does), scores within rtol 1e-5, the exact
route's stated contract, plus atol 1e-6: the score is a dot of two unit
descriptors, 16 products, which K2 adds in another order than NumPy; its
rounding error is bounded in absolute terms (~16 ulps of 1.0) however
small the dot, and centred descriptors give dots near 0, where a relative
bound alone fails on one rounding (1.5e-8 off a 1e-4 score).  The first
pair lies at the start of both stacked directions, the last at the end of
each, where an indexing fault over the stacked batch would show.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_zncc_card.py --noconftest -s` (the machine with the card
has no JAX, and tests/conftest.py imports it).  tests/test_torch_zncc.py
holds the plain versions to the oracle at a small geometry on the CPU.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import _build, pyramid_cuda
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle

pytestmark = pytest.mark.card

H, W, MAX_D, PAIRS, BLOCK = 375, 450, 64, 32, 32
SEED0 = 2 ** 31 + 24
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-6


@pytest.fixture(scope="module")
def step():
    """(cfg, pairs, host outputs, launches): one 32-pair centred step on
    the card, from the benchmark's recipe (32 x 32 blocks of disparity),
    after a first step that builds the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    cfg = Config(max_disparity=MAX_D, center_descriptors=True)
    geom = cfg.geometry(H, W)
    assert (geom.levels, geom.disparities) == (4, 64)
    assert pyramid_cuda.supported(geom.disparities, geom.levels)
    pairs = []
    for s in range(SEED0, SEED0 + PAIRS):
        field = synthetic.block_disparity_field(
            H, W, MAX_D, np.random.default_rng(s), block=BLOCK)
        pairs.append(synthetic.make_pair(H, W, field, seed=s)[:2])
    dev = torch.device("cuda", 0)
    left, right = (torch.from_numpy(np.stack([
        oracle.pad_image(oracle.to_grayscale_f32(p[j]), geom)
        for p in pairs])).to(dev) for j in (0, 1))
    pipeline.match_padded_core(left, right, cfg, geom, "fused")
    torch.cuda.synchronize()
    before = _build.launches.copy()
    out = pipeline.match_padded_core(left, right, cfg, geom, "fused")
    torch.cuda.synchronize()
    launched = _build.launches - before
    host = {k: v[:, :H, :W].cpu().numpy() for k, v in out.items()}
    return cfg, pairs, host, launched


def test_step_launches_k2_and_k3_once(step):
    _, _, _, launched = step
    assert launched == Counter({"K2": 1, "K3": 1, "EPI": 1})


@pytest.mark.parametrize("i", [0, PAIRS - 1], ids=["first", "last"])
def test_pair_matches_the_oracle(step, i):
    cfg, pairs, out, _ = step
    want = oracle.match_stereo(*pairs[i], cfg)
    for k in ("disparity_raw", "valid", "disparity_right"):
        np.testing.assert_array_equal(out[k][i], getattr(want, k),
                                      err_msg=k)
    np.testing.assert_array_equal(out["disparity"][i], want.disparity)
    np.testing.assert_allclose(out["score"][i], want.score,
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    print(f"\ncentred step pair {i}: LR-valid share "
          f"{float(out['valid'][i].mean())!r}")
