"""The benchmark's frozen copies against the program's current modules:
the pairs byte for byte, the reference's answers, the step's bound; and
that the copies import nothing of the program, of JAX or of the JAX
package."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu_torch import Config, work as port_work
from deepmatching_stereo_matching_tpu_torch.bench import make_pairs
from deepmatching_stereo_matching_tpu_torch.data import synthetic as port_syn
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch.tools.bench_large import (
    kitti_pair)
from stereobench import reference, synthetic, work

from .conftest import REPO


def test_middlebury_pairs_equal_the_bench_recipe():
    want = make_pairs(2)            # seeds 100, 101 at 450x375, D=64
    for i, (left, right, gt) in enumerate(want):
        got = synthetic.recipe_pair(100 + i, 375, 450, 64, 32)
        for a, b in zip(got, (left, right, gt)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_kitti_pairs_equal_the_bench_large_recipe():
    seed = 2 ** 31 + 99
    got = synthetic.recipe_pair(seed, 375, 1242, 256, 48)
    for a, b in zip(got, kitti_pair(seed, 256)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_generator_parts_equal_the_programs():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    fa = synthetic.block_disparity_field(50, 70, 24, rng_a, block=8)
    fb = port_syn.block_disparity_field(50, 70, 24, rng_b, block=8)
    assert fa.tobytes() == fb.tobytes()
    for a, b in zip(synthetic.make_pair(50, 70, fa, seed=3, smooth=2),
                    port_syn.make_pair(50, 70, fb, seed=3, smooth=2)):
        assert a.tobytes() == b.tobytes()


def test_rgb8_is_a_decoded_grey_image():
    plane = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    rgb = synthetic.to_rgb8(plane)
    assert rgb.shape == (3, 4, 3) and rgb.dtype == np.uint8
    assert (rgb[..., 0] == rgb[..., 2]).all() and rgb.max() == 255


@pytest.mark.parametrize("fields", [
    {}, {"lr_mode": "direct"}, {"descriptor": "grad_hist"},
    {"center_descriptors": True, "median_filter": 3, "fill_invalid": True},
    {"lr_check": False, "min_score": 0.3}])
@pytest.mark.parametrize("rgb", [False, True])
def test_reference_equals_the_oracle(fields, rgb):
    left, right, _ = synthetic.recipe_pair(11, 40, 72, 16, 16)
    if rgb:
        left, right = synthetic.to_rgb8(left), synthetic.to_rgb8(right)
    got = reference.match_stereo(left, right, reference.Config(
        max_disparity=16, **fields))
    want = oracle.match_stereo(left, right, Config(max_disparity=16,
                                                   **fields))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            assert np.array_equal(a, b, equal_nan=True), f.name


@pytest.mark.parametrize("d,h,w", [(64, 375, 450), (256, 375, 1242)])
def test_geometry_equals_the_programs(d, h, w):
    assert dataclasses.asdict(reference.Config(max_disparity=d).geometry(
        h, w)) == dataclasses.asdict(Config(max_disparity=d).geometry(h, w))


@pytest.mark.parametrize("d,w,batch,ms,by", [
    (64, 450, 32, 0.0470, "bytes"), (256, 1242, 4, 0.0372, "operations"),
    (64, 450, 128, None, "bytes"), (256, 1242, 32, None, "operations")])
def test_step_bound_equals_the_work_model(d, w, batch, ms, by):
    geom = reference.Config(max_disparity=d).geometry(375, w)
    got = work.bound(work.step_fused(reference.Config(max_disparity=d),
                                     geom, batch))
    pcfg = Config(max_disparity=d)
    want = port_work.bound(port_work.step_fused(pcfg, pcfg.geometry(375, w),
                                                batch))
    assert got == want and got[1] == by
    if ms is not None:
        assert got[0] * 1e3 == pytest.approx(ms, abs=5e-5)


def test_copies_import_nothing_of_the_program():
    code = ("import sys; import stereobench.reference, stereobench.work, "
            "stereobench.synthetic, stereobench.check; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', "
            "'jaxlib', 'flax', 'torch', 'deepmatching_stereo_matching_tpu', "
            "'deepmatching_stereo_matching_tpu_torch'}; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
