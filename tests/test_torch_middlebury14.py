"""Middlebury 2014 at full resolution (F: 2880x1988, ndisp 290) on the
CPU: the benchmark configuration's geometry and route, the six-level
pyramid's passes (K5 takes five levels a launch, so L = 6 takes two), the
plain versions of the `fused` large-D step at L = 6 against the port's
NumPy oracle, the benchmark's frozen reference, its frozen count of K4's
and K5's work, and its two readers of them (csrc/costrows.cu and
csrc/aggregate.cu run only on the card: tests/
test_torch_middlebury14_card.py holds them at the cell's full size
there).

Tolerances, each with its reason:
  * K5's plain version at L = 6 against the oracle's pyramid: every
    level's pool offsets equal (the pools are the oracle's, op for op);
    the exact-mode top map within a relative 1e-6: the plain version's
    power is correctly rounded (float64, rounded once, as K5 exact), the
    oracle's is numpy's float32 power, and the two part by up to an ulp
    at each of the six levels (3 ulps measured);
  * the `fused` step at L = 6: decisions and LR validity equal to the
    oracle's, right disparities within the fused routes' 0.5% gate (the
    fast power and the algebraic norms may flip a near-tie: one 4 x 4
    patch of the auto-resolved case's right view does), and scores within
    2e-5 where the decision agrees, the bound of the L = 5 large-D step
    test (tests/test_torch_cost_magbin.py): the level-0 cost differs from
    the oracle's by rounding alone;
  * the passes: the plain passes of `aggregate_dmajor` bitwise one plain
    pyramid over all levels, in either mode and dtype.
"""

import dataclasses
import importlib.util
import json
import os
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmatching_stereo_matching_tpu_torch import profile_steps, work
from deepmatching_stereo_matching_tpu_torch.config import Config, Geometry
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import (_build, fused_cuda,
                                                        pyramid_cuda)
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
from stereobench import harness, k4k5, tracing
from stereobench import reference as frozen
from stereobench import work as bench_work

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "middlebury14_f_d290.step_b16"
with open(os.path.join(REPO, "stereobench", "configs",
                       "middlebury14_f_d290.json")) as _f:
    CONF = json.load(_f)
F_H, F_W = CONF["height"], CONF["width"]
TOP_RTOL = 1e-6
FUSED_DECISION_TOL = 0.005
SCORE_ATOL = 2e-5
# (height, width, Config fields, field disparity range, field block): a
# six-level pyramid at a CPU size, set (D0 = 128 on a 64 x 128 patch
# grid), and resolved from the image as at F (512 px on the short side,
# max_disparity 290: D0 = 320 on a 128 x 192 grid).
SMALL_L6 = {
    "levels_set": (256, 320, dict(max_disparity=100, levels=6), 96, 64),
    "auto": (512, 576, dict(max_disparity=290), 288, 32),
}


def pair(seed, h, w, field_d, block):
    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(h, w, field_d, rng, block=block)
    return synthetic.make_pair(h, w, field, seed=seed)[:2]


def padded(img, geom):
    return oracle.pad_image(oracle.to_grayscale_f32(img), geom)


def small_case(name, seeds):
    h, w, fields, field_d, block = SMALL_L6[name]
    cfg = Config(**fields)
    geom = cfg.geometry(h, w)
    return cfg, geom, [pair(s, h, w, field_d, block) for s in seeds]


def step(cfg, geom, pairs):
    lp, rp = (torch.from_numpy(np.stack([padded(p[j], geom) for p in pairs]))
              for j in (0, 1))
    return pipeline.crop(pipeline.match_padded_core(lp, rp, cfg, geom,
                                                    "fused"),
                         geom.height, geom.width)


def test_config_resolves_to_six_levels_on_k4_then_k5():
    """The cell's configuration at 2880 x 1988: L = 6, D0 = 320, past
    K1's and K3's blocks, inside K4's, two K5 launches; at the 16-pair
    step's 32 instances the volume and K5's offsets pass 2^31."""
    cfg = Config(**CONF["config"])
    geom = cfg.geometry(F_H, F_W)
    assert geom == Geometry(height=1988, width=2880, levels=6,
                            padded_height=2048, padded_width=3072,
                            grid_h=512, grid_w=768, disparities=320)
    assert {k: getattr(geom, k) for k in CONF["geometry"]} \
        == CONF["geometry"]
    rcfg = frozen.Config(**CONF["config"])
    assert dataclasses.asdict(rcfg.geometry(F_H, F_W)) \
        == dataclasses.asdict(geom)
    assert CONF["route"] == "fused" and CONF["reduced"] == []
    assert not fused_cuda.supported(cfg, geom)
    assert not pyramid_cuda.supported(geom.disparities, geom.levels)
    assert fused_cuda.cost_supported(cfg, geom)
    assert fused_cuda.cost_tile_rows(4, 290) == 8
    assert pyramid_cuda.aggregate_launches(geom.levels) == 2
    n = 32
    assert n * 320 * 512 * 768 == 4_026_531_840 > 2 ** 31
    offs, size = pyramid_cuda.arg_offsets(n, 320, 512, 768, 6)
    assert offs[1] == n * 160 * 512 * 768 == 2_013_265_920
    assert size == 2_300_866_560 > 2 ** 31
    for d0 in (257, 320):           # any ndisp from 257 to 320 alike
        other = dataclasses.replace(cfg, max_disparity=d0)
        assert other.geometry(F_H, F_W) == geom


@pytest.mark.parametrize("levels,launches", [(1, 1), (5, 1), (6, 2),
                                             (10, 2), (11, 3)])
def test_aggregate_launches(levels, launches):
    assert pyramid_cuda.aggregate_launches(levels) == launches


def test_card_path_launches_two_passes(monkeypatch):
    """On the card (a fake library here), six levels take two K5
    launches, each in its own span (`pipeline.aggregate_pass0`, then
    `pipeline.aggregate_pass1`): levels 0-4
    from the volume into the offsets' base, then level 5 from the level-5
    map, with the power at its level 0 (pow_first), into the base plus
    levels 0-4's bytes."""
    called = []

    class FakeLibrary:
        def __getattr__(self, symbol):
            def launch(*args):
                called.append((symbol, args))
                return 0
            return launch

    monkeypatch.setattr(pyramid_cuda, "run_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "library", FakeLibrary)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_build, "launches", Counter())
    n, d0, h0, w0 = 3, 128, 64, 128
    vol = torch.rand(n, d0, h0, w0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        top, args = pyramid_cuda.aggregate_dmajor(vol, 6, 1.4, fast=True)
    assert _build.launches == Counter({"K5": 2})
    assert [s for s, _ in called] == ["dm_aggregate"] * 2
    first, second = (a for _, a in called)
    offs, _ = pyramid_cuda.arg_offsets(n, d0, h0, w0, 6)
    assert first[0] == vol.data_ptr()
    assert first[3:10] == (n, d0, h0, w0, 5, 1, 0)
    assert second[0] == first[1] and second[2] == first[2] + offs[5]
    assert second[3:10] == (n, d0 >> 5, h0 >> 5, w0 >> 5, 1, 1, 1)
    assert second[1] == top.data_ptr() and top.shape == (n, 2, 1, 2)
    assert [a.data_ptr() - first[2] for a in args] == offs
    names = Counter(e.name for e in prof.events())
    assert names["dm.pipeline.aggregate_pass0"] == 1
    assert names["dm.pipeline.aggregate_pass1"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("levels", [6, 7])
def test_plain_passes_are_one_plain_pyramid(levels, fast, dtype):
    """On the CPU `aggregate_dmajor` runs the plain version pass by pass,
    as the card launches K5: bitwise one plain pyramid over all levels."""
    gen = torch.Generator().manual_seed(levels)
    size = 2 ** levels
    vol = torch.rand(2, size, size, 2 * size, generator=gen).to(dtype)
    want_top, want_args = pyramid_cuda.aggregate_dmajor_torch(
        vol, levels, 1.4, fast)
    top, args = pyramid_cuda.aggregate_dmajor(vol, levels, 1.4, fast)
    assert top.dtype == dtype and torch.equal(top, want_top)
    assert len(args) == levels
    assert all(torch.equal(a, b) for a, b in zip(args, want_args))


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_k5_at_six_levels_is_the_oracle_pyramid(seed):
    """`aggregate_dmajor_torch` at L = 6 on an oracle cost volume: every
    level's offsets equal to the oracle's `build_pyramid` (exact and
    fast: the deferred power moves no winner here), the exact top map
    within TOP_RTOL."""
    cfg, geom, pairs = small_case("levels_set", [seed])
    lp, rp = (padded(x, geom) for x in pairs[0])
    cost0 = oracle.cost_volume(oracle.left_descriptors(lp, cfg),
                               oracle.right_sliding_descriptors(rp, cfg),
                               geom.disparities, cfg.patch_size,
                               cfg.max_disparity)
    maps, want_args = oracle.build_pyramid(cost0, 6, cfg.lam)
    vol = torch.from_numpy(np.ascontiguousarray(cost0.transpose(2, 0, 1)))
    for fast in (False, True):
        top, args = pyramid_cuda.aggregate_dmajor_torch(vol, 6, cfg.lam,
                                                        fast)
        assert top.shape == (2, 1, 2)
        for got, want in zip(args, want_args):
            np.testing.assert_array_equal(got.numpy(),
                                          want.transpose(2, 0, 1))
        if not fast:
            np.testing.assert_allclose(top.numpy(),
                                       maps[6].transpose(2, 0, 1),
                                       rtol=TOP_RTOL, atol=0)


@pytest.mark.parametrize("name", sorted(SMALL_L6))
def test_fused_step_matches_the_oracle(name):
    """The whole `fused` step (K4, K5 in two passes, the walk, the LR
    check, the outputs) at L = 6, two pairs at once, against
    `oracle.match_stereo`."""
    cfg, geom, pairs = small_case(name, (5, 6))
    assert geom.levels == 6
    assert not fused_cuda.supported(cfg, geom)
    assert fused_cuda.cost_supported(cfg, geom)
    out = step(cfg, geom, pairs)
    for i, (left, right) in enumerate(pairs):
        want = oracle.match_stereo(left, right, cfg)
        for k in ("disparity_raw", "valid"):
            np.testing.assert_array_equal(out[k][i].numpy(),
                                          getattr(want, k), err_msg=k)
        np.testing.assert_array_equal(out["disparity"][i].numpy(),
                                      want.disparity)
        rate = np.mean(out["disparity_right"][i].numpy()
                       != want.disparity_right)
        assert rate <= FUSED_DECISION_TOL, rate
        err = np.abs(out["score"][i].numpy() - want.score)
        assert err.max() <= SCORE_ATOL, err.max()


def test_step_runs_two_aggregate_passes():
    """The L = 6 step's stages: one `aggregate` holding the spans of its
    two passes (`profile_steps.stage_rows`, per step)."""
    cfg, geom, pairs = small_case("levels_set", (5,))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(cfg, geom, pairs)
    calls = {name: c for name, c, _, _, _
             in profile_steps.stage_rows(prof.events(), 1)}
    assert calls["dm.pipeline.cost"] == 1
    assert calls["dm.pipeline.aggregate"] == 1
    assert calls["dm.pipeline.aggregate_pass0"] == 1
    assert calls["dm.pipeline.aggregate_pass1"] == 1
    assert calls["dm.pipeline.walk"] == 1


@pytest.mark.parametrize("rgb", [False, True])
def test_frozen_reference_equals_the_oracle(rgb):
    """The benchmark's frozen NumPy reference, which decides the cell's
    `correct`, is the port's oracle at L = 6, field by field, bitwise."""
    cfg, _, pairs = small_case("levels_set", (9,))
    left, right = pairs[0]
    if rgb:
        left, right = (np.repeat(np.rint(x * 255).astype(np.uint8)[..., None],
                                 3, -1) for x in (left, right))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(frozen.Config)}
    got = frozen.match_stereo(left, right, frozen.Config(**fields))
    want = oracle.match_stereo(left, right, cfg)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            assert np.array_equal(a, b, equal_nan=True), f.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_d,h,w,n", [(290, F_H, F_W, 32),
                                         (256, 375, 1242, 64),
                                         (100, 256, 320, 3)])
def test_benchmark_work_equals_the_port(max_d, h, w, n, dtype):
    """The benchmark's frozen counts of K4 and K5 (`stereobench/k4k5.py`)
    are the port's `work.k4` and `work.k5`, term by term, and so are
    their bounds; at the cell's 32 instances both are bound by bytes at
    5.2886 and 5.4946 ms."""
    rcfg = frozen.Config(max_disparity=max_d, dtype=dtype,
                         levels=6 if max_d == 100 else None)
    pcfg = Config(max_disparity=max_d, dtype=dtype,
                  levels=6 if max_d == 100 else None)
    rgeom, pgeom = rcfg.geometry(h, w), pcfg.geometry(h, w)
    for got, want in ((k4k5.k4(rcfg, rgeom, n), work.k4(pcfg, pgeom, n)),
                      (k4k5.k5(rcfg, rgeom, n), work.k5(pcfg, pgeom, n))):
        assert got.bytes == want.bytes and got.ops == want.ops
        assert bench_work.bound(got) == work.bound(want)
    if (max_d, dtype) == (290, "float32"):
        for fn, ms in ((work.k4, 5.2886), (work.k5, 5.4946)):
            least, by = work.bound(fn(pcfg, pgeom, n))
            assert by == "bytes" and least * 1e3 == pytest.approx(ms,
                                                                  abs=1e-4)


def _record(ops, steps, window=1.0):
    c = harness.load_cell(REPO, CELL)
    cfg = frozen.Config(**c.config["config"])
    trace = tracing.Trace(window_s=window,
                          spans={"step": [(0.1 * i, 0.1 * i + 0.05)
                                          for i in range(steps)]},
                          device_ops=ops)
    return harness.Record(cell=CELL, config=c.config, traffic=c.traffic,
                          cfg=cfg, geom=cfg.geometry(c.config["height"],
                                                     c.config["width"]),
                          batch=c.traffic["batch"], trace=trace, logs=[],
                          values={})


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"),
        os.path.join(REPO, "stereobench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_benchmark_readers():
    """The K4 and K5 readers: each kernel's least time a step (32
    instances) over its device time a step, from operations named after
    its symbol alone (K4b's and the rest do not count; both K5 passes
    do); None on an empty trace or one with no step."""
    k4 = "void (anonymous namespace)::costrows_kernel<4, float>(...)"
    k4b = ("void (anonymous namespace)::costrows_magbin_kernel<4, float>"
           "(...)")
    k5 = ("void (anonymous namespace)::aggregate_kernel<false, true, true>"
          "(...)")
    ops = [(k4, 0.100, 0.108), (k5, 0.108, 0.114), (k5, 0.114, 0.1142),
           (k4b, 0.2, 0.3), ("elementwise_kernel", 0.3, 0.31),
           (k4, 0.200, 0.208), (k5, 0.208, 0.2142),
           (k4, 0.995, 1.004)]                     # clipped to the window
    rec = _record(ops, steps=2)
    cfg = Config(**CONF["config"])
    geom = cfg.geometry(F_H, F_W)
    for name, fn, sec in (
            ("kernels.k4_roofline.step", work.k4, (0.008 + 0.008 + 0.005) / 2),
            ("kernels.k5_roofline.step", work.k5, (0.006 + 0.0002 + 0.0062) / 2)):
        least = work.bound(fn(cfg, geom, 32))[0]
        assert _reader(name)(rec) == pytest.approx(100 * least / sec)
        for none in (_record([], steps=2), _record(ops, steps=0),
                     _record([(k4b, 0.1, 0.2)], steps=2)):
            assert _reader(name)(none) is None
