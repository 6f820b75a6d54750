"""ZNCC matching (centred patch descriptors) at Middlebury 2003 Q on the
CPU: the benchmark configuration's geometry and route, the batched,
flip-stacked step on the port's normal path (`match_padded_core(route=
"fused")`, which centred descriptors send down the exact route: torch
descriptors, K2, K3) against the port's NumPy oracle, the benchmark's
frozen count of K2's and K3's work and its three readers, and the CLI's and
the evaluation tool's `--center-descriptors` (csrc/costvol.cu and
csrc/pyramid.cu run only on the card: tests/test_torch_zncc_card.py holds
them at the cell's full size there).

Tolerances, each with its reason:
  * decisions, LR validity, output and right-view disparities: bitwise.
    The exact route's contract (ROADMAP north star) is the oracle's
    decisions: its descriptor sums run in NumPy's pairwise order
    (`descriptors.pairwise_sum`), and K2's and K3's plain versions
    round as the oracle does;
  * scores: rtol 1e-5, the exact route's stated contract, plus atol 1e-6
    (tests/test_torch_cli_checks.py's centred bound): the cost is a dot
    of two unit descriptors, C = 16 products, which the plain cost volume
    and the oracle add in different orders; its rounding error is bounded
    in absolute terms (~16 ulps of 1.0) however small the dot, and
    centred descriptors give dots near 0, where a relative bound alone
    fails on one rounding (1.5e-8 off a 1e-4 score at the cell's size).
"""

import dataclasses
import importlib.util
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmatching_stereo_matching_tpu_torch import cli, profile_steps, work
from deepmatching_stereo_matching_tpu_torch.config import Config, Geometry
from deepmatching_stereo_matching_tpu_torch.io import writers
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda, pyramid_cuda
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch.tools import eval_dataset
from stereobench import harness, k2k3, k4k5, synthetic, tracing
from stereobench import reference as frozen
from stereobench import work as bench_work

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "middlebury03_q_d64_zncc.step_b32"
with open(os.path.join(REPO, "stereobench", "configs",
                       "middlebury03_q_d64_zncc.json")) as _f:
    CONF = json.load(_f)
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-6
# A CPU size that resolves as the cell does (L = 4, D0 = 64 at
# max_disparity 64), with a ragged crop on both sides.
SMALL_H, SMALL_W = 130, 170
SEEDS = (2 ** 31 + 7, 3, 11)


def zncc(**fields):
    return Config(**{**CONF["config"], **fields})


def padded(img, geom):
    return oracle.pad_image(oracle.to_grayscale_f32(img), geom)


def recipe_pairs(h, w, seeds):
    """The cell's pairs (the frozen recipe, 32 x 32 blocks) at h x w."""
    return [synthetic.recipe_pair(s, h, w, 64, CONF["recipe"]["block"])[:2]
            for s in seeds]


def batch(cfg, geom, pairs):
    return tuple(torch.from_numpy(np.stack([padded(p[j], geom)
                                            for p in pairs]))
                 for j in (0, 1))


def test_config_resolves_to_the_exact_route():
    """The cell's configuration: the main Middlebury cell's fields with
    centred descriptors, on the 'fused' route, which `fused_cuda` refuses
    at this geometry and K3 covers: torch descriptors -> K2 -> K3."""
    with open(os.path.join(REPO, "stereobench", "configs",
                           "middlebury03_q_d64.json")) as f:
        main_cell = json.load(f)
    assert CONF["config"] == {**main_cell["config"],
                              "center_descriptors": True}
    assert (CONF["height"], CONF["width"], CONF["geometry"]) == (
        main_cell["height"], main_cell["width"], main_cell["geometry"])
    assert CONF["route"] == "fused" and CONF["reduced"] == []
    assert CONF["recipe"] == {"block": 32}
    assert CONF["control"] == {"dtype": "bfloat16"}
    cfg = zncc()
    geom = cfg.geometry(CONF["height"], CONF["width"])
    assert geom == Geometry(height=375, width=450, levels=4,
                            padded_height=384, padded_width=512, grid_h=96,
                            grid_w=128, disparities=64)
    assert dataclasses.asdict(frozen.Config(**CONF["config"]).geometry(
        375, 450)) == dataclasses.asdict(geom)
    assert not fused_cuda.supported(cfg, geom)
    assert not fused_cuda.cost_supported(cfg, geom)
    assert pyramid_cuda.supported(geom.disparities, geom.levels)
    small = cfg.geometry(SMALL_H, SMALL_W)
    assert (small.levels, small.disparities) == (4, 64)
    assert min(SMALL_H, SMALL_W) >= 128


def test_manifest_entries():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = {w["name"]: w for w in manifest["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "middlebury03_q_d64_zncc", "step_b32", 1)
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert CELL in e2e["step_mpx_per_s"]["workloads"]
    readers = {m["name"]: m for m in manifest["per_layer"]
               if CELL in m.get("workloads", [])}
    assert set(readers) == {"kernels.k2_roofline.step",
                            "kernels.k3_roofline.step",
                            "kernels.torch_ms.step"}
    assert all(m["workloads"] == [CELL]
               and m["moves"] == "step_mpx_per_s"
               for m in readers.values())


def test_batched_step_matches_the_oracle():
    """The batched, flip-stacked step of three pairs on the normal path
    (`route="fused"`), pair by pair against `oracle.match_stereo`."""
    cfg = zncc()
    geom = cfg.geometry(SMALL_H, SMALL_W)
    pairs = recipe_pairs(SMALL_H, SMALL_W, SEEDS)
    out = pipeline.crop(pipeline.match_padded_core(*batch(cfg, geom, pairs),
                                                   cfg, geom, "fused"),
                        SMALL_H, SMALL_W)
    for i, (left, right) in enumerate(pairs):
        want = oracle.match_stereo(left, right, cfg)
        for k in ("disparity_raw", "valid", "disparity_right"):
            np.testing.assert_array_equal(out[k][i].numpy(),
                                          getattr(want, k), err_msg=k)
        np.testing.assert_array_equal(out["disparity"][i].numpy(),
                                      want.disparity)
        np.testing.assert_allclose(out["score"][i].numpy(), want.score,
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
    # The centring changes the answers: the uncentred oracle disagrees.
    plain = oracle.match_stereo(*pairs[0], zncc(center_descriptors=False))
    assert (plain.score != out["score"][0].numpy()).any()


def test_batched_step_matches_the_frozen_reference():
    """The benchmark's frozen NumPy reference, which decides the cell's
    `correct`, agrees with the step as the oracle does (one pair)."""
    cfg = zncc()
    geom = cfg.geometry(SMALL_H, SMALL_W)
    pairs = recipe_pairs(SMALL_H, SMALL_W, SEEDS[:1])
    out = pipeline.crop(pipeline.match_padded_core(*batch(cfg, geom, pairs),
                                                   cfg, geom, "fused"),
                        SMALL_H, SMALL_W)
    want = frozen.match_stereo(*pairs[0], frozen.Config(**CONF["config"]))
    for k in ("disparity_raw", "valid", "disparity_right"):
        np.testing.assert_array_equal(out[k][0].numpy(), getattr(want, k))


def test_step_launches_k2_and_k3_once(monkeypatch):
    """A flip-mode step calls the cost-volume and pyramid wrappers once
    each, on the stacked 2 x batch instances, and no fused kernel (on
    the card these are one K2 and one K3 launch)."""
    calls = Counter()
    for mod, name in ((pipeline.costvol_cuda, "cost_volume_dmajor"),
                      (pipeline.pyramid_cuda, "pyramid_backtrack"),
                      (pipeline.pyramid_cuda, "aggregate_dmajor"),
                      (pipeline.fused_cuda, "match_planes"),
                      (pipeline.fused_cuda, "cost_volume_rows")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    cfg = zncc()
    geom = cfg.geometry(SMALL_H, SMALL_W)
    pipeline.match_padded_core(*batch(cfg, geom, recipe_pairs(
        SMALL_H, SMALL_W, SEEDS[:2])), cfg, geom, "fused")
    assert calls == Counter({"cost_volume_dmajor": 1,
                             "pyramid_backtrack": 1})


@pytest.mark.parametrize("lr_mode", ["flip", "direct"])
def test_stage_rows_of_the_exact_route(lr_mode):
    """`profile_steps`'s stage rows for the exact route: descriptors, cost
    and pyramid once each inside `match`, which a flip-mode step opens
    once (on the stacked directions) and a direct-mode step twice; the
    outputs bitwise those of the step without the profiler."""
    cfg = zncc(lr_mode=lr_mode)
    geom = cfg.geometry(SMALL_H, SMALL_W)
    lp, rp = batch(cfg, geom, recipe_pairs(SMALL_H, SMALL_W, SEEDS[:1]))
    off = pipeline.match_padded_core(lp, rp, cfg, geom, "fused")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = pipeline.match_padded_core(lp, rp, cfg, geom, "fused")
    for k in off:
        assert torch.equal(off[k].view(torch.uint8), on[k].view(torch.uint8))
    calls = {name: c for name, c, _, _, _
             in profile_steps.stage_rows(prof.events(), 1)}
    n = 1 if lr_mode == "flip" else 2
    assert calls == {"dm.pipeline.step": 1, "dm.pipeline.match": n,
                     "dm.pipeline.descriptors": n, "dm.pipeline.cost": n,
                     "dm.pipeline.pyramid": n, "dm.pipeline.lr_check": 1,
                     "dm.pipeline.outputs": 1,
                     **({"dm.pipeline.flip": 2} if n == 1 else {})}
    assert "zncc" in profile_steps.CELLS and "zncc" in profile_steps.CENTRED


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,n", [(375, 450, 64), (SMALL_H, SMALL_W, 3)])
def test_benchmark_work_equals_the_port(h, w, n, dtype):
    """The benchmark's frozen counts of K2 and K3 (`stereobench/k2k3.py`)
    are the port's `work.k2` and `work.k3`, term by term, and so are
    their bounds; at the cell's 64 instances both are bound by bytes at
    0.1352 and 0.0620 ms (PERF.md's K2 and K3 rows)."""
    rcfg = frozen.Config(**{**CONF["config"], "dtype": dtype})
    pcfg = zncc(dtype=dtype)
    rgeom, pgeom = rcfg.geometry(h, w), pcfg.geometry(h, w)
    for got, want in ((k2k3.k2(rcfg, rgeom, n), work.k2(pcfg, pgeom, n)),
                      (k2k3.k3(rcfg, rgeom, n), work.k3(pcfg, pgeom, n))):
        assert got.bytes == want.bytes and got.ops == want.ops
        assert bench_work.bound(got) == work.bound(want)
    if (h, dtype) == (375, "float32"):
        for fn, ms in ((work.k2, 0.1352), (work.k3, 0.0620)):
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


K2_OP = ("void (anonymous namespace)::costvol_kernel<false, 4, float>"
         "(...)")
K3_OP = "void (anonymous namespace)::pyramid_kernel<false>(...)"
TORCH_OP = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::AddFunctor<float>, ...>(...)")
OPS = [(K2_OP, 0.100, 0.1004), (K3_OP, 0.1004, 0.1006),
       (TORCH_OP, 0.09, 0.0999), ("Memcpy DtoD (Device -> Device)", 0.3,
                                  0.31),
       ("void lr_outputs_kernel(...)", 0.31, 0.32),
       (K2_OP, 0.200, 0.2003), (K3_OP, 0.2003, 0.2005),
       (TORCH_OP, 0.19, 0.1992),
       (K2_OP, 0.9999, 1.0003)]                    # clipped to the window


def test_roofline_readers():
    """The K2 and K3 readers: each kernel's least time a step (the cell's
    64 instances) over its device time a step, from operations named
    after its symbol alone; None on an empty trace, one with no step, or
    one without the kernel."""
    rec = _record(OPS, steps=2)
    cfg = zncc()
    geom = cfg.geometry(375, 450)
    assert k4k5.instances(rec) == 64
    for name, fn, sec in (
            ("kernels.k2_roofline.step", work.k2,
             (0.0004 + 0.0003 + 0.0001) / 2),
            ("kernels.k3_roofline.step", work.k3, (0.0002 + 0.0002) / 2)):
        least = work.bound(fn(cfg, geom, 64))[0]
        assert _reader(name)(rec) == pytest.approx(100 * least / sec)
        for none in (_record([], steps=2), _record(OPS, steps=0),
                     _record([(TORCH_OP, 0.1, 0.2)], steps=2)):
            assert _reader(name)(none) is None


def test_torch_ms_reader():
    """`kernels.torch_ms.step`: the device ms a step of torch's own
    kernels (names holding `at::native`): not the port's kernels, not
    memcpy; None without one or without a step."""
    read = _reader("kernels.torch_ms.step")
    assert read(_record(OPS, steps=2)) == pytest.approx(
        (0.0099 + 0.0092) / 2 * 1e3)
    for none in (_record([], steps=2), _record(OPS, steps=0),
                 _record([(K2_OP, 0.1, 0.2)], steps=2)):
        assert read(none) is None


def test_cli_center_descriptors(tmp_path, capsys):
    """`--center-descriptors` reaches the config, and the CLI's demo pair
    through it equals the centred oracle's."""
    out = tmp_path / "out"
    argv = ["--demo", "--demo-size", "64", "96", "-D", "16", "--cpu",
            "--center-descriptors", "-o", str(out)]
    assert cli.main(argv) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["config"]["center_descriptors"] is True
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    assert cfg == Config(max_disparity=16, center_descriptors=True)
    assert not cli.config_from_args(cli.build_parser().parse_args(
        ["--demo"])).center_descriptors
    from deepmatching_stereo_matching_tpu_torch.data import synthetic as syn
    field = syn.block_disparity_field(64, 96, 16, np.random.default_rng(0),
                                      block=32, align=4)
    left, right, _ = syn.make_pair(64, 96, field, seed=0)
    want = oracle.match_stereo(left, right, cfg)
    got = writers.read_pfm(str(out / "disparity.pfm"))
    np.testing.assert_array_equal(np.isinf(got), np.isnan(want.disparity))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want.disparity[np.isfinite(want.disparity)])


def test_eval_tool_center_descriptors(tmp_path, capsys, monkeypatch):
    """The evaluation tool's `--center-descriptors` sets the config it
    matches and checks with: decisions equal the centred oracle's."""
    from deepmatching_stereo_matching_tpu_torch import api
    left, right = recipe_pairs(SMALL_H, SMALL_W, SEEDS[:1])[0]
    for side, img in (("left", left), ("right", right)):
        writers._to_png(str(tmp_path / f"p_{side}.png"),
                        np.rint(img * 255).astype(np.uint8))
    seen = []
    real = api.match_stereo

    def spy(left, right, cfg, **kw):
        seen.append(cfg.center_descriptors)
        return real(left, right, cfg, **kw)
    monkeypatch.setattr(api, "match_stereo", spy)
    out = tmp_path / "report.json"
    assert eval_dataset.main([str(tmp_path), "-D", "64", "--cpu",
                              "--oracle-check", "1", "--center-descriptors",
                              "--out", str(out)]) == 0
    with open(out) as f:
        report = json.load(f)
    assert seen == [True]
    row, = report["pairs"]
    assert row["oracle_decision_disagreement"] == 0.0
    assert row["oracle_valid_disagreement"] == 0.0
