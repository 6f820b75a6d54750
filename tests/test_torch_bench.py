"""The port's bench and KITTI bench against the reference's, on the CPU.

  * the pairs: `bench.make_pairs` bitwise the root bench.py's, and the
    KITTI recipe (seeds 0 and 7, block 48) bitwise the JAX package's
    `synthetic` calls of tools/bench_large.py;
  * `parity_gate` at 96x128, D=16, levels 2 on 2 pairs: passes on 'exact'
    and 'fused', and names the failure when one disparity_right value is
    changed or 0.6% of the fused decisions are flipped;
  * `adversarial_row` at 80x120, D=16, seeds 0-1 on 'exact': occlusion
    rejection and kept bad rate within 0.005 of the same row computed
    from the JAX package's `match_padded(..., "jnp")`, both within the
    bench's 0.01 of the oracle's decisions;
  * `step_mpxs` and `timing`: ordered positive samples, each covering at
    least MIN_SAMPLE_S, one bad rate per pair;
  * `main` of both tools, with their sizes cut: one stdout line with the
    documented keys and exit 0; exit 1 on a gate failure with no stdout
    line; exit 2 without a card and without --cpu (also as `python -m`);
    bench_large's rows carry exactly the reference's keys, it writes a
    file only with --out, and neither tool changes BENCH_LARGE.json or
    ORACLE_BASELINE.json;
  * `sharded_smoke`: the four strategies equal to the unsharded pipeline
    in a world of one gloo rank, the world gone afterwards.
"""

import ast
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402  (the reference's root bench.py)

from deepmatching_stereo_matching_tpu import Config as JConfig  # noqa: E402
from deepmatching_stereo_matching_tpu.data import synthetic as jsynthetic  # noqa: E402
from deepmatching_stereo_matching_tpu.models import pipeline as jpipeline  # noqa: E402
from deepmatching_stereo_matching_tpu.oracle import reference as joracle  # noqa: E402
from deepmatching_stereo_matching_tpu_torch import bench  # noqa: E402
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle  # noqa: E402
from deepmatching_stereo_matching_tpu_torch.tools import bench_large  # noqa: E402

CPU = torch.device("cpu")
SMALL_HW, SMALL_D = (96, 128), 16
FILES = ("BENCH_LARGE.json", "ORACLE_BASELINE.json")
# The gate of bench.py:52, restated here so that a change shows.
FUSED_DECISION_TOL = 0.005


def reference_row_keys():
    """The keys of the row dict in tools/bench_large.py (lines 122-134)."""
    with open(os.path.join(REPO, "tools", "bench_large.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "row"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no row dict in tools/bench_large.py")


def file_hashes():
    return {f: hashlib.sha256(open(os.path.join(REPO, f), "rb").read())
            .hexdigest() for f in FILES}


@pytest.fixture(scope="module")
def small_parity():
    """Two bench-recipe pairs at 96x128, D=16, and the oracle's outputs
    at levels 2."""
    pairs = bench.make_pairs(2, *SMALL_HW, SMALL_D)
    cfg = bench.bench_config(SMALL_D, levels=2)
    want = [oracle.match_stereo(l, r, cfg) for l, r, _ in pairs]
    return pairs, want


@pytest.fixture
def small_bench(monkeypatch):
    """The bench's module constants cut to a CPU-sized run."""
    for name, value in (("H", 64), ("W", 96), ("MAX_D", 16), ("BATCH", 2),
                        ("PARITY_PAIRS", 2), ("REPEATS", 1),
                        ("SHARDED_BATCH", 2), ("ADV_HW", (80, 120))):
        monkeypatch.setattr(bench, name, value)


@pytest.fixture
def small_large(monkeypatch):
    """bench_large's rows cut to a CPU-sized run (K4 -> K5 routing needs
    neither here: the plain versions run whatever the route)."""
    monkeypatch.setattr(bench_large, "KH", 64)
    monkeypatch.setattr(bench_large, "KW", 160)
    monkeypatch.setattr(bench_large, "REPEATS", 1)
    monkeypatch.setattr(bench_large, "ROWS", ((32, 2, "float32"),
                                              (48, 1, "float32"),
                                              (48, 1, "bfloat16")))


def run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


# --------------------------------------------------------------------- pairs


def test_make_pairs_bitwise_reference():
    for got, want in zip(bench.make_pairs(2), jbench.make_pairs(2)):
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, bench_large.PARITY_SEED])
def test_kitti_pair_bitwise_reference(seed):
    """tools/bench_large.py:60-64 (seeds 0 .. batch - 1) and :84-87 (seed
    7) at 1242x375, D=128."""
    rng = np.random.default_rng(seed)
    field = jsynthetic.block_disparity_field(375, 1242, 128, rng, block=48)
    want = jsynthetic.make_pair(375, 1242, field, seed=seed)
    got = bench_large.kitti_pair(seed, 128)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_constants_match_reference():
    assert (bench.H, bench.W, bench.MAX_D, bench.BATCH) == (
        jbench.H, jbench.W, jbench.MAX_D, jbench.BATCH)
    assert bench.PARITY_PAIRS == jbench.PARITY_PAIRS
    assert bench.FUSED_DECISION_TOL == jbench.FUSED_DECISION_TOL
    assert (bench_large.KH, bench_large.KW) == (375, 1242)
    assert bench_large.ROWS == ((128, 8, "float32"), (256, 4, "float32"),
                                (256, 4, "bfloat16"))


# --------------------------------------------------------------- parity gate


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_parity_gate_passes(small_parity, route):
    pairs, want = small_parity
    row, fails = bench.parity_gate(pairs, want, CPU, max_d=SMALL_D, levels=2,
                                   routes=(route,))
    assert fails == []
    assert len(row[route]) == 2
    for rec in row[route]:
        assert rec["raw_neq"] <= FUSED_DECISION_TOL
        if route == "exact":
            assert rec["raw_neq"] == rec["val_neq"] == rec["right_neq"] == 0
            assert rec["disparity_equal"] and rec["score_close"]


def _tampered(monkeypatch, route, change):
    real = bench.match_pair

    def match_pair(left, right, cfg, device, r):
        out = real(left, right, cfg, device, r)
        if r == route:
            change(out)
        return out

    monkeypatch.setattr(bench, "match_pair", match_pair)


def test_parity_gate_names_disparity_right(small_parity, monkeypatch):
    pairs, want = small_parity

    def change(out):
        out["disparity_right"][5, 7] += 1

    _tampered(monkeypatch, "exact", change)
    _, fails = bench.parity_gate(pairs, want, CPU, max_d=SMALL_D, levels=2,
                                 routes=("exact",))
    assert len(fails) == 2                       # one per pair
    assert all("parity exact pair" in f and "right_neq" in f for f in fails)
    assert not any("raw_neq" in f for f in fails)


def test_parity_gate_names_fused_flips(small_parity, monkeypatch):
    pairs, want = small_parity
    h, w = SMALL_HW
    n = int(np.ceil(0.006 * h * w))

    def change(out):
        raw = out["disparity_raw"]               # 0.6% of decisions flipped
        raw[np.unravel_index(np.arange(n), raw.shape)] += 1

    _tampered(monkeypatch, "fused", change)
    _, fails = bench.parity_gate(pairs, want, CPU, max_d=SMALL_D, levels=2,
                                 routes=("fused",))
    assert len(fails) == 2
    assert all("parity fused pair" in f and "raw_neq" in f
               and f"beyond {FUSED_DECISION_TOL}" in f for f in fails)


def test_parity_check_exact_score_and_nan(small_parity):
    """'exact' holds scores at rtol 1e-5 and disparity NaN-equal."""
    pairs, want = small_parity
    left, right, gt = pairs[0]
    cfg = bench.bench_config(SMALL_D, levels=2)
    got = bench.match_pair(left, right, cfg, CPU, "exact")
    assert bench.parity_check("exact", got, want[0], gt)[1] == []
    near = dict(got, score=got["score"] * np.float32(1 + 5e-6))
    assert bench.parity_check("exact", near, want[0], gt)[1] == []
    far = dict(got, score=got["score"] * np.float32(1 + 1e-4))
    assert bench.parity_check("exact", far, want[0], gt)[1] == [
        "score beyond rtol 1e-5"]
    disp = got["disparity"].copy()
    disp[np.isnan(disp)] = 0.0
    assert np.isnan(got["disparity"]).any()
    assert bench.parity_check("exact", dict(got, disparity=disp), want[0],
                              gt)[1] == ["disparity differs"]


# ----------------------------------------------------------- adversarial row


def _scene_quality(outs, scenes):
    """bench.py:478-483 over several scenes: (occ_rejection, kept bad)."""
    occ_tot = rej = kept = bad = 0
    for out, (_, _, gt, occ) in zip(outs, scenes):
        valid = np.asarray(out["valid"])
        disp = np.asarray(out["disparity"])
        occ_tot += occ.sum()
        rej += (~valid[occ]).sum()
        keep = valid & ~occ & (gt >= 0)
        kept += keep.sum()
        bad += (np.abs(disp[keep] - gt[keep]) > 1).sum()
    return rej / max(occ_tot, 1), bad / max(kept, 1)


def test_adversarial_row_against_jax():
    h, w, d, seeds = 80, 120, 16, (0, 1)
    row, fails = bench.adversarial_row(CPU, height=h, width=w, max_d=d,
                                       seeds=seeds)
    jcfg = JConfig(max_disparity=d)
    geom = jcfg.geometry(h, w)
    scenes = [jsynthetic.adversarial_pair(h, w, d, seed=s) for s in seeds]
    jouts = []
    for left, right, _, _ in scenes:
        lp, rp = (jnp.asarray(joracle.pad_image(joracle.to_grayscale_f32(x),
                                                geom)) for x in (left, right))
        jouts.append(jpipeline.match_padded(lp, rp, jcfg, h, w, "jnp"))
        want = joracle.match_stereo(left, right, jcfg)
        raw_neq = np.mean(np.asarray(jouts[-1]["disparity_raw"])
                          != want.disparity_raw)
        assert raw_neq <= bench.ADV_MAX_NEQ
    rejection, kept_bad = _scene_quality(jouts, scenes)
    assert abs(row["occ_rejection"] - rejection) <= 0.005
    assert abs(row["kept_nonocc_bad"] - kept_bad) <= 0.005
    for s in seeds:
        assert row["seeds"][s]["raw_neq"] <= bench.ADV_MAX_NEQ
        assert row["seeds"][s]["val_neq"] <= bench.ADV_MAX_NEQ
    assert fails == [], fails


def test_adversarial_row_gates(monkeypatch):
    monkeypatch.setattr(bench, "ADV_MIN_REJECTION", 1.01)
    monkeypatch.setattr(bench, "ADV_MAX_KEPT_BAD", -0.01)
    _, fails = bench.adversarial_row(CPU, height=80, width=120, max_d=16,
                                     seeds=(0,))
    assert len(fails) == 2
    assert "occ_rejection" in fails[0] and "kept-nonocc-bad" in fails[1]


# -------------------------------------------------------------------- timing


def test_step_mpxs_row():
    pairs = bench.make_pairs(2, 64, 96, 16)
    row, fails = bench.step_mpxs(pairs, CPU, max_d=16, batch=2, repeats=3)
    assert fails == []
    t = row["timing"]
    assert 0 < t["min"] <= t["median"] <= t["max"]
    assert len(t["samples"]) == t["repeats"] == 3
    lo, hi = row["range_mpx_per_s"]
    assert 0 < lo <= row["mpx_per_s"] <= hi
    assert len(row["kept_bad_rates"]) == 2
    assert (row["route"], row["batch"], row["height"], row["width"]) == (
        "fused", 2, 64, 96)


def test_timed_samples_cover_min_sample():
    stats = bench.timed(lambda: time.sleep(0.002), (), CPU, repeats=2)
    assert stats["reps"] >= 2
    assert all(s * stats["reps"] >= 0.9 * bench.MIN_SAMPLE_S
               for s in stats["samples"])


def test_bf16_and_grad_hist_rows():
    pairs = bench.make_pairs(2, 64, 96, 16)
    cfg = bench.bench_config(16)
    want = [oracle.match_stereo(l, r, cfg) for l, r, _ in pairs[:1]]
    row, fails = bench.bf16_mpxs(pairs, want, CPU, max_d=16, batch=2,
                                 repeats=1)
    assert fails == [] and row["dtype"] == "bfloat16"
    assert 0.97 <= row["f32_agreement"] <= 1.0
    assert len(row["kept_bad_minus_oracle"]) == 1
    assert abs(row["kept_bad_minus_oracle"][0]) <= 0.05
    row, fails = bench.grad_hist_mpxs(pairs, CPU, max_d=16, batch=2,
                                      repeats=1)
    assert fails == [] and row["descriptor"] == "grad_hist"
    assert len(row["kept_bad_rates"]) == 2


def test_oracle_mpxs_labels_hosts():
    pairs = bench.make_pairs(1, 64, 96, 16)
    row, fails = bench.oracle_mpxs(pairs, max_d=16)
    assert fails == [] and row["mpx_per_s"] > 0
    assert row["cached_mpx_per_s"] is None       # another geometry
    assert bench._cached_oracle(375, 450, 64) == json.load(open(
        os.path.join(REPO, "ORACLE_BASELINE.json")))["mpx_per_s"]
    assert "numpy" in row["host"]


def test_native_io_row():
    row, fails = bench.native_io_row(bench.make_pairs(2, 64, 96, 16),
                                     max_d=16)
    assert fails == []
    if row["available"]:
        assert row["pairs"] == 2 and row["python_ms"] > 0
        assert row["native_ms"] > 0


# ---------------------------------------------------------------------- main


def test_bench_main_cpu(small_bench, tmp_path, monkeypatch):
    before = file_hashes()
    monkeypatch.chdir(tmp_path)
    rc, out = run_main(bench.main, ["--cpu"])
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "range",
                         "device"}
    assert line["metric"] == "full_pipeline_throughput_per_chip"
    assert line["unit"] == "Mpx/s" and line["device"] == "cpu"
    lo, hi = line["range"]
    assert 0 < lo <= line["value"] <= hi and line["vs_baseline"] > 0
    assert os.listdir(tmp_path) == []
    assert file_hashes() == before
    assert not dist.is_initialized()


def test_bench_main_gate_failure(small_bench, monkeypatch):
    monkeypatch.setattr(bench, "FUSED_DECISION_TOL", -1.0)
    rc, out = run_main(bench.main, ["--cpu"])
    assert rc == 1 and out == ""


@pytest.mark.parametrize("module", ["bench", "tools.bench_large"])
def test_no_card_exits_2(module):
    """Without a card and without --cpu, in-process and as `python -m`."""
    tool = bench if module == "bench" else bench_large
    assert not torch.cuda.is_available()
    assert run_main(tool.main, []) == (2, "")
    proc = subprocess.run(
        [sys.executable, "-m", f"deepmatching_stereo_matching_tpu_torch."
         f"{module}"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "--cpu" in proc.stderr


def test_bench_large_main_cpu(small_large, tmp_path, monkeypatch):
    before = file_hashes()
    monkeypatch.chdir(tmp_path)
    rc, out = run_main(bench_large.main, ["--cpu"])
    assert rc == 0 and os.listdir(tmp_path) == []
    rows = json.loads(out)["rows"]
    assert len(rows) == 3
    keys = reference_row_keys()
    assert len(keys) == 15
    for row, (d, b, dt) in zip(rows, bench_large.ROWS):
        assert set(row) == keys
        assert (row["max_disparity"], row["batch"], row["dtype"]) == (d, b, dt)
        assert row["impl"] in ("fused", "exact")
        t = row["timing"]
        assert 0 < t["min"] <= t["median"] <= t["max"]
        if dt == "float32":
            assert row["parity_raw_neq"] <= bench_large.F32_DECISION_TOL
    out_path = tmp_path / "rows.json"
    rc, out2 = run_main(bench_large.main, ["--cpu", "--out", str(out_path)])
    assert rc == 0 and os.listdir(tmp_path) == ["rows.json"]
    assert json.loads(out_path.read_text()) == json.loads(out2)
    assert file_hashes() == before


def test_bench_large_gate_failure(small_large, monkeypatch):
    monkeypatch.setattr(bench_large, "F32_DECISION_TOL", -1.0)
    assert run_main(bench_large.main, ["--cpu"]) == (1, "")


def test_bench_large_route_rule():
    """'fused' where K1 or K4 covers the config, as tools/bench_large.py
    decides with fused_pallas.supported / cost_supported."""
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda

    for d in (128, 256):
        for dt in ("float32", "bfloat16"):
            cfg = Config(max_disparity=d, dtype=dt)
            geom = cfg.geometry(375, 1242)
            assert not fused_cuda.supported(cfg, geom)
            assert fused_cuda.cost_supported(cfg, geom)
            assert bench_large.route_for(cfg, 375, 1242) == "fused"


# ------------------------------------------------------------- sharded smoke


def test_sharded_smoke_one_gloo_rank():
    row, fails = bench.sharded_smoke(CPU, height=64, width=96, max_d=16,
                                     batch=2, repeats=1)
    assert fails == []
    assert set(row["cases"]) == {"tiled", "wtiled", "dslab", "ringd"}
    assert all(c["differ"] == [] for c in row["cases"].values())
    assert {s: c["reference"] for s, c in row["cases"].items()} == {
        "tiled": "fused", "wtiled": "exact", "dslab": "torch",
        "ringd": "torch"}
    for rec in row["timed"].values():
        assert 0 < rec["min_ms"] <= rec["median_ms"] <= rec["max_ms"]
    assert not dist.is_initialized()
