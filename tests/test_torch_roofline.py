"""The port's work model (`work.py`) and roofline tool (`tools/roofline.py`),
on the CPU.

  * the model against tensors: every kernel's bytes equal the bytes of
    its plain version's inputs and outputs at two small shapes, one in
    bfloat16, and the step's equal `match_padded_core`'s;
  * the same work whatever implements it: K1's correlation is K4's and
    K2's at C = p^2, its aggregation and walk K3's; K1b's correlation is
    p^2 multiply-adds and p^2 bin compares a bin (the one-hot histogram's
    dot, which K2 computes at C = 8 p^2), its aggregation and walk K3's;
    K5's K3's without the walk;
  * the bounds chip_smoke.py printed before the model (its own byte and
    operation counts) within 1%;
  * against the JAX model (tools/roofline.py, loaded by path, read only):
    `imgs` and `out` of `fused_model` and `twokernel_model`, and the
    latter's `vol_w` and `vol_r`, at the bench geometry;
  * the tool: --cpu at a small geometry writes --out with ROOFLINE.json's
    row names and null shares and nothing else; every timed row and the
    calibration go through `run`'s hook; exit 2 without a card; exit 1 on
    a ceiling file from another card and on a share above 1.05;
  * one definition: no module of the port but work.py defines a peak or a
    work count, and work.py and tools/vpu_probe.py load neither the
    pipeline nor the roofline tool.
"""

import ast
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from deepmatching_stereo_matching_tpu import Config as JConfig
from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.models import descriptors, pipeline
from deepmatching_stereo_matching_tpu_torch.ops import (costvol_cuda,
                                                        fused_cuda,
                                                        probe_cuda,
                                                        pyramid_cuda)
from deepmatching_stereo_matching_tpu_torch.tools import roofline, vpu_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, Config, (height, width), instances): the second in bfloat16 with
# max_disparity below D0.
CASES = [("f32", Config(max_disparity=16), (32, 64), 2),
         ("bf16", Config(max_disparity=13, dtype="bfloat16"), (40, 96), 3)]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def planes(geom, n, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (n, geom.padded_height, geom.padded_width)
    return torch.rand(shape, generator=g), torch.rand(shape, generator=g)


def load_jax_tool(name):
    """The JAX package's tools/<name>.py, loaded by path (read only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("kernel", ["K1", "K1b", "K2", "K3", "K4", "K5", "K6"])
def test_model_bytes_equal_plain_tensors(kernel, case):
    """Each input read once and each output written once: the model's
    bytes equal those of the plain version's tensors (the wrappers run it
    on CPU tensors)."""
    _, cfg, (h, w), n = case
    geom = cfg.geometry(h, w)
    dtype = cfg.dtype
    lefts, rights = planes(geom, n, 0)
    if kernel == "K1":
        d, s = fused_cuda.match_planes(lefts, rights, cfg, geom)
        assert (d.dtype, s.dtype) == (torch.int32, torch.float32)
        want, model = nbytes(lefts, rights, d, s), work.k1(cfg, geom, n)
    elif kernel == "K1b":
        gh = dataclasses.replace(cfg, descriptor="grad_hist")
        (lm, lb), (rm, rb) = map(descriptors.grad_hist_magbin,
                                 (lefts, rights))
        d, s = fused_cuda.match_planes(lm, rm, gh, geom, lb, rb)
        want = nbytes(lm, rm, lb, rb, d, s)
        model = work.k1b(gh, geom, n)
        assert model.bytes == work.k1(gh, geom, n).bytes
    elif kernel in ("K2", "K6"):
        dtype = "float32" if kernel == "K6" else cfg.dtype
        ds = descriptors.left_descriptors(lefts, cfg)
        dt = descriptors.right_sliding_descriptors(rights, cfg)
        ds, dt = (x.to(getattr(torch, dtype)) for x in (ds, dt))
        args = (geom.disparities, cfg.patch_size, cfg.max_disparity)
        if kernel == "K2":
            vol = costvol_cuda.cost_volume_dmajor(ds, dt, *args)
            model = work.k2(cfg, geom, n)
        else:
            vol = costvol_cuda.cost_volume_rows(ds, dt, *args)
            model = work.k6(cfg, geom, n)
        assert vol.dtype == getattr(torch, dtype)
        want = nbytes(ds, dt, vol)
    else:
        vol = fused_cuda.cost_volume_rows(lefts, rights, cfg, geom)
        assert vol.dtype == getattr(torch, dtype)
        if kernel == "K4":
            want, model = nbytes(lefts, rights, vol), work.k4(cfg, geom, n)
        elif kernel == "K3":
            d, s = pyramid_cuda.pyramid_backtrack(vol, geom.levels, cfg.lam)
            want, model = nbytes(vol, d, s), work.k3(cfg, geom, n, dtype)
        else:
            top, args = pyramid_cuda.aggregate_dmajor(vol, geom.levels,
                                                      cfg.lam, True)
            assert top.dtype == vol.dtype
            want = nbytes(vol, top, *args)
            model = work.k5(cfg, geom, n, dtype)
    assert model.total_bytes == want


@pytest.mark.parametrize("name", ["stream", "small", "shift"])
def test_probe_model_bytes_equal_plain_tensors(name):
    """P1-P3: the input rows the probe reads (P2 rows [:96]) and its
    output."""
    a = probe_cuda.make_input(name)
    out = probe_cuda.KERNELS[name](a, 1, 1)
    rows = out.shape[0]
    model = work.probe(name)
    assert model.total_bytes == nbytes(a[:, :rows], out)
    assert model.peak == work.PEAK_NO_FMA


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_model_bytes_equal_match_padded_core(case):
    """The bench step's function: two padded planes a pair in, the five
    padded maps a pair out, at their dtypes."""
    _, cfg, (h, w), batch = case
    geom = cfg.geometry(h, w)
    lp, rp = planes(geom, batch, 1)
    out = pipeline.match_padded_core(lp, rp, cfg, geom, "fused")
    assert set(out) == set(work.STEP_OUTPUT_BYTES)
    for k, v in out.items():
        assert v.element_size() == work.STEP_OUTPUT_BYTES[k]
    model = work.step_fused(cfg, geom, batch)
    assert model.total_bytes == nbytes(lp, rp, *out.values())
    assert model.ops == work.k1(cfg, geom, 2 * batch).ops


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_same_work_whatever_implements_it(case):
    _, cfg, (h, w), n = case
    geom = cfg.geometry(h, w)
    p = cfg.patch_size
    k1, k2, k3 = (work.k1(cfg, geom, n), work.k2(cfg, geom, n),
                  work.k3(cfg, geom, n))
    k4, k5 = work.k4(cfg, geom, n), work.k5(cfg, geom, n)
    # C = p^2 for patch descriptors, 8 p^2 for grad_hist: the tensors' width.
    lefts, _ = planes(geom, 1, 2)
    gh = dataclasses.replace(cfg, descriptor="grad_hist")
    for c in (cfg, gh):
        assert work.descriptor_width(c) == \
            descriptors.left_descriptors(lefts, c).shape[-1]
    assert work.descriptor_width(cfg) == p * p
    bins = min(cfg.max_disparity, geom.disparities)
    corr = 2 * p * p * bins * geom.grid_h * geom.grid_w * n
    assert k1.ops["corr"] == k4.ops["corr"] == k2.ops["corr"] == corr
    assert k4.ops == k2.ops == work.k6(cfg, geom, n).ops
    assert {k: v for k, v in k1.ops.items() if k != "corr"} == k3.ops
    assert {k: v for k, v in k3.ops.items()
            if k not in ("argmax", "walk")} == k5.ops
    # K1b: the one-hot histogram's dot on (magnitude, bin) planes, p^2
    # multiply-adds and p^2 compares a bin; K2 computes it at C = 8 p^2.
    k1b = work.k1b(gh, geom, n)
    assert k1b.ops == work.k1(gh, geom, n).ops
    assert k1b.ops["corr"] == corr and 2 * k1b.ops["bin_eq"] == corr
    assert work.k2(gh, geom, n).ops["corr"] == 8 * corr
    assert {k: v for k, v in k1b.ops.items()
            if k not in ("corr", "bin_eq")} == k3.ops

    path = work.path_exact(cfg, geom, n)
    assert path.ops == {**work.k2(cfg, geom, 2 * n).ops,
                        **work.k3(cfg, geom, 2 * n).ops}
    assert path.bytes["vol_w"] == path.bytes["vol_r"] == \
        work.k2(cfg, geom, 2 * n).bytes["vol"]


def test_magbin_dot_is_the_histogram_dot():
    """What K1b's count rests on: a pixel's histogram has one nonzero bin,
    so the 8-bin dot of two pixels is mag_L mag_R [bin_L == bin_R]."""
    g = torch.Generator().manual_seed(3)
    left, right = torch.rand((2, 20, 24), generator=g)
    hl, hr = (descriptors.grad_hist_pixels(x) for x in (left, right))
    (ml, bl), (mr, br) = (descriptors.grad_hist_magbin(x)
                          for x in (left, right))
    assert int((hl != 0).sum(-1).max()) <= 1
    torch.testing.assert_close((hl * hr).sum(-1),
                               ml * mr * (bl == br).to(ml.dtype),
                               rtol=0, atol=0)


def test_chip_smoke_bounds_within_one_percent():
    """Every kernel row of chip_smoke.py: the model's bound against the one
    chip_smoke computed before the model (its byte count, the same as the
    model's, and its operations: 2 C a bin with C = p^2 for K1 and K1b,
    7 a cell of each level above 0 for K3 and K5)."""
    bench = Config(max_disparity=64)
    geom = bench.geometry(375, 450)
    gh = dataclasses.replace(bench, descriptor="grad_hist")
    kitti = {d: Config(max_disparity=d) for d in (64, 128, 256)}
    kg = {d: c.geometry(375, 1242) for d, c in kitti.items()}

    def vol(g, n):
        return n * g.disparities * g.grid_h * g.grid_w

    def corr(g, n, c):
        return 2 * c * vol(g, n)

    def pyr(g, n):
        return sum(7 * vol(g, n) // 8 ** lvl for lvl in range(1, g.levels + 1))

    bf = "bfloat16"
    rows = {  # row: (model's work, chip_smoke's operations before it)
        "K1": (work.k1(bench, geom, 64), corr(geom, 64, 16)),
        "K1 KITTI": (work.k1(kitti[64], kg[64], 2), corr(kg[64], 2, 16)),
        "K1b": (work.k1b(gh, geom, 64), corr(geom, 64, 16)),
        "K2": (work.k2(bench, geom, 64), corr(geom, 64, 16)),
        "K2 bf16": (work.k2(bench, geom, 64, bf), corr(geom, 64, 16)),
        "K2 C=128": (work.k2(gh, geom, 64), corr(geom, 64, 128)),
        "K2 KITTI": (work.k2(kitti[256], kg[256], 8),
                     corr(kg[256], 8, 16)),
        "K3": (work.k3(bench, geom, 64), pyr(geom, 64)),
        "K3 bf16": (work.k3(bench, geom, 64, bf), pyr(geom, 64)),
        "K4": (work.k4(kitti[128], kg[128], 16), corr(kg[128], 16, 16)),
        "K5": (work.k5(kitti[128], kg[128], 16), pyr(kg[128], 16)),
        "K5 bf16": (work.k5(kitti[128], kg[128], 16, bf),
                    pyr(kg[128], 16)),
        "K6": (work.k6(kitti[256], kg[256], 8), corr(kg[256], 8, 16)),
        "P1": (work.probe("stream"), 64 * 64 * 8 * 384 * 128),
    }
    for key, (model, ops_before) in rows.items():
        before = max(model.total_bytes / 3.35e12,
                     ops_before / (33.5e12 if key == "P1" else 67e12))
        after, _ = work.bound(model)
        assert after == pytest.approx(before, rel=0.01), key
    # K1 and K1b stay bytes-bound at 0.0319 and 0.0620 ms (PERF.md's table).
    assert work.bound(rows["K1"][0]) == (pytest.approx(3.19e-5, rel=2e-3),
                                         "bytes")
    assert work.bound(rows["K1b"][0]) == (pytest.approx(6.20e-5, rel=2e-3),
                                          "bytes")


def test_against_jax_model():
    """tools/roofline.py's HBM terms at the bench geometry, one direction:
    `imgs` and `out` of its fused and two-kernel models, `vol_w` and
    `vol_r` of the latter.  Its VPU correlation counts 2 C - 1 a bin where
    the port counts 2 C."""
    jtool = load_jax_tool("roofline")
    jcfg = JConfig(max_disparity=jtool.MAX_D)
    jgeom = jcfg.geometry(jtool.H, jtool.W)
    cfg = Config(max_disparity=roofline.MAX_D)
    geom = cfg.geometry(roofline.H, roofline.W)
    assert (jtool.H, jtool.W, jtool.MAX_D, jtool.BATCH) == (
        roofline.H, roofline.W, roofline.MAX_D, roofline.BATCH)
    _, _, fused_hbm = jtool.fused_model(jgeom, jcfg)
    k1 = work.k1(cfg, geom, 1)
    assert {k: fused_hbm[k] for k in ("imgs", "out")} == k1.bytes
    _, vpu, two_hbm = jtool.twokernel_model(jgeom, jcfg)
    path = work.path_exact(cfg, geom, 1)       # both directions of a pair
    for k in ("imgs", "out", "vol_w", "vol_r"):
        assert 2 * two_hbm[k] == path.bytes[k], k
    assert path.ops["corr"] - 2 * vpu["corr"] == \
        2 * cfg.max_disparity * geom.grid_h * geom.grid_w


def file_hash(name):
    with open(os.path.join(REPO, name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture
def small_tool(monkeypatch):
    for name, value in (("H", 32), ("W", 64), ("MAX_D", 16), ("BATCH", 1),
                        ("REPEATS", 1)):
        monkeypatch.setattr(roofline, name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_tool_on_the_cpu(small_tool, tmp_path, monkeypatch, capsys):
    """--cpu at a small geometry: ROOFLINE.json's rows, null shares, a
    calibration from a ceiling file written on the CPU, and no file but
    --out."""
    ceiling = tmp_path / "ceiling.jsonl"
    ceiling.write_text(json.dumps({"probe": "stream", "card": "cpu",
                                   "achieved_flop_per_s": 1e9}) + "\n")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = file_hash("ROOFLINE.json")
    out = tmp_path / "roofline.json"
    assert roofline.main(["--cpu", "--out", str(out),
                          "--ceiling", str(ceiling)]) == 0
    assert os.listdir(cwd) == [] and file_hash("ROOFLINE.json") == before
    with open(os.path.join(REPO, "ROOFLINE.json")) as f:
        reference = json.load(f)
    written = json.loads(out.read_text())
    assert list(written["rows"]) == list(reference["rows"])
    assert written["chip"] == "cpu" and written["geometry"]["padded"] == [32,
                                                                          64]
    for name, row in written["rows"].items():
        assert row["seconds"] >= 0
        if "sol_seconds" in row:
            assert row["sol_fraction"] is None and row["sol_seconds"] > 0
            assert row["bounding_resource"] in ("bytes", "operations")
            assert "per_direction_model" in row
    cal = written["rows"]["fused_kernel"]["calibrated"]
    assert cal["sol_fraction"] is None and cal["p1_flop_per_s"] == 1e9
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    headline = json.loads(lines[0])
    assert headline == {**written["headline"], "chip": "cpu"}
    assert headline["fused_sol_fraction"] is None
    assert headline["full_step_sol_fraction"] is None


def test_tool_refusals(small_tool, tmp_path, monkeypatch, capsys):
    """Exit 1 on a ceiling file written on another card, before any row
    runs, and on a share above 1.05, with no stdout line."""
    other = tmp_path / "other.jsonl"
    other.write_text(json.dumps({"probe": "stream", "card": CARD,
                                 "achieved_flop_per_s": 2e13}) + "\n")
    monkeypatch.setattr(roofline, "run", None)      # no row may run
    assert roofline.main(["--cpu", "--ceiling", str(other)]) == 1
    assert "not on this card" in capsys.readouterr().err

    def over(device, card, **kw):
        return {"rows": {"fused_kernel": {"sol_fraction": 1.2}},
                "headline": {}}

    monkeypatch.setattr(roofline, "run", over)
    assert roofline.main(["--cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "fused_kernel" in captured.err


def test_tool_no_card_exits_2():
    """Without a card and without --cpu, in-process and as `python -m`."""
    assert not torch.cuda.is_available()
    assert roofline.main([]) == 2
    proc = subprocess.run(
        [sys.executable, "-m",
         "deepmatching_stereo_matching_tpu_torch.tools.roofline"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "--cpu" in proc.stderr


def test_one_definition_of_peaks_and_work():
    """chip_smoke.py, tools/vpu_probe.py and tools/roofline.py take the
    peaks and every work count from work.py; none defines its own, and no
    other module of the port writes the peaks' numbers."""
    sys.path.insert(0, REPO)
    import chip_smoke

    for name in ("HBM_BYTES_PER_S", "PEAK_F32", "cost_flops", "pyramid_flops",
                 "bound"):
        assert not hasattr(chip_smoke, name), name
    assert vpu_probe.PEAK_F32 is work.PEAK_F32
    assert vpu_probe.PEAK_NO_FMA is work.PEAK_NO_FMA
    assert roofline.MERGED_WORK is work.MERGED_WORK
    assert not hasattr(probe_cuda, "flops") and not hasattr(probe_cuda,
                                                            "bytes_read")
    port = os.path.join(REPO, "deepmatching_stereo_matching_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, n) for root, _, names in os.walk(port)
        for n in names if n.endswith(".py")]
    found = []
    for path in files:
        if path == work.__file__:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and node.value in (67e12,
                                                                 3.35e12,
                                                                 33.5e12):
                found.append((path, node.lineno))
            if isinstance(node, (ast.Assign, ast.FunctionDef)):
                names = ([t.id for t in node.targets if isinstance(t, ast.Name)]
                         if isinstance(node, ast.Assign) else [node.name])
                found += [(path, n) for n in names if n in (
                    "HBM_BYTES_PER_S", "PEAK_F32", "PEAK_NO_FMA", "cost_flops",
                    "pyramid_flops")]
    assert not found, found


def test_model_and_probe_load_no_pipeline():
    """work.py and tools/vpu_probe.py import neither the pipeline, the
    oracle nor the roofline tool."""
    code = ("import sys\n"
            "import deepmatching_stereo_matching_tpu_torch.work\n"
            "import deepmatching_stereo_matching_tpu_torch.tools.vpu_probe\n"
            "pkg = 'deepmatching_stereo_matching_tpu_torch.'\n"
            "print(sorted(m for m in sys.modules if m.startswith(pkg) and "
            "m.split('.')[1] in ('bench', 'models', 'oracle', 'tools')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.replace("'", '"')) == [
        "deepmatching_stereo_matching_tpu_torch.tools",
        "deepmatching_stereo_matching_tpu_torch.tools.vpu_probe"]


def test_run_hook_wraps_every_timed_row(small_tool):
    """`run` calls each timed row and the calibration through `wrap`, in
    order, and takes their results (chip_smoke's phase 8 counts launches
    there)."""
    seen = []

    def wrap(name, fn):
        seen.append(name)
        return fn()

    out = roofline.run(torch.device("cpu"), "cpu", **roofline.bench_size(),
                       probe_row={"achieved_flop_per_s": 1e9}, wrap=wrap)
    assert seen == ["full_step_fused", "fused_kernel", "descriptors_xla",
                    "costvol_kernel", "pyramid_kernel", "calibrated"]
    assert list(out["rows"]) == seen[:-1] + ["twokernel_path_sum",
                                             "lr_densify_tail"]
    assert out["geometry"]["padded"] == [32, 64]
    assert not roofline.shares_over(out)
