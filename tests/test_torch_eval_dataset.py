"""The port's dataset evaluation tool against the JAX package's, on the CPU.

  * `discover`: equal to the JAX tool's, tuple for tuple, on every layout
    (flat, Middlebury im2/im6 and im0/im1, KITTI with each ground-truth
    folder, a left image without its right one, an empty directory);
  * `_read_gt`: bitwise the JAX tool's (PFM with inf, 16-bit PNG with
    zeros, PGM with zeros at scale 0.25), NaN at the same places;
  * end to end, `main([...])` on the 'torch', 'exact' and 'fused' routes
    (the last two on their plain versions) on the flat, Middlebury and
    KITTI layouts: the report's keys are the JAX tool's plus `device`,
    decisions equal the oracle's on 'torch' and 'exact' and within 0.5%
    on 'fused', and the quality numbers equal the JAX tool's
    (`--impl jnp --cpu`) within 1e-4 wherever both agree with the oracle;
  * exit codes and flags: no pair, no card without `--cpu`, `--max-pairs`,
    `--save-disparity`, and the module run as `python -m`.

Pairs: 64x96, D=16, `make_block_pair(seed=3)` written as 8-bit images.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import eval_dataset as jtool  # noqa: E402

from deepmatching_stereo_matching_tpu_torch import api  # noqa: E402
from deepmatching_stereo_matching_tpu_torch.config import Config  # noqa: E402
from deepmatching_stereo_matching_tpu_torch.data.synthetic import (  # noqa: E402
    make_block_pair)
from deepmatching_stereo_matching_tpu_torch.io import images, writers  # noqa: E402
from deepmatching_stereo_matching_tpu_torch.tools import (  # noqa: E402
    eval_dataset as tool)

H, W, D = 64, 96, 16
ROUTES = ["torch", "exact", "fused"]
LAYOUTS = ["flat", "mb", "kitti"]
FUSED_DECISION_TOL = 0.005
QUALITY = ("coverage", "bad_pixel_rate_kept", "bad_pixel_rate_all",
           "epe_kept")


def u8(a):
    return np.clip(a * 255.0, 0, 255).astype(np.uint8)


def write_pgm(path, arr):
    with open(path, "wb") as f:
        f.write(f"P5\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
        f.write(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())


def write_layout(tmp, layout, seed=3, names=("000000",)):
    """One pair per name in `layout`, with its ground truth."""
    for i, name in enumerate(names):
        left, right, gt = make_block_pair(H, W, max_disparity=D,
                                          seed=seed + i)
        gtf = gt.astype(np.float32)
        if layout == "flat":
            writers._to_png(str(tmp / f"{name}_left.png"), u8(left))
            writers._to_png(str(tmp / f"{name}_right.png"), u8(right))
            writers.write_pfm(str(tmp / f"{name}_gt.pfm"), gtf)
        elif layout == "mb":
            d = tmp / f"scene{name}"
            d.mkdir()
            writers._to_png(str(d / "im2.png"), u8(left))
            writers._to_png(str(d / "im6.png"), u8(right))
            writers.write_pfm(str(d / "disp2.pfm"), gtf)
        else:
            for sub in ("image_2", "image_3", "disp_occ_0"):
                (tmp / sub).mkdir(exist_ok=True)
            writers._to_png(str(tmp / "image_2" / f"{name}_10.png"), u8(left))
            writers._to_png(str(tmp / "image_3" / f"{name}_10.png"),
                            u8(right))
            writers.write_disparity_png16(
                str(tmp / "disp_occ_0" / f"{name}_10.png"), gtf)


# ---------------------------------------------------------------------------
# discover
# ---------------------------------------------------------------------------


def _pair(d, left, right):
    d.mkdir(parents=True, exist_ok=True)
    img = u8(make_block_pair(16, 24, max_disparity=4, seed=3)[0])
    writers._to_png(str(d / left), img)
    writers._to_png(str(d / right), img)


def _touch(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")


def _flat_gt(tmp):
    _pair(tmp, "a_left.png", "a_right.png")
    _pair(tmp, "b_left.png", "b_right.png")
    _touch(tmp / "a_gt.pfm")
    _touch(tmp / "b_gt.png")


def _flat_no_gt(tmp):
    _pair(tmp, "a_left.png", "a_right.png")
    _pair(tmp, "c_left.png", "c_right.png")


def _mb_disp2_pfm(tmp):
    _pair(tmp / "cones", "im2.png", "im6.png")
    _touch(tmp / "cones" / "disp2.pfm")
    _pair(tmp / "teddy", "im2.png", "im6.png")


def _mb_disp2_pgm(tmp):
    _pair(tmp / "cones", "im2.png", "im6.png")
    _touch(tmp / "cones" / "disp2.pgm")


def _mb_disp0gt(tmp):
    _pair(tmp / "Adirondack", "im0.png", "im1.png")
    _touch(tmp / "Adirondack" / "disp0GT.pfm")
    _pair(tmp / "Motorcycle", "im0.png", "im1.png")
    _touch(tmp / "Motorcycle" / "disp0.pfm")


def _kitti(tmp, gt_dirs=("disp_occ_0",), missing_right=()):
    for name in ("000000_10.png", "000001_10.png"):
        _pair(tmp / "image_2", name, name)
        if name not in missing_right:
            _pair(tmp / "image_3", name, name)
        for sub in gt_dirs:
            _touch(tmp / sub / name)
    _touch(tmp / "image_2" / "000000_11.png")   # not a _10 frame


LAYOUT_MAKERS = {
    "flat_gt": _flat_gt,
    "flat_no_gt": _flat_no_gt,
    "mb_im2_disp2_pfm": _mb_disp2_pfm,
    "mb_im2_disp2_pgm": _mb_disp2_pgm,
    "mb_im0_disp0gt_pfm": _mb_disp0gt,
    "kitti_disp_occ_0": lambda t: _kitti(t, ("disp_occ_0", "disp_noc_0")),
    "kitti_disp_noc_0": lambda t: _kitti(t, ("disp_noc_0",)),
    "kitti_missing_right": lambda t: _kitti(
        t, missing_right=("000001_10.png",)),
    "empty": lambda t: None,
}


@pytest.mark.parametrize("layout", list(LAYOUT_MAKERS))
def test_discover_matches_jax_tool(tmp_path, layout):
    LAYOUT_MAKERS[layout](tmp_path)
    got = tool.discover(str(tmp_path), 0.25)
    want = jtool.discover(str(tmp_path), 0.25)
    assert got == want
    assert (len(got) == 0) == (layout == "empty")
    if layout == "kitti_missing_right":
        assert [g[0] for g in got] == ["000000_10"]


# ---------------------------------------------------------------------------
# _read_gt
# ---------------------------------------------------------------------------


def _gt_pfm_inf(tmp):
    gt = np.random.default_rng(0).uniform(0, 60, (H, W)).astype(np.float32)
    gt[::7, ::5] = np.inf
    path = str(tmp / "disp0GT.pfm")
    writers.write_pfm(path, gt)
    return path


def _gt_png16_zeros(tmp):
    gt = np.random.default_rng(1).uniform(0, 200, (H, W)).astype(np.float32)
    gt[::3, 1::4] = np.nan          # written as 0
    gt[5, :] = 0.0                  # a true zero is 0 too: invalid
    path = str(tmp / "000000_10.png")
    writers.write_disparity_png16(path, gt)
    return path


def _gt_pgm_zeros(tmp):
    gt = np.random.default_rng(2).integers(0, 256, (H, W)).astype(np.uint8)
    gt[::4, ::3] = 0
    path = str(tmp / "disp2.pgm")
    write_pgm(path, gt)
    return path


@pytest.mark.parametrize("maker", [_gt_pfm_inf, _gt_png16_zeros,
                                   _gt_pgm_zeros])
def test_read_gt_bitwise_jax_tool(tmp_path, maker):
    path = maker(tmp_path)
    scale = 0.25 if path.endswith(".pgm") else 1.0
    got = tool._read_gt(path, scale)
    want = jtool._read_gt(path, scale)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (H, W)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    assert got.tobytes() == want.tobytes()


def test_read_gt_refuses_other_formats(tmp_path):
    with pytest.raises(ValueError, match="unsupported GT format"):
        tool._read_gt(str(tmp_path / "gt.tif"), 1.0)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def run_port(capsys, *argv):
    assert tool.main([str(a) for a in argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Each layout written once, with the JAX tool's report on it."""
    out = {}
    for layout in LAYOUTS:
        root = tmp_path_factory.mktemp(layout)
        write_layout(root, layout)
        report = tmp_path_factory.mktemp(f"{layout}_jax") / "report.json"
        argv = ["eval_dataset.py", str(root), "-D", str(D), "--impl", "jnp",
                "--cpu", "--oracle-check", "1", "--out", str(report)]
        old = sys.argv
        sys.argv = argv
        try:
            jtool.main()
        finally:
            sys.argv = old
        with open(report) as f:
            out[layout] = (root, json.load(f))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("route", ROUTES)
def test_end_to_end_matches_jax_tool(datasets, tmp_path, capsys, route,
                                     layout):
    root, jax_report = datasets[layout]
    out = tmp_path / "report.json"
    summary = run_port(capsys, root, "-D", D, "--impl", route, "--cpu",
                       "--oracle-check", 1, "--out", out)
    with open(out) as f:
        report = json.load(f)
    assert set(report) == set(jax_report)
    assert set(report["config"]) == set(jax_report["config"]) | {"device"}
    assert report["config"] == {"max_disparity": D, "impl": route,
                                "gt_scale": 1.0, "device": "cpu"}
    assert "XLA" not in report["note"]
    assert summary == report["summary"]
    assert set(summary) == set(jax_report["summary"])
    assert summary["pairs"] == summary["with_gt"] == 1
    (row,), (jrow,) = report["pairs"], jax_report["pairs"]
    assert set(row) == set(jrow)
    assert row["pair"] == jrow["pair"] and row["shape"] == [H, W]
    assert row["seconds"] > 0 and row["mpx_per_s"] > 0
    assert row["coverage"] > 0.3
    decisions = row["oracle_decision_disagreement"]
    if route == "fused":
        assert decisions <= FUSED_DECISION_TOL
        assert row["oracle_valid_disagreement"] <= FUSED_DECISION_TOL
    else:
        assert decisions == 0.0
        assert row["oracle_valid_disagreement"] == 0.0
    if decisions == 0.0 and jrow["oracle_decision_disagreement"] == 0.0:
        for k in QUALITY:
            assert abs(row[k] - jrow[k]) <= 1e-4, (k, row[k], jrow[k])


def test_exit_2_without_pairs(tmp_path, capsys):
    assert tool.main([str(tmp_path), "--cpu"]) == 2
    assert "no stereo pairs found" in capsys.readouterr().err


def test_exit_2_without_a_card(tmp_path, monkeypatch, capsys):
    write_layout(tmp_path, "flat")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([str(tmp_path), "-D", str(D)]) == 2
    err = capsys.readouterr().err
    assert "--cpu" in err and "no CUDA device" in err


def test_max_pairs_and_save_disparity(tmp_path, capsys):
    root = tmp_path / "data"
    root.mkdir()
    write_layout(root, "kitti", names=("000000", "000001"))
    saved = tmp_path / "saved"
    summary = run_port(capsys, root, "-D", D, "--impl", "exact", "--cpu",
                       "--save-disparity", saved)
    assert summary["pairs"] == summary["with_gt"] == 2
    assert sorted(os.listdir(saved)) == ["000000_10.pfm", "000000_10.png",
                                         "000001_10.pfm", "000001_10.png"]
    for name in ("000000_10", "000001_10"):
        left, right = images.load_pair(str(root / "image_2" / f"{name}.png"),
                                       str(root / "image_3" / f"{name}.png"))
        want = api.match_stereo(left, right, Config(max_disparity=D),
                                impl="exact", device="cpu").disparity
        got = writers.read_pfm(str(saved / f"{name}.pfm"))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any()
        np.testing.assert_array_equal(got, want)
    summary = run_port(capsys, root, "-D", D, "--impl", "torch", "--cpu",
                       "--max-pairs", 1)
    assert summary["pairs"] == summary["with_gt"] == 1


def test_module_runs_as_python_m(tmp_path):
    write_layout(tmp_path, "mb")
    proc = subprocess.run(
        [sys.executable, "-m",
         "deepmatching_stereo_matching_tpu_torch.tools.eval_dataset",
         str(tmp_path), "-D", str(D), "--impl", "torch", "--cpu",
         "--oracle-check", "1"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert set(summary) == {"pairs", "with_gt", "mean_mpx_per_s",
                            "mean_coverage", "mean_bad_pixel_rate_kept",
                            "mean_epe_kept"}
    assert summary["pairs"] == summary["with_gt"] == 1
    row = json.loads(proc.stderr.strip().splitlines()[-1])
    assert row["oracle_decision_disagreement"] == 0.0
