"""The port's invariant checks, CLI and centred descriptors vs the JAX
package, on the CPU (the kernel routes run their plain versions here).

  * `utils/checks.py`: the cases of tests/test_checks.py on the 'torch',
    'fused' and 'exact' routes (JAX checks only its 'jnp' path);
  * `cli.py`: `--demo --cpu -o` and image files with `--gt` write the
    same files and metrics keys as the JAX CLI, with decisions agreeing
    above 0.999 with JAX's `--cpu` run; without a card and without
    `--cpu` it exits 2;
  * `center_descriptors`: descriptors within 1e-5 of JAX, and decisions
    on the 'exact' and 'fused' routes equal to the oracle's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepmatching_stereo_matching_tpu import Config as JConfig
from deepmatching_stereo_matching_tpu import api as japi
from deepmatching_stereo_matching_tpu import cli as jcli
from deepmatching_stereo_matching_tpu.models import descriptors as jdesc
from deepmatching_stereo_matching_tpu_torch import api, cli
from deepmatching_stereo_matching_tpu_torch.config import Config, carry_over
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.io import writers
from deepmatching_stereo_matching_tpu_torch.models import descriptors, pipeline
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch.utils import checks

ROUTES = ["torch", "fused", "exact"]
OUTPUT_FILES = ["disparity.pfm", "disparity_16bit.png", "disparity_color.png",
                "metrics.json", "valid.png"]


def test_validate_rejects_bad_inputs():
    good = np.zeros((16, 24), dtype=np.uint8)
    with pytest.raises(ValueError, match="shapes differ"):
        checks.validate_images(good, np.zeros((16, 25), dtype=np.uint8))
    with pytest.raises(ValueError, match="must be"):
        checks.validate_images(np.zeros((4,)), good)
    with pytest.raises(ValueError, match="channels"):
        checks.validate_images(np.zeros((8, 8, 2)), np.zeros((8, 8, 2)))
    with pytest.raises(ValueError, match="empty"):
        checks.validate_images(np.zeros((0, 8)), np.zeros((0, 8)))
    with pytest.raises(ValueError, match="NaN"):
        bad = np.full((8, 8), np.nan, dtype=np.float32)
        checks.validate_images(bad, bad)


@pytest.mark.parametrize("route", ROUTES)
def test_debug_checks_pass_on_valid_pair(route):
    left, right, _ = synthetic.make_block_pair(48, 64, max_disparity=8,
                                               seed=0)
    cfg = Config(max_disparity=8, levels=2, median_filter=3)
    res = api.match_stereo(left, right, cfg, impl=route, device="cpu",
                           debug_checks=True)
    base = api.match_stereo(left, right, cfg, impl=route, device="cpu")
    for name in ("disparity_raw", "valid", "score", "disparity_right"):
        np.testing.assert_array_equal(getattr(res, name), getattr(base, name))
    np.testing.assert_array_equal(res.disparity, base.disparity)
    want = japi.match_stereo(left, right, JConfig(max_disparity=8, levels=2,
                                                  median_filter=3),
                             debug_checks=True)
    np.testing.assert_array_equal(res.disparity_raw, want.disparity_raw)
    np.testing.assert_array_equal(res.valid, want.valid)


@pytest.mark.parametrize("route", ROUTES)
def test_checked_pipeline_catches_nonfinite_padded_input(route):
    cfg = Config(max_disparity=8, levels=2)
    geom = cfg.geometry(48, 64)
    lp = torch.zeros((geom.padded_height, geom.padded_width))
    rp = lp.clone()
    lp[3, 5] = float("inf")  # slipped past the host boundary somehow
    with pytest.raises(checks.InvariantError,
                       match="non-finite values in padded input images"):
        checks.checked_match_padded(lp, rp, cfg, 48, 64, route)


def test_invariant_error_names_every_failed_check(monkeypatch):
    """Every failed invariant is named, from one read-back."""
    real = pipeline.match_padded_core

    def broken(*args):
        out = dict(real(*args))
        out["score"] = out["score"].clone().fill_(float("nan"))
        out["disparity_raw"] = out["disparity_raw"] + 1000
        return out

    monkeypatch.setattr(pipeline, "match_padded_core", broken)
    cfg = Config(max_disparity=8, levels=2)
    geom = cfg.geometry(48, 64)
    lp = torch.rand((2, geom.padded_height, geom.padded_width))
    with pytest.raises(checks.InvariantError) as e:
        checks.checked_match_padded(lp, lp, cfg, 48, 64, "torch")
    msg = str(e.value)
    assert "non-finite correlation scores" in msg
    assert "disparity bin out of range [0, D)" in msg
    assert "padded input" not in msg and "NaN sentinel" not in msg


def run_port_cli(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_jax_cli(capsys, *argv):
    assert jcli.main(["--cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_same_outputs(port_dir, jax_dir, port_meta, jax_meta):
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) \
        == OUTPUT_FILES
    assert set(port_meta) == set(jax_meta)
    with open(os.path.join(port_dir, "metrics.json")) as f:
        assert set(json.load(f)) == set(port_meta) - {"output"}
    got = writers.read_pfm(os.path.join(port_dir, "disparity.pfm"))
    want = writers.read_pfm(os.path.join(jax_dir, "disparity.pfm"))
    assert got.shape == want.shape
    agree = np.mean((got == want) | (np.isinf(got) & np.isinf(want)))
    assert agree > 0.999, agree


def test_cli_demo_matches_jax_cli(tmp_path, capsys):
    args = ("--demo", "--demo-size", "80", "120", "-D", "16")
    port_meta = run_port_cli(capsys, *args, "--cpu", "-o",
                             str(tmp_path / "port"))
    jax_meta = run_jax_cli(capsys, *args, "--impl", "jnp", "-o",
                           str(tmp_path / "jax"))
    assert port_meta["impl"] == "fused" and port_meta["engine"] == "cpu"
    assert port_meta["coverage"] > 0.3
    assert port_meta["config"] == json.loads(json.dumps(jax_meta["config"]))
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", port_meta,
                        jax_meta)


def test_cli_image_files_with_gt_match_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(9)
    field = synthetic.block_disparity_field(60, 90, 16, rng, block=16)
    left, right, gt = synthetic.make_pair(60, 90, field, seed=9)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    writers._to_png(lp, (left * 255).astype(np.uint8))
    writers._to_png(rp, (right * 255).astype(np.uint8))
    gtp = str(tmp_path / "gt.png")
    gtf = gt.astype(np.float32)
    gtf[gt < 0] = np.nan
    writers.write_disparity_png16(gtp, gtf)
    args = (lp, rp, "-D", "16", "--gt", gtp)
    port_meta = run_port_cli(capsys, *args, "--cpu", "--impl", "exact",
                             "-o", str(tmp_path / "port"))
    jax_meta = run_jax_cli(capsys, *args, "--impl", "jnp", "-o",
                           str(tmp_path / "jax"))
    assert port_meta["bad_pixel_rate_kept"] < 0.35  # 8-bit quantised inputs
    for k in ("bad_pixel_rate_all", "bad_pixel_rate_kept", "epe_kept",
              "coverage"):
        assert port_meta[k] == jax_meta[k], k
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", port_meta,
                        jax_meta)


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--demo"]) == 2
    assert "--cpu" in capsys.readouterr().err


def test_cli_oracle_and_unsupported_dtype(tmp_path, capsys):
    """--oracle, and --dtype bfloat16, which runs on 'fused' (K1's plain
    version here) and on 'exact' (K2 bf16 -> K3 bf16, plain), writing its
    outputs and recording the dtype; a dtype the JAX package does not
    know is refused by the parser."""
    meta = run_port_cli(capsys, "--demo", "--demo-size", "48", "64", "-D",
                        "8", "--cpu", "--oracle")
    assert meta["engine"] == "oracle" and "impl" not in meta
    for impl in ("fused", "exact"):
        out = tmp_path / f"bf16_{impl}"
        meta = run_port_cli(capsys, "--demo", "--demo-size", "48", "64",
                            "-D", "8", "--cpu", "--dtype", "bfloat16",
                            "--impl", impl, "-o", str(out))
        assert meta["impl"] == impl
        assert meta["config"]["dtype"] == "bfloat16"
        assert sorted(os.listdir(out)) == OUTPUT_FILES
        assert meta["coverage"] > 0.3
    with pytest.raises(SystemExit):
        cli.main(["--demo", "--cpu", "--dtype", "float16"])


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    run_port_cli(capsys, "--demo", "--demo-size", "48", "64", "-D", "8",
                 "--cpu", "--profile", str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("mode", ["patch", "grad_hist"])
def test_centred_descriptors_match_jax(mode):
    rng = np.random.default_rng(3)
    jcfg = JConfig(max_disparity=16, descriptor=mode, center_descriptors=True)
    img = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    for fn in ("left_descriptors", "right_sliding_descriptors"):
        want = np.asarray(getattr(jdesc, fn)(jnp.asarray(img), jcfg))
        got = getattr(descriptors, fn)(torch.from_numpy(img),
                                       carry_over(jcfg)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, getattr(oracle, fn)(
            img, carry_over(jcfg)), atol=1e-5)
        # centred: every descriptor sums to ~0 (out-of-range ones are 0)
        assert np.abs(got.sum(-1)).max() < 1e-5


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_centred_decisions_equal_the_oracle(route):
    left, right, _ = synthetic.make_block_pair(64, 96, max_disparity=16,
                                               seed=4)
    cfg = Config(max_disparity=16, center_descriptors=True)
    got = api.match_stereo(left, right, cfg, impl=route, device="cpu")
    want = oracle.match_stereo(left, right, cfg)
    np.testing.assert_array_equal(got.disparity_raw, want.disparity_raw)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.disparity_right, want.disparity_right)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-5, atol=1e-6)


def test_cli_accepts_every_jax_flag():
    """Every option string of the JAX CLI parses in the port's, with the
    same default and choices; `--impl` differs by design (the port's
    routes, default 'fused'), and `--dot-precision` reaches the config
    and is ignored by the kernels."""
    def options(parser):
        return {s: a for a in parser._actions for s in a.option_strings}

    port, jax_ = options(cli.build_parser()), options(jcli.build_parser())
    assert set(jax_) <= set(port)
    differ = {s for s in jax_
              if (jax_[s].choices, jax_[s].default, jax_[s].nargs)
              != (port[s].choices, port[s].default, port[s].nargs)}
    assert differ == {"--impl"}
    assert tuple(port["--impl"].choices) == ("fused", "exact", "torch")
    assert tuple(jax_["--impl"].choices) == ("fused", "pallas", "jnp")
    for value in ("split2", "split3", "highest"):
        args = cli.build_parser().parse_args(["--demo", "--dot-precision",
                                              value])
        assert cli.config_from_args(args).fused_dot_precision == value
        want = carry_over(jcli.config_from_args(jcli.build_parser()
                                                .parse_args(["--demo",
                                                             "--dot-precision",
                                                             value])))
        assert repr(cli.config_from_args(args)) == repr(want)  # NaN field


def test_cli_dot_precision_changes_nothing(capsys):
    args = ("--demo", "--demo-size", "48", "64", "-D", "8", "--cpu")
    base = run_port_cli(capsys, *args)
    meta = run_port_cli(capsys, *args, "--dot-precision", "highest")
    assert meta["config"]["fused_dot_precision"] == "highest"
    assert {k: v for k, v in meta.items() if k not in ("config", "seconds",
                                                       "mpx_per_s")} \
        == {k: v for k, v in base.items() if k not in ("config", "seconds",
                                                       "mpx_per_s")}
