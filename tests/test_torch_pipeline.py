"""PyTorch port's pipeline and API vs the JAX package and the oracle, on
the CPU.

The port's three routes run batched through `match_padded_core` and are
held to the JAX `match_padded` of the corresponding implementation
('fused' -> 'fused', 'exact' -> 'pallas', 'torch' -> 'jnp'): decisions,
validity and right disparities equal, scores at rtol 1e-5.  The two
paths this slice adds, KITTI-like large D (K4 -> K5 on 'fused', K2 -> K5
on 'exact') and grad_hist (K1b on 'fused'), are held to the JAX 'jnp'
path and to the oracle: 'exact' decisions equal, 'fused' at most 0.5%
of decisions flipped (the bench's gate).  On CPU tensors the kernel
routes run the kernels' plain versions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu import api as japi
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.models import pipeline as jpipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch import api
from deepmatching_stereo_matching_tpu_torch.config import carry_over
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import (
    _build, _dispatch, fused_cuda, pyramid_cuda)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_IMPL = {"fused": "fused", "exact": "pallas", "torch": "jnp"}
H, W, MAX_D = 96, 128, 16
FUSED_DECISION_TOL = 0.005
# The slice's new paths: (cfg, height, width, field disparity range).
# large_d: L=5 and D0=128 on a 32x32 patch grid, where neither K1's nor
# K3's tile fits a block, as at KITTI D=128.
NEW_PATHS = {
    "large_d": (Config(max_disparity=128, levels=5), 128, 128, 48),
    "grad_hist": (Config(max_disparity=MAX_D, descriptor="grad_hist"),
                  H, W, MAX_D),
    "direct": (Config(max_disparity=MAX_D, lr_mode="direct"), H, W, MAX_D),
}


def synthetic_pair(seed, h=H, w=W, field_d=MAX_D):
    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(h, w, field_d, rng, block=16)
    return synthetic.make_pair(h, w, field, seed=seed)


def padded_pairs(cfg, seeds, h=H, w=W, field_d=MAX_D):
    geom = cfg.geometry(h, w)
    return [tuple(oracle.pad_image(oracle.to_grayscale_f32(x), geom)
                  for x in synthetic_pair(seed, h, w, field_d)[:2])
            for seed in seeds]


def assert_outputs_match(got, want, score_atol=1e-7):
    for k in ("disparity_raw", "valid", "disparity_right"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["disparity"], want["disparity"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5,
                               atol=score_atol)


def assert_within_fused_gate(got, want):
    for k in ("disparity_raw", "valid", "disparity_right"):
        rate = np.mean(np.asarray(got[k]) != np.asarray(want[k]))
        assert rate <= FUSED_DECISION_TOL, (k, rate)


@pytest.mark.parametrize("lr_check,lr_mode", [(True, "flip"),
                                              (False, "flip"),
                                              (True, "direct")],
                         ids=["flip", "no_lr", "direct"])
@pytest.mark.parametrize("route", ["fused", "exact", "torch"])
def test_match_padded_core_batched_matches_jax(route, lr_check, lr_mode):
    """'direct' matches R->L with +d targets on shared descriptors; on
    'fused' it takes the 'exact' route, as in JAX."""
    cfg = Config(max_disparity=MAX_D, lr_check=lr_check, lr_mode=lr_mode)
    pcfg = carry_over(cfg)
    pairs = padded_pairs(cfg, (3, 4))
    lb = torch.from_numpy(np.stack([l for l, _ in pairs]))
    rb = torch.from_numpy(np.stack([r for _, r in pairs]))
    out = pipeline.crop(pipeline.match_padded_core(
        lb, rb, pcfg, pcfg.geometry(H, W), route), H, W)
    assert out["disparity_raw"].dtype == torch.int32
    assert out["disparity"].shape == (2, H, W)
    for i, (l, r) in enumerate(pairs):
        want = jpipeline.match_padded(jnp.asarray(l), jnp.asarray(r), cfg, H,
                                      W, JAX_IMPL[route])
        assert_outputs_match({k: v[i].numpy() for k, v in out.items()},
                             {k: np.asarray(v) for k, v in want.items()})


def test_lr_consistency_patch_matches_jax():
    """The gather form is bitwise equal to JAX's shift scan."""
    rng = np.random.default_rng(0)
    dl = rng.integers(0, 32, (6, 16)).astype(np.int32)
    dr = rng.integers(0, 32, (6, 16)).astype(np.int32)
    want = np.asarray(jpipeline.lr_consistency_patch(
        jnp.asarray(dl), jnp.asarray(dr), 1.0, 32, 4))
    got = pipeline.lr_consistency_patch(torch.from_numpy(dl),
                                        torch.from_numpy(dr), 1.0, 32, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("col0_patches", [0, 5])
def test_lr_consistency_patch_padded_matches_jax(col0_patches):
    """A W-tile's check: the left neighbour's trailing columns in the pad,
    the tile's global patch column in the in-range test x >= dL."""
    rng = np.random.default_rng(1)
    dl = rng.integers(0, 32, (2, 6, 16)).astype(np.int32)
    padded = rng.integers(0, 32, (2, 6, 8 + 1 + 16)).astype(np.int32)
    got = pipeline.lr_consistency_patch_padded(
        torch.from_numpy(dl), torch.from_numpy(padded), 1.0, 32, 4,
        col0_patches)
    for b in range(2):
        want = np.asarray(jpipeline.lr_consistency_patch_padded(
            jnp.asarray(dl[b]), jnp.asarray(padded[b]), 1.0, 32, 4,
            col0_patches))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("route", ["fused", "exact", "torch"])
def test_api_matches_jax_and_oracle(route):
    left, right, gt = synthetic.make_block_pair(120, 180, max_disparity=24,
                                                seed=42)
    cfg = Config(max_disparity=24)
    got = api.match_stereo(left, right, carry_over(cfg), impl=route,
                           device="cpu")
    want = japi.match_stereo(left, right, cfg, impl=JAX_IMPL[route])
    ora = oracle.match_stereo(left, right, cfg)
    for ref in (want, ora):
        np.testing.assert_array_equal(got.disparity_raw, ref.disparity_raw)
        np.testing.assert_array_equal(got.valid, ref.valid)
        np.testing.assert_array_equal(got.disparity, ref.disparity)
        np.testing.assert_array_equal(got.disparity_right,
                                      ref.disparity_right)
        np.testing.assert_allclose(got.score, ref.score, rtol=1e-5, atol=1e-7)
    assert got.disparity.shape == (120, 180)


def test_route_context_selects_route():
    left, right, _ = synthetic.make_block_pair(64, 64, max_disparity=16,
                                               seed=1)
    cfg = carry_over(Config(max_disparity=16))
    with _dispatch.set_route("torch"):
        assert _dispatch.route() == "torch"
        a = api.match_stereo(left, right, cfg, device="cpu")
    assert _dispatch.route() == "fused"
    b = api.match_stereo(left, right, cfg, impl="torch", device="cpu")
    np.testing.assert_array_equal(a.disparity_raw, b.disparity_raw)
    with pytest.raises(ValueError, match="unknown route"):
        api.match_stereo(left, right, cfg, impl="pallas", device="cpu")


JAX_NAMES = ("jax", "deepmatching_stereo_matching_tpu")


def test_port_imports_no_jax():
    """Every module of the port (`pkgutil.walk_packages`) and chip_smoke.py,
    imported in a fresh process and then run once: neither `jax` nor any
    module of the JAX package is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepmatching_stereo_matching_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from deepmatching_stereo_matching_tpu_torch import Config\n"
        "from deepmatching_stereo_matching_tpu_torch.api import match_stereo\n"
        "from deepmatching_stereo_matching_tpu_torch.data.synthetic import "
        "make_block_pair\n"
        "l, r, _ = make_block_pair(64, 96, max_disparity=16, seed=0)\n"
        "res = match_stereo(l, r, Config(max_disparity=16), device='cpu')\n"
        "assert res.disparity.shape == (64, 96)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{JAX_NAMES!r})\n"
        "assert not bad, bad\n"
        "assert len(mods) > 30, mods\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_import_no_jax():
    """An ast scan of the port's sources and chip_smoke.py: no import of
    `jax` or of the JAX package, at any depth of the code."""
    import ast

    port = os.path.join(REPO, "deepmatching_stereo_matching_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(port):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path, node.lineno, n) for n in names
                      if n.split(".")[0] in JAX_NAMES]
    assert not found, found


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right, _ = synthetic.make_block_pair(64, 64, max_disparity=16,
                                               seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        api.match_stereo(left, right, carry_over(Config(max_disparity=16)))


def test_profile_steps_needs_a_card(monkeypatch, capsys):
    from deepmatching_stereo_matching_tpu_torch import profile_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_steps.main(["--cells", "kitti128"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    assert set(profile_steps.CELLS) == {"bench", "grad_hist", "zncc",
                                        "kitti128", "kitti256", "kitti256gh",
                                        "mb14f"}
    assert profile_steps.CENTRED <= set(profile_steps.CELLS)


def test_kernel_modules_import_without_nvcc():
    """Importing and running on CPU tensors builds nothing."""
    code = (
        "import os\n"
        "os.environ['PATH'] = ''\n"
        "os.environ['CUDA_HOME'] = '/nonexistent'\n"
        "import torch\n"
        "from deepmatching_stereo_matching_tpu_torch.ops import "
        "_build, costvol_cuda, fused_cuda, pyramid_cuda\n"
        "d, s = pyramid_cuda.pyramid_backtrack(torch.rand(8, 4, 4), 2, 1.4)\n"
        "assert d.shape == (4, 4) and not _build.loaded()\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert not _build.loaded()


@pytest.mark.parametrize("cfg", [
    Config(max_disparity=16, lr_mode="direct"),
    Config(max_disparity=16, median_filter=3),
    Config(max_disparity=16, center_descriptors=True),
    Config(max_disparity=16, descriptor="grad_hist", center_descriptors=True),
], ids=["lr_mode", "post-filter", "centred", "centred-grad_hist"])
@pytest.mark.parametrize("route", ["fused", "exact"])
def test_formerly_uncovered_configs_match_jax(cfg, route):
    """lr_mode='direct', the post-filter and centred descriptors, which
    raised before they were ported: `api.match_stereo` vs JAX's and the
    oracle's."""
    left, right, _ = synthetic_pair(2, 64, 64, 16)
    got = api.match_stereo(left, right, carry_over(cfg), impl=route,
                           device="cpu")
    want = japi.match_stereo(left, right, cfg, impl=JAX_IMPL[route])
    ora = oracle.match_stereo(left, right, cfg)
    for ref in (want, ora):
        np.testing.assert_array_equal(got.disparity_raw, ref.disparity_raw)
        np.testing.assert_array_equal(got.valid, ref.valid)
        np.testing.assert_array_equal(got.disparity, ref.disparity)
        np.testing.assert_array_equal(got.disparity_right,
                                      ref.disparity_right)
        np.testing.assert_allclose(got.score, ref.score, rtol=1e-5,
                                   atol=2e-5)


BF16 = dict(max_disparity=16, dtype="bfloat16")


@pytest.mark.parametrize("cfg,match", [
    (Config(**BF16), "'exact' route"),
    (Config(**BF16, descriptor="grad_hist"), "grad_hist"),
    (Config(**BF16, center_descriptors=True), "centred"),
    (Config(**BF16, lr_mode="direct"), "lr_mode='direct'"),
])
@pytest.mark.parametrize("route", ["fused", "exact"])
def test_uncovered_configs_raise(cfg, match, route):
    """The bfloat16 configurations that raised NotImplementedError until
    they were ported (`match` names what each raised for) now run on both
    kernel routes: batched `match_padded_core` returns float32 scores, and
    its decisions agree with JAX's bf16 `match_padded` of the same route
    ('fused' -> 'fused', 'exact' -> 'pallas') on >= 99.8% of pixels."""
    pcfg = carry_over(cfg)
    pairs = padded_pairs(cfg, (2, 5), 64, 64)
    lb = torch.from_numpy(np.stack([l for l, _ in pairs]))
    rb = torch.from_numpy(np.stack([r for _, r in pairs]))
    out = pipeline.crop(pipeline.match_padded_core(
        lb, rb, pcfg, pcfg.geometry(64, 64), route), 64, 64)
    assert out["score"].dtype == torch.float32
    assert out["disparity"].dtype == torch.float32
    for i, (l, r) in enumerate(pairs):
        want = jpipeline.match_padded(jnp.asarray(l), jnp.asarray(r), cfg,
                                      64, 64, JAX_IMPL[route])
        for k in ("disparity_raw", "valid"):
            rate = float(np.mean(out[k][i].numpy() == np.asarray(want[k])))
            print(f"{match} {route} pair {i}: {k} {rate:.5f}")
            assert rate >= 0.998, (k, rate)


def test_bf16_fused_runs_at_64x64():
    """bf16 'fused' at 64x64, D=16 runs plain K1 and agrees with JAX's
    bf16 'fused' and with the port's float32 decisions."""
    cfg = Config(**BF16)
    left, right, _ = synthetic_pair(2, 64, 64, 16)
    got = api.match_stereo(left, right, carry_over(cfg), impl="fused",
                           device="cpu")
    want = japi.match_stereo(left, right, cfg, impl="fused")
    f32 = api.match_stereo(left, right, carry_over(Config(max_disparity=16)),
                           impl="fused", device="cpu")
    assert got.disparity.dtype == got.score.dtype == np.float32
    np.testing.assert_array_equal(got.disparity_raw, want.disparity_raw)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert np.mean(got.disparity_raw == f32.disparity_raw) >= 0.98


@pytest.mark.parametrize("path", ["large_d", "grad_hist"])
@pytest.mark.parametrize("route", ["fused", "exact"])
def test_new_paths_batched_match_jax(route, path):
    """Two pairs through `match_padded_core` at once vs JAX 'jnp'."""
    cfg, h, w, field_d = NEW_PATHS[path]
    pcfg = carry_over(cfg)
    geom = pcfg.geometry(h, w)
    if path == "large_d":
        assert (geom.levels, geom.disparities) == (5, 128)
        assert not fused_cuda.supported(pcfg, geom)
        assert not pyramid_cuda.supported(geom.disparities, geom.levels)
        assert fused_cuda.cost_supported(pcfg, geom)
    else:
        assert fused_cuda.supported(pcfg, geom)
    pairs = padded_pairs(cfg, (3, 4), h, w, field_d)
    lb = torch.from_numpy(np.stack([l for l, _ in pairs]))
    rb = torch.from_numpy(np.stack([r for _, r in pairs]))
    out = pipeline.crop(pipeline.match_padded_core(lb, rb, pcfg, geom, route),
                        h, w)
    assert out["disparity_raw"].dtype == torch.int32
    assert out["disparity"].shape == (2, h, w)
    for i, (l, r) in enumerate(pairs):
        got = {k: v[i].numpy() for k, v in out.items()}
        want = {k: np.asarray(v) for k, v in jpipeline.match_padded(
            jnp.asarray(l), jnp.asarray(r), cfg, h, w, "jnp").items()}
        if route == "exact":
            # grad_hist descriptors hold the oracle at atol 1e-5, not
            # bitwise; so do the scores built from them.
            assert_outputs_match(got, want, 2e-5 if path == "grad_hist"
                                 else 1e-7)
        else:
            assert_within_fused_gate(got, want)
            same = got["disparity_raw"] == want["disparity_raw"]
            np.testing.assert_allclose(got["score"][same],
                                       want["score"][same], atol=2e-5)


@pytest.mark.parametrize("path", ["large_d", "grad_hist"])
@pytest.mark.parametrize("route", ["fused", "exact"])
def test_new_paths_api_match_oracle(route, path):
    cfg, h, w, field_d = NEW_PATHS[path]
    left, right, gt = synthetic_pair(5, h, w, field_d)
    got = api.match_stereo(left, right, carry_over(cfg), impl=route,
                           device="cpu")
    ora = oracle.match_stereo(left, right, cfg)
    assert got.disparity.shape == (h, w)
    assert np.isfinite(got.score).all()
    got_d = {"disparity_raw": got.disparity_raw, "valid": got.valid,
             "disparity_right": got.disparity_right}
    want_d = {"disparity_raw": ora.disparity_raw, "valid": ora.valid,
              "disparity_right": ora.disparity_right}
    if route == "exact":
        for k in got_d:
            np.testing.assert_array_equal(got_d[k], want_d[k], err_msg=k)
        np.testing.assert_allclose(got.score, ora.score, rtol=1e-5,
                                   atol=2e-5)
    else:
        assert_within_fused_gate(got_d, want_d)
    from deepmatching_stereo_matching_tpu.utils import metrics
    bad_g = metrics.bad_pixel_rate(got.disparity, gt, count_invalid=False)
    bad_o = metrics.bad_pixel_rate(ora.disparity, gt, count_invalid=False)
    assert abs(bad_g - bad_o) <= FUSED_DECISION_TOL


@pytest.mark.parametrize("path,route,called", [
    ("large_d", "fused", ["cost_volume_rows", "aggregate_dmajor(fast)"]),
    ("large_d", "exact", ["cost_volume_dmajor", "aggregate_dmajor(exact)"]),
    ("grad_hist", "fused", ["match_planes"]),
    ("grad_hist", "exact", ["cost_volume_dmajor", "pyramid_backtrack"]),
    ("direct", "fused", ["cost_volume_dmajor", "pyramid_backtrack"] * 2),
])
def test_routes_pick_kernels_by_config(monkeypatch, path, route, called):
    """Which kernel wrappers each new path reaches (on the card each is
    one kernel); the CPU runs the same wrappers' plain versions."""
    from deepmatching_stereo_matching_tpu_torch.ops import costvol_cuda
    seen = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            tag = name
            if name == "aggregate_dmajor":      # (cost, levels, lam, fast)
                tag += "(fast)" if a[3] else "(exact)"
            seen.append(tag)
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(fused_cuda, "match_planes")
    spy(fused_cuda, "cost_volume_rows")
    spy(costvol_cuda, "cost_volume_dmajor")
    spy(pyramid_cuda, "pyramid_backtrack")
    spy(pyramid_cuda, "aggregate_dmajor")
    cfg, h, w, field_d = NEW_PATHS[path]
    (l, r), = padded_pairs(cfg, (6,), h, w, field_d)
    pcfg = carry_over(cfg)
    pipeline.match_padded_core(torch.from_numpy(l), torch.from_numpy(r), pcfg,
                               pcfg.geometry(h, w), route)
    assert seen == called
