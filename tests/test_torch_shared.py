"""The port's own copies of the JAX package's JAX-free modules, held to
their originals on the CPU.

The port imports nothing of the JAX package; it carries copies of
`config`, `oracle/reference.py`, `data/synthetic.py`, `utils/metrics.py`,
`utils/logging.py`, `io/` and `native/`.  A copy must not drift: here each
is held bitwise (or field by field) to its original, and
`config.carry_over` moves a JAX `Config` across and back.
"""

import dataclasses
import io as std_io
import json

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import config as jconfig
from deepmatching_stereo_matching_tpu import native as jnative
from deepmatching_stereo_matching_tpu.data import synthetic as jsynthetic
from deepmatching_stereo_matching_tpu.io import images as jimages
from deepmatching_stereo_matching_tpu.io import writers as jwriters
from deepmatching_stereo_matching_tpu.oracle import reference as joracle
from deepmatching_stereo_matching_tpu.utils import logging as jlogging
from deepmatching_stereo_matching_tpu.utils import metrics as jmetrics
from deepmatching_stereo_matching_tpu_torch import config, native
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.io import images, writers
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch.utils import logging, metrics

SIZES = [(17, 33), (48, 64), (96, 144), (375, 450), (375, 1242), (100, 300)]
MAX_DS = [1, 8, 16, 64, 99, 128, 256]


@pytest.fixture(scope="module")
def native_libs():
    """Both native layers, built with g++ at first use (skip without)."""
    if not (native.available() and jnative.available()):
        pytest.skip(f"native build unavailable: {native.build_error()}, "
                    f"{jnative.build_error()}")
    return native, jnative


@pytest.mark.parametrize("patch_size", [2, 4, 8])
@pytest.mark.parametrize("levels", [None, 1, 2, 5])
def test_geometry_equals_jax(patch_size, levels):
    for (h, w) in SIZES:
        for max_d in MAX_DS:
            kw = dict(max_disparity=max_d, patch_size=patch_size,
                      levels=levels)
            got = config.Config(**kw).geometry(h, w)
            want = jconfig.Config(**kw).geometry(h, w)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
            for lvl in range(got.levels + 1):
                assert got.level_shape(lvl) == want.level_shape(lvl)


def test_config_fields_and_validation_equal_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(config.Config)
             if f.name != "invalid_value"]
            == [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)
                if f.name != "invalid_value"])
    for bad in (dict(max_disparity=0), dict(descriptor="sift"),
                dict(lr_mode="both"), dict(median_filter=2), dict(levels=0)):
        with pytest.raises(ValueError):
            jconfig.Config(**bad)
        with pytest.raises(ValueError):
            config.Config(**bad)


def test_carry_over_round_trips():
    jcfg = jconfig.Config(max_disparity=96, levels=3, lam=1.2, tau=2.0,
                          descriptor="grad_hist", center_descriptors=True,
                          lr_mode="direct", median_filter=3,
                          fill_invalid=True, invalid_value=-1.0)
    cfg = config.carry_over(jcfg)
    assert type(cfg) is config.Config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert jconfig.Config(**dataclasses.asdict(cfg)) == jcfg
    assert config.carry_over(cfg) == cfg
    assert cfg.geometry(375, 450) == config.Config(
        **dataclasses.asdict(jcfg)).geometry(375, 450)


def test_carry_over_rejects_other_fields():
    @dataclasses.dataclass
    class Missing:
        max_disparity: int = 16

    fields = {f.name: f.default for f in dataclasses.fields(config.Config)}
    Extra = dataclasses.make_dataclass(
        "Extra", [(k, object, dataclasses.field(default=v))
                  for k, v in {**fields, "unknown": 1}.items()])
    with pytest.raises(ValueError, match="missing fields"):
        config.carry_over(Missing())
    with pytest.raises(ValueError, match=r"unknown fields \['unknown'\]"):
        config.carry_over(Extra())
    with pytest.raises(TypeError):
        config.carry_over({"max_disparity": 16})


@pytest.mark.parametrize("mode", ["patch", "grad_hist", "centred"])
def test_oracle_copy_bitwise_to_jax(mode):
    kw = {"patch": {}, "grad_hist": {"descriptor": "grad_hist"},
          "centred": {"center_descriptors": True}}[mode]
    for seed in range(3):
        left, right, _ = jsynthetic.make_block_pair(40, 72, max_disparity=12,
                                                    seed=seed)
        cfg = dict(max_disparity=12, median_filter=3 if seed else 0, **kw)
        got = oracle.match_stereo(left, right, config.Config(**cfg))
        want = joracle.match_stereo(left, right, jconfig.Config(**cfg))
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f"{mode} {f.name}")


def test_synthetic_copy_bitwise_to_jax():
    for mod_args in [("block_disparity_field", (40, 56, 16), {"block": 8}),
                     ("object_disparity_field", (40, 56, 16), {})]:
        name, args, kw = mod_args
        got = getattr(synthetic, name)(*args, np.random.default_rng(3), **kw)
        want = getattr(jsynthetic, name)(*args, np.random.default_rng(3),
                                         **kw)
        np.testing.assert_array_equal(got, want, err_msg=name)
    field = jsynthetic.block_disparity_field(40, 56, 16,
                                             np.random.default_rng(4))
    for got, want in [
            (synthetic.make_pair(40, 56, field, seed=5, smooth=3),
             jsynthetic.make_pair(40, 56, field, seed=5, smooth=3)),
            (synthetic.make_block_pair(32, 48, 8, seed=6),
             jsynthetic.make_block_pair(32, 48, 8, seed=6)),
            (synthetic.adversarial_pair(40, 56, 16, seed=7),
             jsynthetic.adversarial_pair(40, 56, 16, seed=7)),
            ((synthetic.occlusion_mask(field),),
             (jsynthetic.occlusion_mask(field),)),
            ((synthetic.constant_disparity_field(8, 9, 3),),
             (jsynthetic.constant_disparity_field(8, 9, 3),))]:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_metrics_copy_equal_to_jax():
    rng = np.random.default_rng(8)
    pred = rng.uniform(0, 16, (24, 32)).astype(np.float32)
    pred[rng.random(pred.shape) < 0.2] = np.nan
    gt = np.round(rng.uniform(-1, 16, (24, 32))).astype(np.float32)
    for kw in ({}, {"count_invalid": False}, {"delta": 2.0}):
        assert (metrics.bad_pixel_rate(pred, gt, **kw)
                == jmetrics.bad_pixel_rate(pred, gt, **kw))
    assert metrics.coverage(pred) == jmetrics.coverage(pred)
    assert metrics.end_point_error(pred, gt) == jmetrics.end_point_error(
        pred, gt)


def test_jsonl_logger_copy_writes_the_same_records(tmp_path):
    lines = []
    for mod in (logging, jlogging):
        path = tmp_path / f"{mod.__name__}.jsonl"
        stream = std_io.StringIO()
        with mod.JsonlLogger(str(path), stream=stream) as log:
            log.log("batch_done", batch=3, seconds=0.5)
        rec = json.loads(path.read_text())
        assert json.loads(stream.getvalue()) == rec
        rec.pop("ts")
        lines.append(rec)
    assert lines[0] == lines[1] == {"event": "batch_done", "batch": 3,
                                    "seconds": 0.5}


def test_io_writers_and_readers_equal_to_jax(tmp_path, native_libs):
    rng = np.random.default_rng(9)
    disp = rng.uniform(0, 60, (20, 30)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.1] = np.nan
    valid = np.isfinite(disp)
    for name, write, args in [
            ("disparity.pfm", "write_pfm", (disp,)),
            ("disparity_16bit.png", "write_disparity_png16", (disp,)),
            ("disparity_color.png", "write_disparity_color", (disp, 64.0)),
            ("valid.png", "write_valid_mask", (valid,))]:
        getattr(writers, write)(str(tmp_path / f"port_{name}"), *args)
        getattr(jwriters, write)(str(tmp_path / f"jax_{name}"), *args)
        assert ((tmp_path / f"port_{name}").read_bytes()
                == (tmp_path / f"jax_{name}").read_bytes()), name
    np.testing.assert_array_equal(
        writers.read_pfm(str(tmp_path / "port_disparity.pfm")),
        jwriters.read_pfm(str(tmp_path / "jax_disparity.pfm")))
    np.testing.assert_array_equal(
        writers.read_disparity_png16(str(tmp_path /
                                         "port_disparity_16bit.png")),
        jwriters.read_disparity_png16(str(tmp_path /
                                          "jax_disparity_16bit.png")))
    np.testing.assert_array_equal(writers.colorize(disp, 64.0),
                                  jwriters.colorize(disp, 64.0))
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    native.write_pnm(str(tmp_path / "x.ppm"), img)
    for path in ("x.ppm", "port_valid.png"):
        np.testing.assert_array_equal(
            images.load_image(str(tmp_path / path)),
            jimages.load_image(str(tmp_path / path)))
        np.testing.assert_array_equal(
            images._load_pnm(str(tmp_path / "x.ppm")),
            jimages._load_pnm(str(tmp_path / "x.ppm")))


def test_native_copy_equal_to_jax(tmp_path, native_libs):
    port, jax_native = native_libs
    rng = np.random.default_rng(10)
    paths = ([], [])
    imgs = []
    for i in range(5):
        pair = (rng.integers(0, 256, (37, 53), dtype=np.uint8),
                rng.integers(0, 256, (37, 53, 3), dtype=np.uint8))
        imgs.append(pair)
        for side, img in enumerate(pair):
            path = str(tmp_path / f"{i}_{side}.{'pgm' if side == 0 else 'ppm'}")
            port.write_pnm(path, img)
            paths[side].append(path)
            np.testing.assert_array_equal(port.read_pnm(path)[0],
                                          jax_native.read_pnm(path)[0])
            np.testing.assert_array_equal(
                port.gray_norm_pad(img, 48, 64),
                jax_native.gray_norm_pad(img, 48, 64))
    with port.PairLoader(*paths, 48, 64, 2) as a, \
            jax_native.PairLoader(*paths, 48, 64, 2) as b:
        got, want = list(a), list(b)
    assert [g[0] for g in got] == [w[0] for w in want] == list(range(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    assert port._LIB != jax_native._LIB
    assert "deepmatching_stereo_matching_tpu_torch" in port._LIB
