"""The stream's grayscale and pad on the device (csrc/prep.cu,
ops/prep_cuda.py, `sharded.pad_batch(device=...)`), on the CPU, held to
the JAX package.

The plain version is bitwise the JAX package's `to_grayscale_f32` and
`pad_image` at every strategy's padded geometry and on all 2^24 colours;
`pad_batch` with a device takes the raw path only for uint8 batches of
the stream's shape and gives the planes of the JAX package's `pad_batch`
(and of the port's host path) bitwise, on every strategy; `run_stream`
fed uint8 colour pairs on a world of 4 gloo ranks gives the outputs of
the same pairs fed as planes padded by the JAX package.  The kernel
itself is held on the card by tests/test_torch_prep_card.py.
"""

import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu import Config as JConfig
from deepmatching_stereo_matching_tpu import parallel as jparallel
from deepmatching_stereo_matching_tpu.oracle import reference as joracle
from deepmatching_stereo_matching_tpu.parallel import (
    mesh as jmesh_lib, sharded as jsharded, wtiled as jwtiled)
from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.ops import prep_cuda
from deepmatching_stereo_matching_tpu_torch.parallel import (
    launch, mesh as mesh_lib, runner, sharded)
from deepmatching_stereo_matching_tpu_torch.utils.logging import JsonlLogger

H, W, D = 37, 53, 16          # ragged: neither divides a tile
KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def oracle_batch(images, hp, wp):
    """The JAX package's grayscale and pad of every image."""
    geom = SimpleNamespace(padded_height=hp, padded_width=wp)
    return np.stack([joracle.pad_image(joracle.to_grayscale_f32(x), geom)
                     for x in images])


def image_case(name, rng, h=H, w=W):
    """One uint8 image of the kind `name` names."""
    if name == "gray":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if name in ("rgb", "rgba"):
        return rng.integers(0, 256, (h, w, len(name)), dtype=np.uint8)
    if name == "dark_gray":                   # max 1: not divided
        return rng.integers(0, 2, (h, w), dtype=np.uint8)
    if name == "dark_rgb":                    # grayscale at most 1.0
        return rng.integers(0, 2, (h, w, 3), dtype=np.uint8)
    if name == "one_bright":                  # lit by its last pixel
        img = np.zeros((h, w, 3), dtype=np.uint8)
        img[-1, -1] = 2
        return img
    raise ValueError(name)


CASES = ("gray", "rgb", "rgba", "dark_gray", "dark_rgb", "one_bright")


def padded_extents(strategy, cfg, h, w):
    """(Hp, Wp) of a strategy's global geometry on a 2-way split, as the
    JAX package reckons it."""
    if strategy == "tiled":
        glob, _ = jmesh_lib.tiled_geometry(cfg, h, w, 2)
    elif strategy == "wtiled":
        glob, _, _ = jwtiled.tiled2d_geometry(cfg, h, w, 2, 2, 1)
    else:
        glob, _ = jsharded._slab_geometry(cfg, h, w, 2)
    return glob.padded_height, glob.padded_width


@pytest.mark.parametrize("strategy", ["tiled", "wtiled", "dslab"])
@pytest.mark.parametrize("case", CASES)
def test_plain_is_oracle_grayscale_and_pad(case, strategy):
    rng = np.random.default_rng(CASES.index(case))
    images = [image_case(case, rng) for _ in range(3)]
    hp, wp = padded_extents(strategy, JConfig(max_disparity=D), H, W)
    assert (hp, wp) != (H, W)
    want = oracle_batch(images, hp, wp)
    got = prep_cuda.gray_pad(torch.from_numpy(np.stack(images)), hp, wp)
    assert got.dtype == torch.float32 and got.shape == (3, hp, wp)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    if case == "dark_gray":                       # left undivided
        np.testing.assert_array_equal(got.numpy()[:, :H, :W],
                                      np.stack(images).astype(np.float32))


def test_plain_every_colour():
    """All 2^24 RGB values, in lit images of 32 x 256 x 256."""
    r = np.arange(256, dtype=np.uint8)
    for lo in range(0, 256, 32):
        rgb = np.stack(np.meshgrid(np.arange(lo, lo + 32, dtype=np.uint8),
                                   r, r, indexing="ij"), -1)
        rgb = rgb.reshape(32 * 256, 256, 3)
        got = prep_cuda.gray_pad_torch(torch.from_numpy(rgb)[None],
                                       32 * 256, 256)[0].numpy()
        np.testing.assert_array_equal(bits(got),
                                      bits(joracle.to_grayscale_f32(rgb)))


@pytest.mark.parametrize("images, hp, wp", [
    (torch.zeros((2, 4, 5), dtype=torch.float32), 4, 5),
    (torch.zeros((2, 4, 5, 2), dtype=torch.uint8), 4, 5),
    (torch.zeros((4, 5), dtype=torch.uint8), 4, 5),
    (torch.zeros((2, 4, 5, 3), dtype=torch.uint8), 3, 5),
    (torch.zeros((2, 4, 5), dtype=torch.uint8), 4, 4),
], ids=["float", "two_channels", "one_image", "short", "narrow"])
def test_gray_pad_refuses(images, hp, wp):
    with pytest.raises((TypeError, ValueError)):
        prep_cuda.gray_pad(images, hp, wp)


def test_empty_batch_and_slices():
    out = prep_cuda.gray_pad(torch.zeros((0, 4, 5, 3), dtype=torch.uint8),
                             8, 8)
    assert out.shape == (0, 8, 8)
    assert [prep_cuda.slices(n) for n in (0, 1, 2048, 2049, 168_750,
                                          10 ** 9)] == [1, 1, 1, 2, 83, 128]


def test_work_model_at_the_stream_cell():
    """32 images of 450 x 375 x 3 into 384 x 512: 16.2 MB in, 25.2 MB out,
    bound by bytes at 3.35 TB/s."""
    model = work.gray_pad(32, 375, 450, 3, 384, 512)
    assert model.bytes == {"raw": 16_200_000, "planes": 25_165_824}
    assert model.total_ops == 0
    t, by = work.bound(model)
    assert by == "bytes" and t == pytest.approx(41_365_824 / 3.35e12)


RAW = {"gray": (H, W), "rgb": (H, W, 3), "rgba": (H, W, 4)}


@pytest.mark.parametrize("images, raw", [
    ([np.zeros(RAW["gray"], np.uint8)] * 2, True),
    ([np.zeros(RAW["rgb"], np.uint8)] * 2, True),
    ([np.zeros(RAW["rgba"], np.uint8)] * 2, True),
    ([np.zeros(RAW["gray"], np.float32)] * 2, False),
    ([sharded.as_padded(np.zeros((48, 64), np.float32))] * 2, False),
    ([np.zeros(RAW["gray"], np.uint8), np.zeros(RAW["rgb"], np.uint8)],
     False),
    ([np.zeros((H - 1, W), np.uint8)] * 2, False),
    ([np.zeros((H, W, 2), np.uint8)] * 2, False),
    ([np.zeros(RAW["rgb"], np.uint16)] * 2, False),
    ([], False),
], ids=["gray", "rgb", "rgba", "float", "padded", "mixed", "smaller",
        "two_channels", "uint16", "empty"])
def test_raw_batch_follows_dtype_and_shape(images, raw):
    assert sharded.raw_batch(images, H, W) is raw


# ---------------------------------------------------------------------------
# pad_batch and run_stream on a world of 4 gloo ranks
# ---------------------------------------------------------------------------

STRATEGIES = {"tiled_1x4": ("tiled", (1, 4), None),
              "tiled_2x2": ("tiled", (2, 2), None),
              "wtiled_1": ("wtiled", (1, 2, 2), 1),
              "wtiled_top": ("wtiled", (1, 2, 2), None),
              "dslab": ("dslab", (1, 4), None),
              "ringd": ("ringd", (1, 4), None)}
HOST_KINDS = ("float", "padded", "mixed", "smaller")
STREAMS = {"tiled": (2, 2), "dslab": (1, 4)}


def _mesh(shape):
    if len(shape) == 3:
        return mesh_lib.make_mesh2d(*shape)
    return mesh_lib.make_mesh(*shape)


def _jax_mesh(shape):
    if len(shape) == 3:
        return jparallel.make_mesh2d(*shape)
    return jparallel.make_mesh(*shape)


def _colour_pairs(n, seed):
    """uint8 (H, W, 3) pairs whose channels differ."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, D, rng, block=16)
        pair = synthetic.make_pair(H, W, field, seed=seed + i)[:2]
        out.append(tuple(np.clip(np.round(x * 255)[..., None]
                                 + rng.integers(-9, 10, (H, W, 3)), 0, 255)
                         .astype(np.uint8) for x in pair))
    return out


def _inputs():
    """What the world pads and streams, and the JAX package's padding of
    it: each raw batch at every strategy, each batch that keeps the host
    path, and every stream pair as a plane of its strategy."""
    jcfg = JConfig(max_disparity=D)
    rng = np.random.default_rng(11)
    raw = {k: [image_case(k, rng) for _ in range(3)] for k in RAW}
    want = {}
    for name, (strategy, shape, ml) in STRATEGIES.items():
        mesh = _jax_mesh(shape)
        for kind, images in raw.items():
            want[name, kind] = jparallel.pad_batch(images, jcfg, H, W, mesh,
                                                   strategy, ml)
    mesh = _jax_mesh((1, 4))
    planes = jparallel.pad_batch(raw["rgb"], jcfg, H, W, mesh)
    others = {
        "float": [x.astype(np.float32) / 255 for x in raw["gray"]],
        "padded": list(planes),
        "mixed": [raw["gray"][0], raw["rgb"][1]],
        "smaller": [x[:-1] for x in raw["gray"]]}
    for kind, images in others.items():
        if kind == "padded":
            images = [jsharded.as_padded(p) for p in images]
        want[kind] = jparallel.pad_batch(images, jcfg, H, W, mesh)
    pairs = _colour_pairs(9, 30)
    streams = {strategy: [tuple(jparallel.pad_batch([x], jcfg, H, W,
                                                    _jax_mesh(shape),
                                                    strategy)[0]
                                for x in pair) for pair in pairs]
               for strategy, shape in STREAMS.items()}
    return dict(raw=raw, others=others, pairs=pairs, streams=streams), want


def _rank_prep(cfg, inputs):
    calls = {"n": 0}
    real = prep_cuda.gray_pad

    def counting(*args):
        calls["n"] += 1
        return real(*args)
    prep_cuda.gray_pad = counting
    cpu = torch.device("cpu")
    res = {}
    for name, (strategy, shape, ml) in STRATEGIES.items():
        mesh = _mesh(shape)
        for kind, images in inputs["raw"].items():
            host = sharded.pad_batch(images, cfg, H, W, mesh, strategy, ml)
            calls["n"] = 0
            dev = sharded.pad_batch(images, cfg, H, W, mesh, strategy, ml,
                                    device=cpu)
            res[name, kind] = (host, dev.numpy(), calls["n"])
    mesh = _mesh((1, 4))
    for kind, images in inputs["others"].items():
        if kind == "padded":
            images = [sharded.as_padded(p) for p in images]
        host = sharded.pad_batch(images, cfg, H, W, mesh)
        calls["n"] = 0
        dev = sharded.pad_batch(images, cfg, H, W, mesh, device=cpu)
        res[kind] = (host, dev.numpy(), calls["n"])

    for strategy, shape in STREAMS.items():
        padded = [tuple(sharded.as_padded(p) for p in pair)
                  for pair in inputs["streams"][strategy]]
        runs = {}
        for source, feed in (("uint8", inputs["pairs"]), ("padded", padded)):
            got, text = {}, io.StringIO()
            calls["n"] = 0
            runner.run_stream(feed, cfg, H, W, _mesh(shape), strategy, 4,
                              "exact",
                              on_result=lambda i, o: got.update({i: o}),
                              logger=JsonlLogger(stream=text))
            recs = [json.loads(line) for line in text.getvalue().splitlines()]
            runs[source] = dict(out=got, calls=calls["n"], pads=[
                r["pad"] for r in recs if r["event"] == "batch_done"])
        res["stream", strategy] = runs
    return res


@pytest.fixture(scope="module")
def world():
    inputs, want = _inputs()
    ranks = launch.spawn(_rank_prep, 4, (Config(max_disparity=D), inputs),
                         timeout=240)
    return ranks, want


@pytest.mark.parametrize("kind", list(RAW))
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_pad_batch_on_device_equals_host(world, strategy, kind):
    """The raw path's planes are the JAX package's `pad_batch`, bitwise,
    and the port's host path's; one prep call a batch."""
    ranks, want = world
    for rank in ranks:
        host, dev, calls = rank[strategy, kind]
        assert calls == 1
        assert host.dtype == dev.dtype == np.float32
        np.testing.assert_array_equal(bits(dev), bits(want[strategy, kind]))
        np.testing.assert_array_equal(bits(dev), bits(host))


@pytest.mark.parametrize("kind", HOST_KINDS)
def test_other_batches_take_the_host_path(world, kind):
    ranks, want = world
    for rank in ranks:
        host, dev, calls = rank[kind]
        assert calls == 0
        np.testing.assert_array_equal(bits(dev), bits(want[kind]))
        np.testing.assert_array_equal(bits(dev), bits(host))


@pytest.mark.parametrize("strategy", list(STREAMS))
def test_stream_of_uint8_pairs_pads_on_the_device(world, strategy):
    """Bitwise the outputs of the same pairs fed as planes that the JAX
    package padded; every batch (two of 4, a tail of 1) pads on the
    device, one call a side."""
    ranks, _ = world
    for rank in ranks:
        runs = rank["stream", strategy]
        u8, padded = runs["uint8"], runs["padded"]
        assert u8["pads"] == ["device"] * 3
        assert padded["pads"] == ["host"] * 3
        assert u8["calls"] == 2 * 3 and padded["calls"] == 0
        assert sorted(u8["out"]) == sorted(padded["out"]) == [0, 1, 2]
        for b in u8["out"]:
            for k in KEYS:
                np.testing.assert_array_equal(u8["out"][b][k],
                                              padded["out"][b][k],
                                              err_msg=f"batch {b} {k}")
