"""PyTorch port's sharded strategies on a world of 4 gloo ranks (CPU).

One spawned world per module (`launch.spawn`, a module-scoped fixture)
runs every case once through `parallel.match_batch_sharded`; each rank
gathers the global outputs.  Every case is then held (a) bitwise, on
every key, to the port's unsharded `match_padded_core` at the strategy's
padded extents on the same route (the JAX package's own contract for its
strategies), and (b) to the JAX strategy on the 8-device CPU mesh:
decisions, validity and the post-filtered disparity equal, scores at
rtol 1e-5 (atol 2e-5 on 'fused').  The JAX side runs 'jnp' for the
kernel routes ('pallas' decisions are the same, tests/test_sharded.py)
and 'fused' for 'fused'.  The ringd cases run with debug_checks on.
"""

import operator

import numpy as np
import pytest
import torch

import jax

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu import parallel as jparallel
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch.config import carry_over
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.parallel import (
    collectives, launch, mesh as mesh_lib, ringd, sharded, wtiled)

H, W, D = 96, 144, 16
JAX_IMPL = {"fused": "fused", "exact": "jnp", "torch": "jnp"}
KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")

# id -> (strategy, mesh shape, route, merge_level, Config kwargs, field D)
CASES = {
    "tiled-2x2-flip": ("tiled", (2, 2), "fused", None, {}, D),
    "tiled-1x4-direct": ("tiled", (1, 4), "fused", None,
                         {"lr_mode": "direct"}, D),
    "tiled-1x4-nolr-postfilter": ("tiled", (1, 4), "fused", None,
                                  {"lr_check": False, "median_filter": 3,
                                   "fill_invalid": True}, D),
    "dslab-2x2-flip": ("dslab", (2, 2), "exact", None, {}, D),
    "dslab-2x2-direct": ("dslab", (2, 2), "exact", None,
                         {"lr_mode": "direct"}, D),
    "dslab-1x4-unaligned-slab": ("dslab", (1, 4), "exact", None,
                                 {"max_disparity": 8, "levels": 1}, 8),
    "dslab-1x4-nolr-torch": ("dslab", (1, 4), "torch", None,
                             {"lr_check": False}, D),
    "ringd-1x4-d16-flip": ("ringd", (1, 4), "exact", None, {"levels": 2}, D),
    "ringd-1x4-d32-direct": ("ringd", (1, 4), "exact", None,
                             {"max_disparity": 32, "levels": 2,
                              "lr_mode": "direct"}, 32),
    "ringd-1x4-d32-nolr": ("ringd", (1, 4), "exact", None,
                           {"max_disparity": 32, "levels": 2,
                            "lr_check": False}, 32),
    "wtiled-1x1x4-full-flip": ("wtiled", (1, 1, 4), "exact", None, {}, D),
    "wtiled-1x1x4-merge0-direct": ("wtiled", (1, 1, 4), "exact", 0,
                                   {"lr_mode": "direct"}, D),
    "wtiled-1x1x4-merge1-flip": ("wtiled", (1, 1, 4), "exact", 1, {}, D),
    "wtiled-1x1x4-merge1-nolr-gradhist": (
        "wtiled", (1, 1, 4), "exact", 1,
        {"lr_check": False, "descriptor": "grad_hist"}, D),
    "wtiled-1x2x2-gradhist-direct": ("wtiled", (1, 2, 2), "exact", None,
                                     {"lr_mode": "direct",
                                      "descriptor": "grad_hist"}, D),
    "wtiled-1x2x2-gradhist-flip": ("wtiled", (1, 2, 2), "exact", None,
                                   {"descriptor": "grad_hist"}, D),
}


def make_batch(n_pairs, field_d, seed):
    lefts, rights = [], []
    for i in range(n_pairs):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, field_d, rng, block=24)
        left, right, _ = synthetic.make_pair(H, W, field, seed=seed + i)
        lefts.append(left)
        rights.append(right)
    return lefts, rights


def jax_config(name):
    return Config(**{"max_disparity": D, **CASES[name][4]})


def case_inputs(name):
    strategy, shape, route, ml, kw, field_d = CASES[name]
    cfg = carry_over(jax_config(name))
    lefts, rights = make_batch(2, field_d, seed=sorted(CASES).index(name))
    return dict(cfg=cfg, strategy=strategy, mesh=shape, route=route,
                merge_level=ml, height=H, width=W, lefts=lefts,
                rights=rights, debug_checks=strategy == "ringd")


def global_geometry(case):
    """The strategy's padded geometry, without a world."""
    cfg, shape = case["cfg"], case["mesh"]
    if case["strategy"] == "tiled":
        return mesh_lib.tiled_geometry(cfg, H, W, shape[1])[0]
    if case["strategy"] in ("dslab", "ringd"):
        return sharded._slab_geometry(cfg, H, W, shape[1])[0]
    return wtiled.tiled2d_geometry(cfg, H, W, shape[1], shape[2],
                                   case["merge_level"])[0]


def pad(images, geom):
    out = np.zeros((len(images), geom.padded_height, geom.padded_width),
                   np.float32)
    for i, img in enumerate(images):
        g = oracle.to_grayscale_f32(img)
        out[i, : g.shape[0], : g.shape[1]] = g
    return out


@pytest.fixture(scope="module")
def world():
    """Every case through a world of 4 gloo ranks, once: name -> the
    outputs of each rank."""
    names = sorted(CASES)
    per_rank = launch.spawn(launch.match_cases, 4,
                            ([case_inputs(n) for n in names],), timeout=240)
    return {n: [outs[i] for outs in per_rank] for i, n in enumerate(names)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_bitwise_to_unsharded_port(world, name):
    case = case_inputs(name)
    geom = global_geometry(case)
    cfg = case["cfg"]
    lp, rp = (torch.from_numpy(pad(case[k], geom))
              for k in ("lefts", "rights"))
    want = pipeline.apply_postfilter(pipeline.crop(
        pipeline.match_padded_core(lp, rp, cfg, geom, case["route"]), H, W),
        cfg)
    for rank, got in enumerate(world[name]):
        assert got["disparity"].shape == (2, H, W)
        assert got["disparity_raw"].dtype == np.int32
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k].numpy(),
                                          err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_jax_strategy(world, name):
    case = case_inputs(name)
    cfg, shape, strategy = jax_config(name), case["mesh"], case["strategy"]
    mesh = (jparallel.make_mesh(*shape) if len(shape) == 2
            else jparallel.make_mesh2d(*shape))
    sharding = jparallel.input_sharding(mesh, strategy)
    lefts, rights = (jax.device_put(jparallel.pad_batch(
        case[k], cfg, H, W, mesh, strategy, case["merge_level"]), sharding)
        for k in ("lefts", "rights"))
    want = jparallel.match_batch_sharded(
        lefts, rights, cfg, H, W, mesh, strategy, JAX_IMPL[case["route"]],
        case["merge_level"])
    got = world[name][0]
    for k in ("disparity_raw", "valid", "disparity_right", "disparity"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    # Fused-kernel scores (algebraic normalisation) hold 2e-5, as plain K1
    # does against the Pallas kernel (test_torch_ops.py).
    np.testing.assert_allclose(
        got["score"], np.asarray(want["score"]), rtol=1e-5,
        atol=2e-5 if case["route"] == "fused" else 1e-7)


def _rank_units(vals):
    """Rank body for the unit checks below: the collectives on a (2, 2)
    mesh, then the ring argmax on a (1, 4) mesh over 16-bin slabs of
    `vals`."""
    mesh = mesh_lib.make_mesh(2, 2)
    d, m = (mesh_lib.axis_index(mesh, a) for a in ("data", "model"))
    x = torch.full((2, 3), float(10 * d + m))
    got = {
        "ring": collectives.ppermute(x, mesh, "model", [(0, 1), (1, 0)]),
        "open": collectives.ppermute(x, mesh, "model", [(0, 1)]),
        "self": collectives.ppermute(x, mesh, "data", [(0, 0), (1, 1)]),
        "a2a": collectives.all_to_all(
            torch.stack([x + 100 * i for i in range(2)]), mesh, "model"),
        "gather": collectives.all_gather(x, mesh, "data", dim=1),
        "psum": collectives.psum(x, mesh, "model"),
        "global": collectives.gather_global(
            torch.full((1, 2), 10 * d + m), mesh, ("data", "model")),
        "replicated": collectives.gather_global(
            torch.full((1, 1), 10 * d + m) > 0, mesh, ("data", None)),
    }
    img = np.arange(90 * 140, dtype=np.uint8).reshape(90, 140)
    cfg = carry_over(Config(max_disparity=16))
    padded = sharded.pad_batch([img], cfg, 90, 140, mesh, "tiled")
    got["pad"] = torch.from_numpy(padded)
    got["pad_again"] = torch.from_numpy(sharded.pad_batch(
        [sharded.as_padded(padded[0])], cfg, 90, 140, mesh, "tiled"))
    ring = mesh_lib.make_mesh(1, 4)
    ax = mesh_lib.axis_index(ring, "model")
    v = torch.from_numpy(vals[..., 16 * ax: 16 * (ax + 1)])
    _, got["argmax"] = ringd._ring_argmax(v.amax(-1), v.argmax(-1) + 16 * ax,
                                         ring, 4)
    return d, m, {k: t.numpy() for k, t in got.items()}


@pytest.fixture(scope="module")
def units():
    rng = np.random.default_rng(0)
    # Exact ties across slabs: the ring merge must keep the smallest bin.
    vals = rng.choice(np.float32([0.1, 0.5, 0.5, 0.9]), size=(4, 8, 64))
    return vals, launch.spawn(_rank_units, 4, (vals,), timeout=120)


def test_collectives_on_four_ranks(units):
    for d, m, got in units[1]:
        me = 10 * d + m
        np.testing.assert_array_equal(got["ring"], me + 1 - 2 * m)
        np.testing.assert_array_equal(got["open"], me - 1 if m else 0)
        np.testing.assert_array_equal(got["self"], me)
        # chunk k came from model index k, which sent chunk m (+ 100 m).
        np.testing.assert_array_equal(
            got["a2a"], [np.full((2, 3), 10 * d + k + 100 * m)
                         for k in range(2)])
        np.testing.assert_array_equal(
            got["gather"], np.concatenate([np.full((2, 3), 10 * i + m)
                                           for i in range(2)], 1))
        np.testing.assert_array_equal(got["psum"], 20 * d + 1)
        np.testing.assert_array_equal(got["global"], [[0, 0, 1, 1],
                                                      [10, 10, 11, 11]])
        np.testing.assert_array_equal(got["replicated"], [[False], [True]])
        # pad_batch: grayscale-normalised, zero-padded to the tiled
        # geometry; an as_padded plane passes through untouched.
        img = np.arange(90 * 140, dtype=np.uint8).reshape(90, 140)
        assert got["pad"].shape == (1, 96, 144)
        np.testing.assert_array_equal(got["pad"][0, :90, :140],
                                      oracle.to_grayscale_f32(img))
        assert not got["pad"][0, 90:].any() and not got["pad"][0, :, 140:].any()
        np.testing.assert_array_equal(got["pad_again"], got["pad"])


def test_ring_argmax_matches_flat_argmax(units):
    vals, per_rank = units
    for _, _, got in per_rank:
        np.testing.assert_array_equal(got["argmax"], np.argmax(vals, -1))


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        launch.spawn(operator.truediv, 2, (1, 0), timeout=60)
