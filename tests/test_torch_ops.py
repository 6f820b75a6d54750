"""PyTorch port's ops vs the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  On
a CPU tensor each kernel wrapper of the port runs its plain PyTorch
version, so these tests hold the plain K1/K2/K3 (and the stock-op
modules around them) to the JAX functions; the JAX side runs its Pallas
kernels in interpreter mode, as its own tests do.  Tolerances: 1e-6 for
patch descriptors and cost volumes (f32 sums in another order), 1e-5 for
grad_hist descriptors (the oracle's own contract), bitwise for gradients,
orientation bins, pools, pool offsets and pyramid decisions, rtol 1e-5
for maps through x**1.4 (pow is not bitwise across libraries), 2e-5 for
fused-kernel scores and the image->volume kernel (algebraic
normalisation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.models import descriptors as jdesc
from deepmatching_stereo_matching_tpu.models import pipeline as jpipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu.ops import costvol as jcostvol
from deepmatching_stereo_matching_tpu.ops import costvol_pallas
from deepmatching_stereo_matching_tpu.ops import fused_pallas
from deepmatching_stereo_matching_tpu.ops import pool as jpool
from deepmatching_stereo_matching_tpu.ops import pyramid_pallas
from deepmatching_stereo_matching_tpu_torch.config import Geometry, carry_over
from deepmatching_stereo_matching_tpu_torch.models import descriptors
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import (
    costvol, costvol_cuda, fused_cuda, pool, pyramid_cuda)


def t(x):
    return torch.from_numpy(np.array(x))


def rand_pair(rng, hp, wp):
    l = (rng.standard_normal((hp, wp)).astype(np.float32) * 0.3 + 0.5)
    r = (rng.standard_normal((hp, wp)).astype(np.float32) * 0.3 + 0.5)
    return l, r


# ---------------------------------------------------------------------------
# Descriptors and the cost volume
# ---------------------------------------------------------------------------


def test_descriptors_match_jax():
    rng = np.random.default_rng(0)
    cfg = Config(max_disparity=16)
    img = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    for fn in ("left_descriptors", "right_sliding_descriptors"):
        want = np.asarray(getattr(jdesc, fn)(jnp.asarray(img), cfg))
        got = getattr(descriptors, fn)(t(img), carry_over(cfg)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


def _gradient_images():
    rng = np.random.default_rng(11)
    smooth = rng.uniform(0, 1, (2, 20, 24)).astype(np.float32)
    # Quantised intensities give zero and equal |gx|, |gy|: the binning's
    # tie branches.
    steps = (rng.integers(0, 3, (2, 20, 24)) * 0.25).astype(np.float32)
    return {"smooth": smooth, "steps": steps}


@pytest.mark.parametrize("kind", ["smooth", "steps"])
def test_gradient_and_magbin_bitwise(kind):
    imgs = _gradient_images()[kind]
    for axis in (0, 1):
        want = np.gradient(imgs[0], axis=axis)
        np.testing.assert_array_equal(
            descriptors._gradient_1d(t(imgs[0]), axis).numpy(), want)
        np.testing.assert_array_equal(
            descriptors._gradient_1d(t(imgs[0]), axis).numpy(),
            np.asarray(jdesc._gradient_1d(jnp.asarray(imgs[0]), axis)))
    mag, idx = descriptors.grad_hist_magbin(t(imgs))      # batched
    for b in range(2):
        jm, ji = jdesc.grad_hist_magbin(jnp.asarray(imgs[b]))
        np.testing.assert_array_equal(mag[b].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        hist = descriptors.grad_hist_pixels(t(imgs[b])).numpy()
        np.testing.assert_array_equal(
            hist, np.asarray(jdesc.grad_hist_pixels(jnp.asarray(imgs[b]))))
        np.testing.assert_array_equal(hist, oracle._grad_hist_pixels(imgs[b]))
    if kind == "steps":
        assert len(np.unique(idx.numpy())) == 8


def test_grad_hist_descriptors_match_jax_and_oracle():
    rng = np.random.default_rng(5)
    cfg = Config(max_disparity=16, descriptor="grad_hist")
    img = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    for fn in ("left_descriptors", "right_sliding_descriptors"):
        got = getattr(descriptors, fn)(t(img), carry_over(cfg)).numpy()
        assert got.shape[-1] == 4 * 4 * 8
        for want in (np.asarray(getattr(jdesc, fn)(jnp.asarray(img), cfg)),
                     getattr(oracle, fn)(img, cfg)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5)


def _desc_pair(seed, h0=8, w0=16, p=4):
    rng = np.random.default_rng(seed)
    cfg = Config(max_disparity=16)
    l, r = rand_pair(rng, h0 * p, w0 * p)
    src = np.asarray(jdesc.left_descriptors(jnp.asarray(l), cfg))
    tgt = np.asarray(jdesc.right_sliding_descriptors(jnp.asarray(r), cfg))
    return src, tgt


@pytest.mark.parametrize("reverse,origin_offset,max_d", [
    (False, 0, 16), (True, 0, 16), (False, 0, 13), (False, 2, 16),
])
def test_cost_volume_matches_jax(reverse, origin_offset, max_d):
    src, tgt = _desc_pair(2)
    if origin_offset:
        tgt = np.concatenate(
            [np.zeros((tgt.shape[0], 4 * origin_offset, tgt.shape[2]),
                      np.float32), tgt], axis=1)
    want = np.asarray(jcostvol.cost_volume(
        jnp.asarray(src), jnp.asarray(tgt), 16, 4, max_d, reverse=reverse,
        origin_offset=origin_offset))
    got = costvol.cost_volume(t(src), t(tgt), 16, 4, max_d, reverse=reverse,
                              origin_offset=origin_offset).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("reverse,max_d", [(False, 16), (True, 16),
                                           (False, 11)])
def test_plain_costvol_kernel_matches_pallas(reverse, max_d):
    """Plain K2 vs costvol_pallas.cost_volume_dmajor, with a batch dim."""
    src, tgt = _desc_pair(3)
    want = np.asarray(costvol_pallas.cost_volume_dmajor(
        jnp.asarray(src), jnp.asarray(tgt), 16, 4, max_d, reverse=reverse))
    got = costvol_cuda.cost_volume_dmajor(
        t(np.stack([src, src])), t(np.stack([tgt, tgt])), 16, 4, max_d,
        reverse=reverse).numpy()
    assert got.shape == (2,) + want.shape
    np.testing.assert_allclose(got[0], want, atol=1e-6)
    np.testing.assert_array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# Pools
# ---------------------------------------------------------------------------


def _tie_volume(rng, shape):
    return (rng.integers(0, 3, size=shape).astype(np.float32) * 0.5)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_pool3_subsample_bitwise(kind):
    rng = np.random.default_rng(4)
    shape = (4, 6, 16)
    maps = (_tie_volume(rng, shape) if kind == "ties" else
            rng.uniform(0, 1, shape).astype(np.float32))
    wp, wa = jpool.pool3_subsample(jnp.asarray(maps))
    gp, ga = pool.pool3_subsample(t(maps))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    dm = np.ascontiguousarray(maps.transpose(2, 0, 1))
    wp, wa = jpool.pool3_subsample_dmajor(jnp.asarray(dm))
    gp, ga = pool.pool3_subsample_dmajor(t(dm))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_aggregate_children_matches_jax():
    rng = np.random.default_rng(6)
    sub = rng.uniform(0, 1, (8, 12, 5)).astype(np.float32)
    want = np.asarray(jpool.aggregate_children(jnp.asarray(sub), 1.4))
    got = pool.aggregate_children(t(sub), 1.4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    dm = np.ascontiguousarray(sub.transpose(2, 0, 1))
    want = np.asarray(jpool.aggregate_children_dmajor(jnp.asarray(dm), 1.4))
    got = pool.aggregate_children_dmajor(t(dm), 1.4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# K3: pyramid + backtracking
# ---------------------------------------------------------------------------


def _pyramid_both(cost_hwd, levels):
    cost_dm = np.ascontiguousarray(cost_hwd.transpose(2, 0, 1))
    wd, ws = pyramid_pallas.pyramid_backtrack(jnp.asarray(cost_dm), levels,
                                              1.4)
    gd, gs = pyramid_cuda.pyramid_backtrack(t(cost_dm), levels, 1.4)
    assert gd.dtype == torch.int32 and gs.dtype == torch.float32
    return (np.asarray(wd), np.asarray(ws)), (gd.numpy(), gs.numpy())


@pytest.mark.parametrize("levels,h0,w0,d0", [
    (1, 2, 2, 2), (2, 4, 8, 8), (3, 8, 16, 16), (4, 16, 32, 64),
])
def test_plain_pyramid_kernel_random(levels, h0, w0, d0):
    rng = np.random.default_rng(levels)
    cost = np.maximum(rng.standard_normal((h0, w0, d0)), 0.0).astype(np.float32)
    (wd, ws), (gd, gs) = _pyramid_both(cost, levels)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gs, ws)


def test_plain_pyramid_kernel_tie_heavy():
    cost = _tie_volume(np.random.default_rng(7), (8, 16, 16))
    (wd, ws), (gd, gs) = _pyramid_both(cost, 3)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gs, ws)


def test_plain_pyramid_kernel_all_zero():
    (wd, ws), (gd, gs) = _pyramid_both(np.zeros((4, 8, 8), np.float32), 2)
    np.testing.assert_array_equal(gd, wd)
    assert not gd.any()
    np.testing.assert_array_equal(gs, ws)


def test_pyramid_fast_mode_same_decisions():
    """Deferred rectification (the fused kernel's mode) picks the exact
    mode's winners on non-degenerate data."""
    rng = np.random.default_rng(8)
    cost = t(np.maximum(rng.standard_normal((2, 16, 16, 32)), 0.0
                        ).astype(np.float32))
    ed, es = pyramid_cuda.pyramid_body(cost, 3, 1.4, fast=False)
    fd, fs = pyramid_cuda.pyramid_body(cost, 3, 1.4, fast=True)
    np.testing.assert_array_equal(fd.numpy(), ed.numpy())
    np.testing.assert_array_equal(fs.numpy(), es.numpy())


def test_pyramid_misaligned_rejected():
    with pytest.raises(ValueError, match="not aligned"):
        pyramid_cuda.pyramid_backtrack(torch.zeros(8, 6, 10), 2, 1.4)


def test_kernel_coverage_gates_new_paths():
    """KITTI at D=128/256 needs the large-D route (K1 and K3 tiles do not
    fit a block; K4's fixed tile does); grad_hist at the bench geometry
    runs K1b, whose block holds the bin planes too (K4b's block would fit
    there as well, but K1b comes first)."""
    for max_d in (128, 256):
        cfg = carry_over(Config(max_disparity=max_d))
        geom = cfg.geometry(375, 1242)
        assert (geom.levels, geom.grid_h, geom.grid_w, geom.disparities) \
            == (5, 96, 384, max_d)
        assert not fused_cuda.supported(cfg, geom)
        assert not pyramid_cuda.supported(geom.disparities, geom.levels)
        assert fused_cuda.cost_supported(cfg, geom)
    assert fused_cuda.cost_route_bytes(4, 256) == 78592
    assert fused_cuda.cost_smem_bytes(4, 256) == 78848
    gh = carry_over(Config(max_disparity=64, descriptor="grad_hist"))
    geom = gh.geometry(375, 450)
    assert fused_cuda.supported(gh, geom)
    assert fused_cuda.cost_supported(gh, geom)
    assert fused_cuda.smem_bytes(4, 64, 64, 4) == 72992
    assert fused_cuda.smem_bytes(4, 64, 64, 4, magbin=True) == 86304


def test_kernel_coverage_gates():
    assert pyramid_cuda.supported(64, 4)
    assert not pyramid_cuda.supported(192, 5)   # KITTI large-D tile
    cfg = carry_over(Config(max_disparity=64))
    assert fused_cuda.supported(cfg, cfg.geometry(375, 450))
    assert not fused_cuda.supported(
        carry_over(Config(max_disparity=64, center_descriptors=True)),
        cfg.geometry(375, 450))
    big = carry_over(Config(max_disparity=192))
    assert not fused_cuda.supported(big, big.geometry(375, 1242))


# ---------------------------------------------------------------------------
# K1: the fused image->disparity kernel
# ---------------------------------------------------------------------------


def _geom(h0, w0, p, d0, levels):
    return Geometry(height=h0 * p, width=w0 * p, levels=levels,
                    padded_height=h0 * p, padded_width=w0 * p, grid_h=h0,
                    grid_w=w0, disparities=d0)


def _fused_both(left, right, max_d, levels, p=4):
    h0, w0 = left.shape[0] // p, left.shape[1] // p
    unit = 2 ** levels
    d0 = ((max_d + unit - 1) // unit) * unit
    cfg = Config(max_disparity=max_d, levels=levels)
    wd, ws = fused_pallas._match_rows(
        jnp.asarray(left), jnp.asarray(right), p, d0, max_d, levels, cfg.lam,
        fused_pallas.dot_precision(cfg), "float32",
        fused_pallas.use_interpret())
    gd, gs = fused_cuda.match_planes(t(left), t(right), carry_over(cfg),
                                     _geom(h0, w0, p, d0, levels))
    return (np.asarray(wd), np.asarray(ws)), (gd.numpy(), gs.numpy())


@pytest.mark.parametrize("h0,w0,max_d,levels", [
    (8, 16, 16, 2),
    (16, 16, 16, 2),
    (16, 24, 13, 2),
    (32, 48, 32, 3),
])
def test_plain_fused_kernel_matches_pallas(h0, w0, max_d, levels):
    rng = np.random.default_rng(h0 + w0 + max_d)
    left, right = rand_pair(rng, h0 * 4, w0 * 4)
    (wd, ws), (gd, gs) = _fused_both(left, right, max_d, levels)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_allclose(gs, ws, atol=2e-5)


def test_plain_fused_left_edge_out_of_range_zero():
    """Patches with p*j < d never win with a nonzero out-of-range score:
    decisions equal the Pallas kernel's on an 8x8-patch pair."""
    rng = np.random.default_rng(7)
    left, right = rand_pair(rng, 32, 32)
    (wd, ws), (gd, gs) = _fused_both(left, right, 16, 2)
    np.testing.assert_array_equal(gd, wd)
    cfg = carry_over(Config(max_disparity=16, levels=2))
    vol = fused_cuda.cost_volume_torch(t(left), t(right), cfg,
                                       _geom(8, 8, 4, 16, 2)).numpy()
    jj = np.arange(8)
    for d in range(16):
        assert not vol[d][:, 4 * jj < d].any()


def test_plain_fused_batched_equals_single():
    rng = np.random.default_rng(9)
    cfg = carry_over(Config(max_disparity=16, levels=2))
    geom = _geom(8, 16, 4, 16, 2)
    pairs = [rand_pair(rng, 32, 64) for _ in range(3)]
    lb = t(np.stack([l for l, _ in pairs]))
    rb = t(np.stack([r for _, r in pairs]))
    bd, bs = fused_cuda.match_planes(lb, rb, cfg, geom)
    for i, (l, r) in enumerate(pairs):
        d, s = fused_cuda.match_planes(t(l), t(r), cfg, geom)
        np.testing.assert_array_equal(bd[i].numpy(), d.numpy())
        np.testing.assert_array_equal(bs[i].numpy(), s.numpy())


@pytest.mark.parametrize("kind", ["patch", "grad_hist"])
def test_plain_fused_magbin_matches_pallas(kind):
    """Plain K1b (and K1 on the same pair), as `pipeline.one_direction`
    runs it on the padded images, vs fused_pallas.match_rows in interpret
    mode, at the JAX package's magbin test geometry."""
    h, w, max_d = 96, 128, 16
    cfg = Config(max_disparity=max_d, descriptor=kind)
    geom = cfg.geometry(h, w)
    rng = np.random.default_rng(12)
    field = synthetic.block_disparity_field(h, w, max_d, rng, block=16)
    left, right, _ = synthetic.make_pair(h, w, field, seed=12)
    lp = oracle.pad_image(oracle.to_grayscale_f32(left), geom)
    rp = oracle.pad_image(oracle.to_grayscale_f32(right), geom)
    wd, ws = fused_pallas.match_rows(jnp.asarray(lp), jnp.asarray(rp), cfg,
                                     geom)
    pcfg = carry_over(cfg)
    pgeom = pcfg.geometry(h, w)
    assert fused_cuda.supported(pcfg, pgeom)
    gd, gs = pipeline.one_direction(t(lp), t(rp), pcfg, pgeom, "fused")
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-5)


def _cost_rows_pair(h, w, max_d, levels, seed):
    cfg = Config(max_disparity=max_d, levels=levels)
    geom = cfg.geometry(h, w)
    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(h, w, max_d, rng, block=16)
    left, right, _ = synthetic.make_pair(h, w, field, seed=seed)
    lp = oracle.pad_image(oracle.to_grayscale_f32(left), geom)
    rp = oracle.pad_image(oracle.to_grayscale_f32(right), geom)
    return cfg, geom, lp, rp


@pytest.mark.parametrize("h,w,max_d,levels", [(96, 128, 24, 2),
                                              (64, 128, 13, 3)])
def test_plain_cost_rows_matches_pallas(h, w, max_d, levels):
    """Plain K4 vs fused_pallas.cost_volume_rows (interpret mode)."""
    cfg, geom, lp, rp = _cost_rows_pair(h, w, max_d, levels, 4)
    assert fused_pallas.cost_supported(cfg, geom)
    pcfg = carry_over(cfg)
    pgeom = pcfg.geometry(h, w)
    assert fused_cuda.cost_supported(pcfg, pgeom)
    want = np.asarray(fused_pallas.cost_volume_rows(
        jnp.asarray(lp), jnp.asarray(rp), cfg, geom))
    got = fused_cuda.cost_volume_rows(t(np.stack([lp, rp])),
                                      t(np.stack([rp, lp])), pcfg, pgeom)
    assert got.shape == (2,) + want.shape
    np.testing.assert_allclose(got[0].numpy(), want, atol=2e-5)
    assert not got[0, max_d:].any()


def _volume(seed, d, h0, w0):
    rng = np.random.default_rng(seed)
    return np.maximum(rng.standard_normal((d, h0, w0)), 0.0
                      ).astype(np.float32)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("levels,d,h0,w0", [(2, 64, 16, 32), (3, 64, 16, 32),
                                            (5, 64, 32, 32)])
def test_plain_aggregate_matches_slabs(levels, d, h0, w0, fast):
    """Plain K5 vs pyramid_pallas.aggregate_slabs: JAX keeps every level
    at full resolution (duplicated cells), so its maps are subsampled by
    2**l; its bf16 offsets are cast to int."""
    cost = _volume(levels + d, d, h0, w0)
    wtop, wargs = pyramid_pallas.aggregate_slabs(jnp.asarray(cost), levels,
                                                 1.4, fast=fast)
    gtop, gargs = pyramid_cuda.aggregate_dmajor(t(np.stack([cost, cost])),
                                                levels, 1.4, fast=fast)
    s = 2 ** levels
    assert gtop.shape == (2, d // s, h0 // s, w0 // s)
    np.testing.assert_allclose(gtop[0].numpy(),
                               np.asarray(wtop)[:, ::s, ::s], rtol=1e-5)
    np.testing.assert_array_equal(gtop[0].numpy(), gtop[1].numpy())
    assert len(gargs) == levels
    for lvl, (ga, wa) in enumerate(zip(gargs, wargs)):
        assert ga.dtype == torch.int8
        sl = 2 ** lvl
        np.testing.assert_array_equal(
            ga[0].numpy(),
            np.asarray(wa.astype(jnp.int32))[:, ::sl, ::sl])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("levels,d,h0,w0", [(2, 64, 16, 32),
                                            (5, 64, 32, 32)])
def test_match_dmajor_matches_xla(levels, d, h0, w0, fast):
    cost = _volume(7 * levels, d, h0, w0)
    wk, ws = jpipeline.match_dmajor_xla(jnp.asarray(cost), levels, 1.4,
                                        fast=fast)
    gk, gs = pipeline.match_dmajor(t(cost), levels, 1.4, fast=fast)
    assert gk.dtype == torch.int32 and gk.shape == (h0, w0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5)
    # The same volume through K3's plain version (its tile fits at these
    # sizes) picks the same winners.
    kd, _ = pyramid_cuda.pyramid_body(t(cost), levels, 1.4, fast=fast)
    np.testing.assert_array_equal(kd.numpy(), gk.numpy())


def test_descend_d_minor_equals_d_major():
    cost = t(np.stack([_volume(s, 16, 8, 8) for s in (1, 2)]))
    top, args = pyramid_cuda.aggregate_dmajor_torch(cost, 2, 1.4)
    k = t(np.random.default_rng(3).integers(0, top.shape[-3], (2, 2, 2)))
    dmajor = pyramid_cuda.descend(k, args)
    dminor = pipeline.backtrack_from(
        k, [a.movedim(-3, -1).contiguous() for a in args], dim=-1)
    np.testing.assert_array_equal(dmajor.numpy(), dminor.numpy())
    assert dmajor.shape == (2, 8, 8)
    assert 0 <= int(dmajor.min()) and int(dmajor.max()) < 16


# ---------------------------------------------------------------------------
# What the sharded strategies add: K6 slabs, pool halos, halo descriptors,
# the post-filter
# ---------------------------------------------------------------------------


def _halo_pair(seed, halo_q):
    """Descriptors with the target extended by halo_q zero patch columns
    on each side, as a W-tile carries them."""
    src, tgt = _desc_pair(seed)
    z = np.zeros((tgt.shape[0], 4 * halo_q, tgt.shape[2]), np.float32)
    return src, np.concatenate([z, tgt, z], axis=1)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("d_local,d_offset", [(16, 0), (8, 0), (8, 8),
                                              (4, 12)])
def test_plain_slab_kernel_matches_pallas_slab(reverse, d_local, d_offset):
    """Plain K6 on a patch-aligned slab vs costvol_pallas.cost_volume_slab
    and costvol.cost_volume(d_offset=) (max_d 13: the last slab holds
    masked bins), with a batch dim."""
    src, tgt = _desc_pair(5)
    args = (d_local, 4, 13)
    want = np.asarray(costvol_pallas.cost_volume_slab(
        jnp.asarray(src), jnp.asarray(tgt), *args, reverse=reverse,
        d_offset=d_offset))
    ref = np.asarray(jcostvol.cost_volume(
        jnp.asarray(src), jnp.asarray(tgt), *args, reverse=reverse,
        d_offset=d_offset))
    rows = costvol_cuda.cost_volume_rows(
        t(np.stack([src, src])), t(np.stack([tgt, tgt])), *args,
        reverse=reverse, d_offset=d_offset)
    assert rows.shape == (2, 8, d_local, 16)
    got = costvol_cuda.cost_volume(t(src), t(tgt), *args, reverse=reverse,
                                   d_offset=d_offset).numpy()
    np.testing.assert_array_equal(got, rows[1].transpose(-1, -2).numpy())
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("d_local,d_offset", [(2, 0), (2, 6), (6, 10)])
def test_plain_slab_kernel_unaligned_slab(reverse, d_local, d_offset):
    """Slabs that are not a multiple of the patch size (the Pallas slab
    kernel raises on them) vs costvol.cost_volume(d_offset=)."""
    src, tgt = _desc_pair(6)
    want = np.asarray(jcostvol.cost_volume(
        jnp.asarray(src), jnp.asarray(tgt), d_local, 4, 16, reverse=reverse,
        d_offset=d_offset))
    got = costvol_cuda.cost_volume(t(src), t(tgt), d_local, 4, 16,
                                   reverse=reverse, d_offset=d_offset)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_slab_kernel_halo_target(reverse):
    """K6 on a halo-extended target (origin_offset = halo_q) vs
    costvol_pallas.cost_volume and costvol.cost_volume."""
    halo_q = 4
    src, tgt = _halo_pair(7, halo_q)
    args = (16, 4, 16)
    want = np.asarray(costvol_pallas.cost_volume(
        jnp.asarray(src), jnp.asarray(tgt), *args, reverse=reverse,
        origin_offset=halo_q))
    ref = np.asarray(jcostvol.cost_volume(
        jnp.asarray(src), jnp.asarray(tgt), *args, reverse=reverse,
        origin_offset=halo_q))
    got = costvol_cuda.cost_volume(t(src), t(tgt), *args, reverse=reverse,
                                   origin_offset=halo_q).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_slabs_concatenate_to_dmajor_volume_bitwise(reverse):
    """Four K6 slabs, concatenated along D, are K2's D-major volume bit
    for bit (the sharded strategies' bitwise contract rests on it)."""
    src, tgt = _desc_pair(8)
    whole = costvol_cuda.cost_volume_dmajor(t(src), t(tgt), 16, 4, 13,
                                            reverse=reverse)
    slabs = [costvol_cuda.cost_volume_rows(t(src), t(tgt), 4, 4, 13,
                                           reverse=reverse, d_offset=4 * k)
             for k in range(4)]
    joined = torch.cat(slabs, dim=-2).movedim(-2, -3)
    np.testing.assert_array_equal(joined.numpy(), whole.numpy())


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_pool3_subsample_lo_pad_bitwise(kind):
    """The halo plane replaces the -1 pad, in both layouts, and a slab
    pooled with its predecessor's last odd plane equals the unsharded
    pool's half."""
    rng = np.random.default_rng(9)
    shape = (4, 6, 16)
    maps = (_tie_volume(rng, shape) if kind == "ties" else
            rng.uniform(0, 1, shape).astype(np.float32))
    halo = maps[:, :, 7]
    wp, wa = jpool.pool3_subsample(jnp.asarray(maps[..., 8:]),
                                   lo_pad=jnp.asarray(halo))
    gp, ga = pool.pool3_subsample(t(maps[..., 8:]), lo_pad=t(halo))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    fp, fa = pool.pool3_subsample(t(maps))
    np.testing.assert_array_equal(gp.numpy(), fp[..., 4:].numpy())
    np.testing.assert_array_equal(ga.numpy(), fa[..., 4:].numpy())
    dm = np.ascontiguousarray(maps[..., 8:].transpose(2, 0, 1))
    wp, wa = jpool.pool3_subsample_dmajor(jnp.asarray(dm),
                                          lo_pad=jnp.asarray(halo))
    gp, ga = pool.pool3_subsample_dmajor(t(dm), lo_pad=t(halo))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
@pytest.mark.parametrize("col0,width_global", [(0, None), (-8, 32),
                                               (12, 48), (-3, 20)])
def test_sliding_descriptors_global_window(descriptor, col0, width_global):
    """The global-window mask zeroes exactly JAX's windows; values hold
    JAX at 1e-6 (normalisation sums in another order), and a slab cut
    from a wider map with its col0 gives the wide map's descriptors bit
    for bit wherever its window lies inside the slab."""
    rng = np.random.default_rng(10)
    cfg = Config(max_disparity=16, descriptor=descriptor)
    f = 1 if descriptor == "patch" else 8
    feat = rng.uniform(0, 1, (16, 40, f)).astype(np.float32)
    want = np.asarray(jdesc.sliding_descriptors(
        jnp.asarray(feat), cfg, col0=col0, width_global=width_global))
    got = descriptors.sliding_descriptors(t(feat), carry_over(cfg), col0=col0,
                                          width_global=width_global).numpy()
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1))
    np.testing.assert_allclose(got, want, atol=1e-6)
    wide = np.zeros((16, 80, f), np.float32)
    wide[:, 20:60] = feat
    whole = descriptors.sliding_descriptors(
        t(wide), carry_over(cfg), col0=col0 - 20,
        width_global=width_global or 40).numpy()
    inside = slice(20, 20 + 40 - 3)
    np.testing.assert_array_equal(got[:, : 40 - 3], whole[:, inside])


def _postfilter_maps():
    rng = np.random.default_rng(13)
    disp = rng.integers(0, 16, (2, 12, 17)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.3] = np.nan
    disp[0, 3, :] = np.nan                  # a row with nothing valid
    disp[1, :, 5] = np.inf
    return disp


@pytest.mark.parametrize("fn,args", [
    ("median_valid", (3, True)), ("median_valid", (3, False)),
    ("median_valid", (5, True)), ("fill_background", ()),
    ("postfilter", (3, True)), ("postfilter", (5, False)),
    ("postfilter", (0, True)),
])
def test_postfilter_bitwise(fn, args):
    """Batched torch post-filter == JAX's and the oracle's, per map."""
    from deepmatching_stereo_matching_tpu.ops import postfilter as jpost
    from deepmatching_stereo_matching_tpu_torch.ops import postfilter as post

    disp = _postfilter_maps()
    got = getattr(post, fn)(t(disp), *args).numpy()
    assert got.shape == disp.shape and got.dtype == np.float32
    for b in range(2):
        for want in (np.asarray(getattr(jpost, fn)(jnp.asarray(disp[b]),
                                                   *args)),
                     getattr(oracle, fn)(disp[b], *args)):
            np.testing.assert_array_equal(got[b], want)
