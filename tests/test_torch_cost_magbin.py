"""K4b, the cost-volume kernel on grad_hist (magnitude, bin) planes, on the
CPU: its plain version and the `fused` large-D step it serves against the
NumPy oracle, its routing, its work model, and the benchmark's readings of
it (csrc/costrows.cu runs only on the card: tests/
test_torch_cost_magbin_card.py holds it to this plain version there).

Tolerances, each with its reason:
  * the float32 volume within 1e-6 of the oracle's: the plain version
    normalises algebraically, relu(raw * invL * invR), where the oracle
    normalises each 128-wide descriptor and then takes the dot, so the two
    differ by rounding alone, a few float32 ulps of costs in [0, 1]
    (2.98e-7 measured); a bfloat16 volume is off by up to 2^-9 and fails
    it;
  * the bfloat16 volume is the float32 volume rounded, bitwise (the
    kernel rounds each float32 cost once as it stores it), and so within
    2^-9 + 1e-6 of the oracle;
  * the step: decisions, LR validity and right disparities each off the
    oracle on at most 0.5% of pixels (the port's gate for the fused
    routes: the fast power and the algebraic norms may flip a near-tie),
    and scores within 2e-5 where the decision agrees (the level-0 cost,
    as above, with headroom for the aggregation's rounding); the same
    step in bfloat16 fails the score bound.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu import Config as JConfig
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.config import Config, carry_over
from deepmatching_stereo_matching_tpu_torch.models import (descriptors,
                                                           pipeline)
from deepmatching_stereo_matching_tpu_torch.ops import (_build, costvol_cuda,
                                                        fused_cuda,
                                                        pyramid_cuda)
from stereobench import harness, k4b as bench_k4b
from stereobench import reference as frozen
from stereobench import tracing
from stereobench import work as bench_work

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLUME_ATOL = 1e-6
BF16_HALF_ULP = 2.0 ** -9        # of a cost in [0, 1]
FUSED_DECISION_TOL = 0.005
SCORE_ATOL = 2e-5
# A grad_hist configuration past K1b's block at a CPU size: L = 5 puts
# the whole 128-bin level-0 tile of a 32 x 32-patch quadtree in one block.
LARGE_D = (JConfig(max_disparity=128, levels=5, descriptor="grad_hist"),
           128, 128, 48)
# (height, width, Config fields): ragged patch grids and tiles, a masked
# plane (max_disparity < D0), the p = 4 and runtime-p instances.
VOLUME_CASES = {
    "p4_ragged": (48, 100, dict(max_disparity=37, levels=2)),
    "p3": (36, 75, dict(max_disparity=22, levels=2, patch_size=3)),
    "p5_l1": (30, 80, dict(max_disparity=17, levels=1, patch_size=5)),
}


def pair(seed, h, w, field_d):
    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(h, w, field_d, rng, block=16)
    return synthetic.make_pair(h, w, field, seed=seed)


def padded(img, cfg, geom):
    return oracle.pad_image(oracle.to_grayscale_f32(img), geom)


def oracle_volume(lp, rp, cfg, geom):
    """The oracle's (D0, H0, W0) grad_hist cost volume of padded planes."""
    vol = oracle.cost_volume(oracle.left_descriptors(lp, cfg),
                             oracle.right_sliding_descriptors(rp, cfg),
                             geom.disparities, cfg.patch_size,
                             cfg.max_disparity)
    return vol.transpose(2, 0, 1)


def magbin(*planes):
    out = []
    for x in planes:
        out += descriptors.grad_hist_magbin(torch.from_numpy(x))
    return out


@pytest.mark.parametrize("case", sorted(VOLUME_CASES))
def test_plain_k4b_matches_the_oracle(case):
    h, w, fields = VOLUME_CASES[case]
    cfg = JConfig(descriptor="grad_hist", **fields)
    pcfg = carry_over(cfg)
    geom = pcfg.geometry(h, w)
    assert fused_cuda.cost_supported(pcfg, geom)
    left, right, _ = pair(3, h, w, fields["max_disparity"])
    lp, rp = padded(left, cfg, geom), padded(right, cfg, geom)
    want = oracle_volume(lp, rp, cfg, geom)
    lm, lb, rm, rb = magbin(lp, rp)
    got = fused_cuda.cost_volume_rows(lm, rm, pcfg, geom, lb, rb)
    assert got.dtype == torch.float32
    assert got.shape == (geom.disparities, geom.grid_h, geom.grid_w)
    err = np.abs(got.numpy() - want)
    assert err.max() <= VOLUME_ATOL, err.max()
    assert not got[fields["max_disparity"]:].any()   # masked planes

    p16 = dataclasses.replace(pcfg, dtype="bfloat16")
    got16 = fused_cuda.cost_volume_rows(lm, rm, p16, geom, lb, rb)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))
    err16 = np.abs(got16.float().numpy() - want)
    assert err16.max() <= BF16_HALF_ULP + VOLUME_ATOL
    assert err16.max() > VOLUME_ATOL          # the f32 bound catches bf16


def test_bin_planes_come_exactly_with_grad_hist():
    cfg = Config(max_disparity=16, levels=2, descriptor="grad_hist")
    geom = cfg.geometry(32, 64)
    planes = torch.rand(4, geom.padded_height, geom.padded_width)
    with pytest.raises(ValueError, match="bin planes"):
        fused_cuda.cost_volume_rows(planes[0], planes[1], cfg, geom)
    with pytest.raises(ValueError, match="bin planes"):
        fused_cuda.cost_volume_rows(
            planes[0], planes[1], dataclasses.replace(cfg, descriptor="patch"),
            geom, planes[2], planes[3])
    with pytest.raises(ValueError, match="shapes differ"):
        fused_cuda.cost_volume_rows(planes[0], planes[1], cfg, geom,
                                    planes[2], planes[3][:, :8])


def _step(cfg, pairs, h, w):
    pcfg = carry_over(cfg)
    geom = pcfg.geometry(h, w)
    lb, rb = (torch.from_numpy(np.stack([padded(p[j], cfg, geom)
                                         for p in pairs])) for j in (0, 1))
    return pipeline.crop(pipeline.match_padded_core(lb, rb, pcfg, geom,
                                                    "fused"), h, w)


def test_fused_step_matches_the_oracle():
    """The whole `fused` step (planes, K4b, K5 fast, the walk, the LR
    check) on a grad_hist large-D geometry, two pairs at once, against
    `oracle.match_stereo`; the bfloat16 step fails the score bound."""
    cfg, h, w, field_d = LARGE_D
    pcfg = carry_over(cfg)
    geom = pcfg.geometry(h, w)
    assert (geom.levels, geom.disparities) == (5, 128)
    assert not fused_cuda.supported(pcfg, geom)
    assert not pyramid_cuda.supported(geom.disparities, geom.levels)
    assert fused_cuda.cost_supported(pcfg, geom)
    pairs = [pair(s, h, w, field_d)[:2] for s in (5, 6)]
    out = _step(cfg, pairs, h, w)
    out16 = _step(dataclasses.replace(cfg, dtype="bfloat16"), pairs, h, w)
    err16 = 0.0
    for i, (left, right) in enumerate(pairs):
        want = oracle.match_stereo(left, right, cfg)
        for k in ("disparity_raw", "valid", "disparity_right"):
            rate = np.mean(out[k][i].numpy() != getattr(want, k))
            assert rate <= FUSED_DECISION_TOL, (k, rate)
        same = out["disparity_raw"][i].numpy() == want.disparity_raw
        assert same.mean() > 0.99
        err = np.abs(out["score"][i].numpy() - want.score)[same]
        assert err.max() <= SCORE_ATOL, err.max()
        same16 = out16["disparity_raw"][i].numpy() == want.disparity_raw
        err16 = max(err16, float(np.abs(out16["score"][i].numpy()
                                        - want.score)[same16].max()))
    assert err16 > SCORE_ATOL, err16


def _spy(monkeypatch):
    seen = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            tag = name
            if name in ("cost_volume_rows", "match_planes"):
                tag += "(magbin)" if len(a) > 4 else "(patch)"
            seen.append(tag)
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(fused_cuda, "match_planes")
    spy(fused_cuda, "cost_volume_rows")
    spy(costvol_cuda, "cost_volume_dmajor")
    spy(pyramid_cuda, "pyramid_backtrack")
    spy(pyramid_cuda, "aggregate_dmajor")
    spy(descriptors, "grad_hist_magbin")
    return seen


@pytest.mark.parametrize("name,cfg,hw,called", [
    ("grad_hist_large_d", LARGE_D[0], (128, 128),
     ["grad_hist_magbin"] * 2 + ["cost_volume_rows(magbin)",
                                 "aggregate_dmajor"]),
    ("patch_large_d", JConfig(max_disparity=128, levels=5), (128, 128),
     ["cost_volume_rows(patch)", "aggregate_dmajor"]),
    ("grad_hist_k1b", JConfig(max_disparity=16, descriptor="grad_hist"),
     (48, 64), ["grad_hist_magbin"] * 2 + ["match_planes(magbin)"]),
    ("patch_k1", JConfig(max_disparity=16), (48, 64),
     ["match_planes(patch)"]),
    ("grad_hist_centred", JConfig(max_disparity=128, levels=5,
                                  descriptor="grad_hist",
                                  center_descriptors=True), (128, 128),
     ["cost_volume_dmajor", "aggregate_dmajor"]),
])
def test_routes(monkeypatch, name, cfg, hw, called):
    """grad_hist past K1b's block builds its planes and takes K4b (then
    K5, no K2); patch past K1 takes K4; where K1/K1b cover the
    configuration they still take it; centred grad_hist keeps the
    descriptor route."""
    seen = _spy(monkeypatch)
    h, w = hw
    left, right, _ = pair(1, h, w, 16)
    _step(cfg, [(left, right)], h, w)
    assert seen == called


def test_kitti_routes():
    """KITTI at D=128 and 256: both descriptors take the large-D fused
    route, K4 or K4b, in either dtype; K1b's rule is unchanged."""
    for max_d in (128, 256):
        for desc in ("patch", "grad_hist"):
            for dt in ("float32", "bfloat16"):
                cfg = Config(max_disparity=max_d, descriptor=desc, dtype=dt)
                geom = cfg.geometry(375, 1242)
                assert (geom.levels, geom.grid_h, geom.grid_w) == (5, 96, 384)
                assert not fused_cuda.supported(cfg, geom)
                assert fused_cuda.cost_supported(cfg, geom)
    gh = Config(max_disparity=64, descriptor="grad_hist")
    assert fused_cuda.supported(gh, gh.geometry(375, 450))


def test_kitti_layout():
    """K4b at KITTI (p = 4): K4's floats, then the bins as bytes: left
    rows 32 x 128 B, the right strip 32 rows at 4 mod 8 words.  D0 = 256:
    78,848 + 32 x (128 + 400) = 95,744 B, 8 patch rows, two blocks an SM;
    D0 = 128: 58,368 + 32 x (128 + 272) = 71,168 B, three."""
    assert fused_cuda.cost_smem_bytes(4, 256, magbin=True) == 95744
    assert fused_cuda.cost_smem_bytes(4, 128, magbin=True) == 71168
    for max_d, blocks in ((256, 2), (128, 3)):
        smem = fused_cuda.cost_smem_bytes(4, max_d, magbin=True) + 1024
        assert fused_cuda.cost_tile_rows(4, max_d, magbin=True) == 8
        assert blocks * smem <= 233472 < (blocks + 1) * smem
    for p in range(3, 9):
        for max_d in (1, 13, 64, 256, 512):
            got = fused_cuda.cost_smem_bytes(p, max_d, magbin=True)
            rows = fused_cuda.cost_tile_rows(p, max_d, magbin=True)
            assert got % 16 == 0
            assert got <= fused_cuda.TWO_PER_SM or rows == 1
            assert got > fused_cuda._cost_layout_bytes(p, max_d, rows)


def test_counters_start_at_zero_and_cpu_launches_nothing():
    for name in ("K4", "K4 bf16", "K4b", "K4b bf16"):
        assert name in _build.KERNELS
        assert isinstance(_build.launches[name], int)
    before = _build.launches.copy()
    cfg = Config(max_disparity=16, levels=2, descriptor="grad_hist")
    geom = cfg.geometry(32, 64)
    planes = torch.rand(4, geom.padded_height, geom.padded_width)
    fused_cuda.cost_volume_rows(planes[0], planes[1], cfg, geom, planes[2],
                                planes[3])
    assert _build.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_work_model_bytes_equal_plain_tensors(dtype):
    """work.k4b: the four planes read once and the volume written once;
    a bin's p^2 multiply-adds and p^2 compares, as K1b's correlation."""
    cfg = Config(max_disparity=13, levels=2, descriptor="grad_hist",
                 dtype=dtype)
    geom = cfg.geometry(40, 96)
    lm, lb, rm, rb = magbin(*np.random.default_rng(0).random(
        (2, 3, geom.padded_height, geom.padded_width), dtype=np.float32))
    vol = fused_cuda.cost_volume_rows(lm, rm, cfg, geom, lb, rb)
    model = work.k4b(cfg, geom, 3)
    assert model.total_bytes == sum(t.numel() * t.element_size()
                                    for t in (lm, lb, rm, rb, vol))
    assert model.ops == work.magbin_ops(cfg, geom, 3)
    assert model.ops["corr"] == work.k1b(cfg, geom, 3).ops["corr"]


@pytest.mark.parametrize("max_d,h,w,batch,dtype", [
    (256, 375, 1242, 32, "float32"), (256, 375, 1242, 32, "bfloat16"),
    (128, 375, 1242, 8, "float32"), (37, 48, 100, 3, "float32")])
def test_benchmark_work_equals_the_port(max_d, h, w, batch, dtype):
    """The benchmark's frozen count of K4b (`stereobench/k4b.py`) is the
    port's `work.k4b`, term by term, and so is its bound."""
    n = 2 * batch
    rcfg = frozen.Config(max_disparity=max_d, descriptor="grad_hist",
                         dtype=dtype)
    pcfg = Config(max_disparity=max_d, descriptor="grad_hist", dtype=dtype)
    got = bench_k4b.k4b(rcfg, rcfg.geometry(h, w), n)
    want = work.k4b(pcfg, pcfg.geometry(h, w), n)
    assert got.bytes == want.bytes and got.ops == want.ops
    assert bench_work.bound(got) == work.bound(want)
    if (max_d, batch, dtype) == (256, 32, "float32"):   # the cell's step
        assert work.bound(want)[1] == "bytes"
        assert work.bound(want)[0] * 1e3 == pytest.approx(0.9015, abs=1e-4)


def _trace(ops, steps, window=1.0):
    return tracing.Trace(window_s=window,
                         spans={"step": [(0.1 * i, 0.1 * i + 0.05)
                                         for i in range(steps)]},
                         device_ops=ops)


def _record(trace, cell="kitti15_d256_gradhist.step_b32"):
    c = harness.load_cell(REPO, cell)
    cfg = frozen.Config(**c.config["config"])
    return harness.Record(cell=cell, config=c.config, traffic=c.traffic,
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


def test_benchmark_readers():
    """The two K4b readers: K4b's device ms a step and its share of the
    bound, from operations named after its symbol only (K4's and the
    rest do not count); None where the trace holds no K4b (the parent's
    program, or no card)."""
    kernel = ("void (anonymous namespace)::costrows_magbin_kernel<4, float>"
              "(float const*, float const*, float const*, float const*, "
              "float*, int, int, int, int, int)")
    k4 = "void (anonymous namespace)::costrows_kernel<4, float>(...)"
    ops = [(kernel, 0.10, 0.102), (k4, 0.102, 0.103),
           (kernel, 0.20, 0.202), ("aggregate_kernel", 0.3, 0.31),
           (kernel, 0.99, 1.01)]              # clipped to the window
    rec = _record(_trace(ops, steps=3))
    ms = _reader("kernels.k4b_ms.step")(rec)
    assert ms == pytest.approx((0.002 + 0.002 + 0.01) / 3 * 1e3)
    share = _reader("kernels.k4b_roofline.step")(rec)
    least = work.bound(work.k4b(Config(max_disparity=256,
                                       descriptor="grad_hist"),
                                Config(max_disparity=256).geometry(375, 1242),
                                64))[0]
    assert share == pytest.approx(100 * least / (ms * 1e-3))
    for none in (_record(_trace([(k4, 0.1, 0.2)], steps=3)),
                 _record(_trace(ops, steps=0))):
        assert _reader("kernels.k4b_ms.step")(none) is None
        assert _reader("kernels.k4b_roofline.step")(none) is None


@pytest.mark.parametrize("rgb", [False, True])
def test_frozen_reference_equals_the_oracle(rgb):
    """The benchmark's frozen NumPy reference, which decides the cell's
    `correct`, is the oracle on grad_hist pairs, field by field, bitwise,
    at a large-D geometry as the cell's."""
    cfg, h, w, field_d = LARGE_D
    left, right, _ = pair(9, h, w, field_d)
    if rgb:
        left, right = (np.repeat(np.rint(x * 255).astype(np.uint8)[..., None],
                                 3, -1) for x in (left, right))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(frozen.Config)}
    got = frozen.match_stereo(left, right, frozen.Config(**fields))
    want = oracle.match_stereo(left, right, cfg)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            assert np.array_equal(a, b, equal_nan=True), f.name
