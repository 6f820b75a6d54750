"""The port's bfloat16 mode (Config.dtype='bfloat16') vs the JAX package
and a per-op rounding emulation, on the CPU (the kernel routes run their
plain versions here).

  * the 'fused' (plain K1) and 'torch' routes vs JAX bf16 'jnp' and
    'fused' (interpret, as tests/test_bf16.py runs it) on
    make_block_pair(96, 144, 24) at seeds 4 and 8: disparity_raw and
    valid agree on >= 99.8% of pixels (JAX's own impls agree on 100%);
    outputs are float32, the kept bad rate is < 0.05, and >= 0.98 of
    valid decisions agree with the port's float32 run;
  * at L=5, D0=128, where the port's 'fused' route runs plain K4 -> K5,
    the same gates, each route against its JAX counterpart ('fused' vs
    'fused', 'torch' vs 'jnp'): there JAX's two impls themselves differ
    on ~2% of pixels (the cost is rounded after, not before, the sum);
  * the plain bf16 pyramid (`pyramid_body` fast and exact,
    `aggregate_dmajor_torch` fast and exact) bitwise a NumPy emulation
    that rounds to nearest-even by bit arithmetic after every op, with
    lam = 1.3984375 (1.4 in bf16) except in K1's fast rectification,
    which uses 1.4; `torch.pow` on a bf16 tensor rounds the exponent
    itself, and the difference is pinned;
  * plain K5 in bf16 vs JAX `pyramid_pallas.aggregate_slabs` (interpret;
    D0 = 64, more than its 32-plane slab): offsets equal, top maps
    bitwise;
  * the K4 rule: the plain bf16 volume is the float32 volume rounded;
  * the strategies on a world of 4 gloo ranks, as the JAX package runs
    them in bf16: tiled and wtiled(merge_level=None) bitwise the port's
    unsharded bf16 pipeline; dslab, ringd and wtiled(merge_level <
    levels) bitwise their own float32 run, the rule JAX's strategies
    follow (shown here on JAX's too); the port's bf16 decisions agree
    with JAX's; the bf16 stream bitwise the unsharded bf16 pipeline;
    only float16 raises.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu import api as japi
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.ops import pyramid_pallas
from deepmatching_stereo_matching_tpu.ops._dispatch import set_implementation
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu.utils.metrics import bad_pixel_rate
from deepmatching_stereo_matching_tpu_torch import api
from deepmatching_stereo_matching_tpu_torch.config import carry_over
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda, pool
from deepmatching_stereo_matching_tpu_torch.ops import pyramid_cuda
from deepmatching_stereo_matching_tpu_torch.parallel import (
    launch, mesh as mesh_lib, runner, sharded, wtiled)

AGREE = 0.998          # port vs JAX bf16, decisions and validity
F32_AGREE = 0.98       # bf16 vs f32 decisions (tests/test_bf16.py)
LAM_BF16 = 1.3984375   # 1.4 rounded to bfloat16
# (cfg, height, width, field disparity range, field block)
CASES = {
    "bench": (Config(max_disparity=24, dtype="bfloat16"), 96, 144, 24, None),
    "large_d": (Config(max_disparity=128, levels=5, dtype="bfloat16"),
                128, 128, 48, 16),
}


@functools.lru_cache(maxsize=None)
def pair(case, seed):
    cfg, h, w, field_d, block = CASES[case]
    if block is None:
        return synthetic.make_block_pair(h, w, max_disparity=field_d,
                                         seed=seed)
    field = synthetic.block_disparity_field(
        h, w, field_d, np.random.default_rng(seed), block=block)
    return synthetic.make_pair(h, w, field, seed=seed)


@functools.lru_cache(maxsize=None)
def jax_result(case, seed, impl):
    left, right, _ = pair(case, seed)
    with set_implementation(impl):
        return japi.match_stereo(left, right, CASES[case][0])


@functools.lru_cache(maxsize=None)
def oracle_bad_rate(case, seed):
    left, right, gt = pair(case, seed)
    ora = oracle.match_stereo(left, right, dataclasses.replace(
        CASES[case][0], dtype="float32"))
    return bad_pixel_rate(ora.disparity, gt, count_invalid=False)


def agreement(got, want):
    return (float(np.mean(got.disparity_raw == want.disparity_raw)),
            float(np.mean(got.valid == want.valid)))


@pytest.mark.parametrize("route", ["fused", "torch"])
@pytest.mark.parametrize("case,seed", [("bench", 4), ("bench", 8),
                                       ("large_d", 3)])
def test_port_bf16_matches_jax_bf16(case, seed, route):
    cfg, h, w, _, _ = CASES[case]
    pcfg = carry_over(cfg)
    geom = pcfg.geometry(h, w)
    if route == "fused":     # the kernel this slice ports runs the case
        k1 = case == "bench"
        assert fused_cuda.supported(pcfg, geom) == k1
        assert fused_cuda.cost_supported(pcfg, geom)
    left, right, gt = pair(case, seed)
    got = api.match_stereo(left, right, pcfg, impl=route, device="cpu")
    impls = (("jnp", "fused") if case == "bench"
             else ("fused" if route == "fused" else "jnp",))
    for impl in impls:
        raw, valid = agreement(got, jax_result(case, seed, impl))
        print(f"{case} seed {seed} port {route} vs JAX {impl}: "
              f"disparity_raw {raw:.5f}, valid {valid:.5f}")
        assert raw >= AGREE and valid >= AGREE, (impl, raw, valid)
    assert got.disparity.dtype == np.float32
    assert got.score.dtype == np.float32
    bad = bad_pixel_rate(got.disparity, gt, count_invalid=False)
    if case == "bench":
        assert bad < 0.05
    else:   # a scene the oracle does not solve: tools/bench_large.py's gate
        assert bad - oracle_bad_rate(case, seed) <= 0.05
    f32 = api.match_stereo(left, right, carry_over(
        dataclasses.replace(cfg, dtype="float32")), impl=route, device="cpu")
    both = f32.valid & got.valid
    assert np.mean(f32.disparity_raw[both] == got.disparity_raw[both]) \
        >= F32_AGREE


def bench_pair(seed):
    """chip_smoke's bench pair (bench.py's recipe): 450x375, D=64."""
    field = synthetic.block_disparity_field(
        375, 450, 64, np.random.default_rng(seed), block=32)
    return synthetic.make_pair(375, 450, field, seed=seed)


def test_bf16_vs_f32_at_bench_pair_100_is_the_references():
    """The calibration of chip_smoke's bf16-vs-float32 gate: at bench pair
    100 the JAX package's own 'fused' bf16 agrees with its float32 on
    0.97794 of the pixels valid in both, below tests/test_bf16.py's 0.98;
    the port's plain K1 bf16 makes JAX's decisions, so it agrees alike."""
    left, right, _ = bench_pair(100)
    rates = []
    for run in (lambda c: japi.match_stereo(left, right, c, impl="fused"),
                lambda c: api.match_stereo(left, right, carry_over(c),
                                           impl="fused", device="cpu")):
        r32, r16 = (run(Config(max_disparity=64, dtype=dt))
                    for dt in ("float32", "bfloat16"))
        both = r32.valid & r16.valid
        rates.append(float(np.mean(r32.disparity_raw[both]
                                   == r16.disparity_raw[both])))
        if len(rates) == 1:
            jax16 = r16
    print(f"bench pair 100, bf16 vs float32 on 'fused': JAX {rates[0]:.5f}, "
          f"port {rates[1]:.5f}")
    np.testing.assert_array_equal(r16.disparity_raw, jax16.disparity_raw)
    np.testing.assert_array_equal(r16.valid, jax16.valid)
    assert rates[0] == rates[1]
    assert 0.97 <= rates[0] < 0.98


def test_jax_bf16_impls_agree():
    """The calibration the port is held to: JAX's own bf16 'jnp' and
    'fused' agree on every pixel at the bench-class cases."""
    for seed in (4, 8):
        raw, valid = agreement(jax_result("bench", seed, "jnp"),
                               jax_result("bench", seed, "fused"))
        assert raw == 1.0 and valid == 1.0


# ---------------------------------------------------------------------------
# The plain bf16 pyramid against a per-op rounding emulation
# ---------------------------------------------------------------------------


def rne(x):
    """float32 values rounded to the nearest bfloat16, ties to even, by
    bit arithmetic on the float32 pattern (no NaN here); as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def emulate(cost, levels, lam, fast):
    """The pyramid on a D-major (..., D0, H0, W0) float32 array of bf16
    values, rounding after every op: -> (top, args, disp, score)."""
    lam = np.float32(lam)
    args, cur = [], cost
    for lvl in range(levels):
        even, odd = cur[..., 0::2, :, :], cur[..., 1::2, :, :]
        lo = np.concatenate([np.full_like(odd[..., :1, :, :], -1.0),
                             odd[..., :-1, :, :]], axis=-3)
        pooled = np.maximum(np.maximum(lo, even), odd)
        args.append(np.where(pooled == lo, -1, np.where(pooled == even, 0, 1)
                             ).astype(np.int8))
        if fast and lvl > 0:
            pooled = rne(np.power(pooled, lam))

        def q(u, v, x=pooled):
            return x[..., u::2, v::2]
        m = rne(rne(rne(q(0, 0) + q(0, 1)) + rne(q(1, 0) + q(1, 1)))
                * np.float32(0.25))
        cur = m if fast else rne(np.power(m, lam))
    k = np.argmax(cur, axis=-3)            # first max wins ties
    for arg in reversed(args):
        kr = k.repeat(2, -2).repeat(2, -1)
        k = 2 * kr + np.take_along_axis(arg, kr[..., None, :, :],
                                        -3)[..., 0, :, :]
    score = np.take_along_axis(cost, k[..., None, :, :], -3)[..., 0, :, :]
    return cur, args, k, score


def bf16_volume(seed, shape, ties=False):
    """relu'd normal costs rounded to bf16 (many exact zeros), or quarter
    steps 0..1.25 (ties everywhere)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 6, shape) / 4 if ties
         else np.maximum(rng.standard_normal(shape), 0.0))
    return rne(x.astype(np.float32))


PYRAMIDS = [(2, 16, 8, 16), (3, 32, 16, 16), (4, 64, 16, 32)]


@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("levels,d0,h0,w0", PYRAMIDS)
def test_plain_bf16_pyramid_bitwise_emulation(levels, d0, h0, w0, fast,
                                               ties):
    """`aggregate_dmajor_torch` (plain K5: lam rounded) and
    `pyramid_body` (plain K3 exact: lam rounded; plain K1's fast pyramid:
    lam = 1.4 in float32) bitwise the emulation."""
    cost = bf16_volume(levels + d0 + 7 * ties, (2, d0, h0, w0), ties)
    vol = torch.from_numpy(cost).to(torch.bfloat16)
    assert np.array_equal(vol.float().numpy(), cost)
    top, args = pyramid_cuda.aggregate_dmajor_torch(vol, levels, 1.4, fast)
    wtop, wargs, _, _ = emulate(cost, levels, LAM_BF16, fast)
    assert top.dtype == torch.bfloat16
    np.testing.assert_array_equal(top.float().numpy(), wtop)
    for a, w in zip(args, wargs):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), w)
    disp, score = pyramid_cuda.pyramid_body(vol, levels, 1.4, fast)
    _, _, wdisp, wscore = emulate(cost, levels, 1.4 if fast else LAM_BF16,
                                  fast)
    assert disp.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(disp.numpy(), wdisp)
    np.testing.assert_array_equal(score.numpy(), wscore)


def test_bf16_lam_trap_is_pinned():
    """torch.pow on a bf16 tensor rounds a scalar exponent to bf16 itself:
    the plain K5 gets 1.3984375 either way, while K1's fast rectification
    (`pool.rectify` at 1.4) differs from it on a large share of values."""
    x = rne(bf16_volume(11, (4096,)) + np.float32(0.5))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    at_14 = rne(np.power(x, np.float32(1.4)))
    at_bf16 = rne(np.power(x, np.float32(LAM_BF16)))
    assert pool.map_lam(1.4, torch.bfloat16) == LAM_BF16
    assert pool.map_lam(1.4, torch.float32) == 1.4
    np.testing.assert_array_equal(torch.pow(xt, 1.4).float().numpy(),
                                  at_bf16)
    np.testing.assert_array_equal(pool.rectify(xt, 1.4).float().numpy(),
                                  at_14)
    assert np.mean(at_14 != at_bf16) > 0.02    # 4.7% of these values
    # ... and the two exponents give two different fast pyramids.
    vol = torch.from_numpy(bf16_volume(12, (2, 32, 16, 16))).to(
        torch.bfloat16)
    k1_top, _ = pyramid_cuda.aggregate_dmajor_torch(vol, 3, 1.4, True,
                                                    round_lam=False)
    k5_top, _ = pyramid_cuda.aggregate_dmajor_torch(vol, 3, 1.4, True)
    assert not torch.equal(k1_top, k5_top)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("levels,d0,h0,w0", [(2, 64, 16, 32), (5, 64, 32, 32)])
def test_plain_bf16_k5_matches_jax_slabs(levels, d0, h0, w0, fast):
    """Plain K5 vs pyramid_pallas.aggregate_slabs on the same bf16 volume
    (JAX keeps full-resolution duplicated cells: subsampled by 2**l)."""
    cost = bf16_volume(3 * levels, (d0, h0, w0))
    wtop, wargs = pyramid_pallas.aggregate_slabs(
        jnp.asarray(cost).astype(jnp.bfloat16), levels, 1.4, fast=fast)
    gtop, gargs = pyramid_cuda.aggregate_dmajor_torch(
        torch.from_numpy(cost).to(torch.bfloat16), levels, 1.4, fast)
    s = 2 ** levels
    assert wtop.dtype == jnp.bfloat16 and gtop.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        gtop.float().numpy(), np.asarray(wtop.astype(jnp.float32))[:, ::s, ::s])
    for lvl, (ga, wa) in enumerate(zip(gargs, wargs)):
        sl = 2 ** lvl
        np.testing.assert_array_equal(
            ga.numpy(), np.asarray(wa.astype(jnp.int32))[:, ::sl, ::sl])


def test_plain_bf16_k1_is_the_rounded_cost_through_the_fast_pyramid():
    """Plain K1 in bf16: the float32 cost rounded once, then the emulated
    fast pyramid at lam = 1.4; and the plain K4 rule: its bf16 volume is
    the float32 volume rounded."""
    cfg16 = carry_over(Config(max_disparity=24, levels=2, dtype="bfloat16"))
    cfg32 = carry_over(Config(max_disparity=24, levels=2))
    geom = cfg16.geometry(64, 96)
    rng = np.random.default_rng(21)
    left, right = (torch.from_numpy((rng.standard_normal(
        (2, geom.padded_height, geom.padded_width)) * 0.3 + 0.5
    ).astype(np.float32)) for _ in range(2))
    f32 = fused_cuda.cost_volume_torch(left, right, cfg32, geom)
    vol16 = fused_cuda.cost_volume_rows(left, right, cfg16, geom)
    assert vol16.dtype == torch.bfloat16
    assert torch.equal(vol16, f32.to(torch.bfloat16))
    assert torch.equal(fused_cuda.cost_volume_rows(left, right, cfg32, geom),
                       f32)
    disp, score = fused_cuda.match_planes(left, right, cfg16, geom)
    _, _, wdisp, wscore = emulate(rne(f32.numpy()), geom.levels, 1.4, True)
    np.testing.assert_array_equal(disp.numpy(), wdisp)
    np.testing.assert_array_equal(score.numpy(), wscore)


# ---------------------------------------------------------------------------
# The strategies and the stream in bf16, on a world of 4 gloo ranks
# ---------------------------------------------------------------------------

SH, SW, SD = 96, 144, 16
# id -> (strategy, mesh shape, route, merge_level, Config kwargs)
STRATEGY_CASES = {
    "tiled-2x2-flip": ("tiled", (2, 2), "fused", None, {}),
    "tiled-1x4-direct": ("tiled", (1, 4), "fused", None,
                         {"lr_mode": "direct"}),
    "wtiled-1x1x4-full-flip": ("wtiled", (1, 1, 4), "exact", None, {}),
    "wtiled-1x2x2-gradhist-direct": ("wtiled", (1, 2, 2), "exact", None,
                                     {"lr_mode": "direct",
                                      "descriptor": "grad_hist"}),
    "dslab-2x2-flip": ("dslab", (2, 2), "exact", None, {}),
    "ringd-1x4-flip": ("ringd", (1, 4), "exact", None, {"levels": 2}),
    "wtiled-1x1x4-merge1-flip": ("wtiled", (1, 1, 4), "exact", 1, {}),
}
STREAM_PAIRS, STREAM_BATCH = 6, 4       # a batch and a padded tail
KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")


def computes_in_f32(name):
    """The JAX package builds these strategies' volumes from float32
    descriptors whatever cfg.dtype says (dslab, ringd, and wtiled below
    the top level); the others run the unsharded bf16 pipeline."""
    strategy, _, _, ml, _ = STRATEGY_CASES[name]
    return strategy in ("dslab", "ringd") or ml is not None


def strategy_config(name, dtype):
    return Config(max_disparity=SD, dtype=dtype, **STRATEGY_CASES[name][4])


@functools.lru_cache(maxsize=None)
def strategy_pairs(n, seed):
    lefts, rights = [], []
    for i in range(n):
        field = synthetic.block_disparity_field(
            SH, SW, SD, np.random.default_rng(seed + i), block=24)
        left, right, _ = synthetic.make_pair(SH, SW, field, seed=seed + i)
        lefts.append(left)
        rights.append(right)
    return lefts, rights


def strategy_case(name, dtype):
    strategy, shape, route, ml, _ = STRATEGY_CASES[name]
    lefts, rights = strategy_pairs(2, sorted(STRATEGY_CASES).index(name))
    return dict(cfg=carry_over(strategy_config(name, dtype)),
                strategy=strategy, mesh=shape, route=route, merge_level=ml,
                height=SH, width=SW, lefts=lefts, rights=rights)


def _rank_bf16(cases, stream_pairs):
    """Rank body: every strategy case, then the bf16 stream (tiled,
    'fused', mesh 2 x 2) with its batches as `on_result` hands them."""
    outs = launch.match_cases(cases)
    got = {}
    cfg = carry_over(Config(max_disparity=SD, dtype="bfloat16"))
    rep = runner.run_stream(stream_pairs, cfg, SH, SW,
                            mesh_lib.make_mesh(2, 2), "tiled", STREAM_BATCH,
                            "fused", on_result=lambda i, o: got.update({i: o}))
    return outs, got, rep.pairs_completed


@pytest.fixture(scope="module")
def bf16_world():
    """Each case in bf16 and float32, and the bf16 stream, through one
    world of 4 gloo ranks: {(name, dtype): outputs of each rank},
    [(stream batches, pairs completed) of each rank]."""
    keys = [(n, dt) for n in sorted(STRATEGY_CASES)
            for dt in ("bfloat16", "float32")]
    lefts, rights = strategy_pairs(STREAM_PAIRS, 50)
    per_rank = launch.spawn(
        _rank_bf16, 4, ([strategy_case(*k) for k in keys],
                        list(zip(lefts, rights))), timeout=240)
    return ({k: [outs[i] for outs, _, _ in per_rank]
             for i, k in enumerate(keys)},
            [(got, n) for _, got, n in per_rank])


def unsharded(case, lefts, rights, mesh_shape):
    """The port's unsharded pipeline at the strategy's padded extents."""
    cfg = case["cfg"]
    if case["strategy"] == "tiled":
        geom = mesh_lib.tiled_geometry(cfg, SH, SW, mesh_shape[1])[0]
    else:
        geom = wtiled.tiled2d_geometry(cfg, SH, SW, mesh_shape[1],
                                       mesh_shape[2], case["merge_level"])[0]
    lp, rp = (torch.zeros(len(xs), geom.padded_height, geom.padded_width)
              for xs in (lefts, rights))
    for dst, xs in ((lp, lefts), (rp, rights)):
        for i, x in enumerate(xs):
            g = torch.from_numpy(oracle.to_grayscale_f32(x))
            dst[i, :g.shape[0], :g.shape[1]] = g
    out = pipeline.match_padded_core(lp, rp, cfg, geom, case["route"])
    return {k: v.numpy() for k, v in pipeline.apply_postfilter(
        pipeline.crop(out, SH, SW), cfg).items()}


def assert_bitwise(got, want, what):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(STRATEGY_CASES))
def test_bf16_strategy_follows_the_reference(bf16_world, name):
    """tiled and wtiled(merge_level=None) in bf16 are bitwise the port's
    unsharded bf16 pipeline (and not its float32 run); dslab, ringd and
    wtiled(merge_level < levels) in bf16 are bitwise their own float32
    run, as the JAX package's strategies are (test below)."""
    outs = bf16_world[0]
    case = strategy_case(name, "bfloat16")
    want = (outs[name, "float32"][0] if computes_in_f32(name)
            else unsharded(case, case["lefts"], case["rights"],
                           case["mesh"]))
    for rank, got in enumerate(outs[name, "bfloat16"]):
        assert got["score"].dtype == np.float32
        assert_bitwise(got, want, f"rank {rank}")
    if not computes_in_f32(name):
        assert not np.array_equal(outs[name, "bfloat16"][0]["score"],
                                  outs[name, "float32"][0]["score"])


@functools.lru_cache(maxsize=None)
def jax_strategy(name, dtype):
    from deepmatching_stereo_matching_tpu import parallel as jparallel
    import jax

    strategy, shape, route, ml, _ = STRATEGY_CASES[name]
    cfg = strategy_config(name, dtype)
    mesh = (jparallel.make_mesh(*shape) if len(shape) == 2
            else jparallel.make_mesh2d(*shape))
    case = strategy_case(name, dtype)
    lefts, rights = (jax.device_put(jparallel.pad_batch(
        case[k], cfg, SH, SW, mesh, strategy, ml),
        jparallel.input_sharding(mesh, strategy))
        for k in ("lefts", "rights"))
    out = jparallel.match_batch_sharded(
        lefts, rights, cfg, SH, SW, mesh, strategy,
        "fused" if route == "fused" else "jnp", ml)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(STRATEGY_CASES))
def test_jax_bf16_strategy_rule_and_port_agreement(bf16_world, name):
    """The rule on the JAX package's strategies: dslab, ringd and
    wtiled(merge_level < levels) in bf16 bitwise their float32 run (the
    NaN of invalid pixels compared as equal); tiled and wtiled(None) not.
    The port's bf16 decisions agree with JAX's bf16 on >= AGREE."""
    j16, j32 = jax_strategy(name, "bfloat16"), jax_strategy(name, "float32")
    if computes_in_f32(name):
        for k in KEYS:
            assert np.array_equal(j16[k], j32[k], equal_nan=True), k
    else:
        assert not np.array_equal(j16["score"], j32["score"])
    got = bf16_world[0][name, "bfloat16"][0]
    for k in ("disparity_raw", "valid"):
        rate = float(np.mean(got[k] == j16[k]))
        print(f"{name} bf16 port vs JAX: {k} {rate:.5f}")
        assert rate >= AGREE, (k, rate)


def test_bf16_strategies_and_stream_raise(bf16_world):
    """What raised before bf16 ran on the strategies: every strategy now
    returns float32 outputs for a bf16 config (the cases above), and the
    stream's batches are bitwise the unsharded bf16 pipeline's.  Only a
    dtype the JAX package does not know, float16, still raises."""
    for (name, dtype), per_rank in bf16_world[0].items():
        assert all(o["score"].dtype == np.float32
                   and o["disparity"].shape == (2, SH, SW)
                   for o in per_rank), (name, dtype)
    lefts, rights = strategy_pairs(STREAM_PAIRS, 50)
    cfg = carry_over(Config(max_disparity=SD, dtype="bfloat16"))
    case = dict(cfg=cfg, strategy="tiled", route="fused", merge_level=None)
    for got, completed in bf16_world[1]:
        assert completed == STREAM_PAIRS and sorted(got) == [0, 1]
        for b, i in enumerate(range(0, STREAM_PAIRS, STREAM_BATCH)):
            want = unsharded(case, lefts[i:i + STREAM_BATCH],
                             rights[i:i + STREAM_BATCH], (2, 2))
            assert_bitwise(got[b], want, f"stream batch {b}")
    cfg16 = carry_over(Config(max_disparity=SD, dtype="float16"))
    with pytest.raises(NotImplementedError, match="float16"):
        pipeline.check_supported(cfg16, "torch")
    with pytest.raises(NotImplementedError, match="float16"):
        sharded.match_batch_sharded(None, None, cfg16, 64, 64, None,
                                    "tiled")
    with pytest.raises(NotImplementedError, match="float16"):
        runner.run_stream([], cfg16, 64, 64)
