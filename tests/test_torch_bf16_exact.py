"""The port's bfloat16 mode on the descriptor routes ('exact', centred
descriptors, lr_mode='direct') and on grad_hist 'fused', vs the JAX
package, on the CPU (the kernel routes run their plain versions here).

  * 'exact' bf16 (plain K2 bf16 -> plain K3 bf16, or plain K5 bf16 in exact
    mode at L=5, D0=128) vs JAX bf16 'pallas' (interpret) and 'jnp' on the
    cases of tests/test_torch_bf16.py: disparity_raw and valid agree on
    >= 99.8% of pixels (that file's AGREE); outputs are float32; the kept
    bad rate holds that file's gates, and >= 0.98 of valid decisions
    agree with the port's float32 'exact' run;
  * plain K3 bf16 (`pyramid_body(fast=False)` on a bf16 volume) bitwise
    JAX's `pyramid_pallas.pyramid_backtrack` and `match_dmajor_xla` on the
    same volume, and equal to plain K5 bf16 (exact) + `backtrack_top`: JAX
    may route a volume to its K3 where the port routes it to K5, or the
    reverse, so all four must decide alike;
  * the K2 rule: the plain bf16 volume is the float32 volume of the
    widened descriptors, rounded (both sum in one order); a NumPy
    emulation of the kernel's sum (an FMA chain over k = 0..C-1 from 0 on
    the widenings, exact products, relu, one rounding) is bitwise JAX's
    K2 bf16 (`costvol_pallas.cost_volume_dmajor`, interpret); the plain
    version sums in torch's order, and agrees with JAX on the share of
    bins printed and asserted (>= 0.999, each other bin one bf16 ulp off);
  * plain K1b bf16 (grad_hist 'fused') vs JAX bf16 'fused': >= AGREE;
  * centred descriptors and lr_mode='direct' in bf16 on both kernel
    routes vs JAX bf16: >= AGREE.
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
from deepmatching_stereo_matching_tpu.models import pipeline as jpipeline
from deepmatching_stereo_matching_tpu.ops import costvol_pallas, pyramid_pallas
from deepmatching_stereo_matching_tpu.ops._dispatch import set_implementation
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu.utils.metrics import bad_pixel_rate
from deepmatching_stereo_matching_tpu_torch import api
from deepmatching_stereo_matching_tpu_torch.config import carry_over
from deepmatching_stereo_matching_tpu_torch.ops import (
    costvol, costvol_cuda, fused_cuda, pyramid_cuda)

AGREE = 0.998          # port vs JAX bf16, decisions and validity
F32_AGREE = 0.98       # bf16 vs f32 decisions (tests/test_bf16.py)
K2_JAX_AGREE = 0.999   # plain K2 bf16 bins equal to JAX's (torch's sum order)
BF16 = torch.bfloat16
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


def agreement(got, want):
    return (float(np.mean(got.disparity_raw == want.disparity_raw)),
            float(np.mean(got.valid == want.valid)))


def rne(x):
    """float32 values rounded to the nearest bfloat16, ties to even, by
    bit arithmetic on the float32 pattern; as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case,seed", [("bench", 4), ("bench", 8),
                                       ("large_d", 3)])
def test_port_exact_bf16_matches_jax_bf16(case, seed):
    cfg, h, w, _, _ = CASES[case]
    pcfg = carry_over(cfg)
    geom = pcfg.geometry(h, w)
    # bench: plain K3; large_d: a tile K3 does not take, plain K5 (exact).
    assert pyramid_cuda.supported(geom.disparities, geom.levels) == (
        case == "bench")
    left, right, gt = pair(case, seed)
    got = api.match_stereo(left, right, pcfg, impl="exact", device="cpu")
    for impl in ("pallas", "jnp"):
        with set_implementation(impl):
            want = japi.match_stereo(left, right, cfg)
        raw, valid = agreement(got, want)
        print(f"{case} seed {seed} port exact vs JAX {impl} (bf16): "
              f"disparity_raw {raw:.5f}, valid {valid:.5f}")
        assert raw >= AGREE and valid >= AGREE, (impl, raw, valid)
    assert got.disparity.dtype == np.float32
    assert got.score.dtype == np.float32
    bad = bad_pixel_rate(got.disparity, gt, count_invalid=False)
    if case == "bench":
        assert bad < 0.05
    else:   # a scene the oracle does not solve: tools/bench_large.py's gate
        ora = oracle.match_stereo(left, right, dataclasses.replace(
            cfg, dtype="float32"))
        assert bad - bad_pixel_rate(ora.disparity, gt,
                                    count_invalid=False) <= 0.05
    f32 = api.match_stereo(left, right, dataclasses.replace(
        pcfg, dtype="float32"), impl="exact", device="cpu")
    both = f32.valid & got.valid
    assert np.mean(f32.disparity_raw[both] == got.disparity_raw[both]) \
        >= F32_AGREE


def bf16_volume(seed, shape, ties=False):
    """relu'd normal costs rounded to bf16 (many exact zeros), or quarter
    steps 0..1.25 (ties everywhere)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 6, shape) / 4 if ties
         else np.maximum(rng.standard_normal(shape), 0.0))
    return rne(x.astype(np.float32))


@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
@pytest.mark.parametrize("levels,d0,h0,w0", [(2, 16, 8, 16), (4, 64, 16, 32),
                                             (2, 24, 28, 36)])
def test_plain_k3_bf16_matches_jax_k3_and_k5(levels, d0, h0, w0, ties):
    cost = bf16_volume(d0 + h0 + ties, (d0, h0, w0), ties)
    vol = torch.from_numpy(cost).to(BF16)
    disp, score = pyramid_cuda.pyramid_body(vol, levels, 1.4, fast=False)
    top, args = pyramid_cuda.aggregate_dmajor_torch(vol, levels, 1.4)
    d5, s5 = pyramid_cuda.backtrack_top(vol, top, args)
    jvol = jnp.asarray(cost).astype(jnp.bfloat16)
    jk3 = pyramid_pallas.pyramid_backtrack(jvol, levels, 1.4)
    jxla = jpipeline.match_dmajor_xla(jvol, levels, 1.4)
    assert disp.dtype == torch.int32 and score.dtype == torch.float32
    for k, s in ((d5.numpy(), s5.numpy()), jk3, jxla):
        np.testing.assert_array_equal(disp.numpy(), np.asarray(k))
        np.testing.assert_array_equal(score.numpy(), np.asarray(s))


def unit_descriptors(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.sqrt((x * x).sum(-1, keepdims=True))


def kernel_sum_emulation(src, tgt, d0, p, max_d, reverse):
    """K2's bf16 rule in NumPy on widened (H0, W0, C) / (H0, Wt, C)
    descriptors: acc = 0, acc += s[k] * t[k] for k = 0..C-1 in float32
    (each product exact: two bf16 significands fit float32's), relu,
    masked bins 0, one rounding -> (D, H0, W0) float32 of bf16 values."""
    h0, w0, c = src.shape
    wt = tgt.shape[1]
    out = np.zeros((d0, h0, w0), np.float32)
    xs = p * np.arange(w0)
    for d in range(min(d0, max_d)):
        x = xs + d if reverse else xs - d
        ok = (x >= 0) & (x < wt)
        t = tgt[:, np.clip(x, 0, wt - 1)]
        acc = np.zeros((h0, w0), np.float32)
        for k in range(c):
            acc = acc + src[..., k] * t[..., k]
        out[d] = np.where(ok, rne(np.maximum(acc, np.float32(0))), 0)
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("c,p,d0,max_d", [(16, 4, 32, 32), (128, 4, 24, 20),
                                          (9, 3, 16, 16)])
def test_k2_bf16_rule(c, p, d0, max_d, reverse):
    rng = np.random.default_rng(c + d0 + reverse)
    h0, w0 = 8, 32
    src = rne(unit_descriptors(rng, (h0, w0, c)))
    tgt = rne(unit_descriptors(rng, (h0, p * w0, c)))
    tgt[:, p * w0 - (p - 1):] = 0.0     # as sliding descriptors are
    s16, t16 = (torch.from_numpy(x).to(BF16) for x in (src, tgt))
    args = (d0, p, max_d, reverse)
    plain = costvol_cuda.cost_volume_dmajor_torch(s16, t16, *args)
    f32 = costvol_cuda.cost_volume_dmajor_torch(s16.float(), t16.float(),
                                                *args)
    assert plain.dtype == BF16
    assert torch.equal(plain, f32.to(BF16))
    assert torch.equal(costvol.cost_volume(s16, t16, d0, p, max_d, reverse),
                       plain.movedim(-3, -1))
    want = np.asarray(costvol_pallas.cost_volume_dmajor(
        jnp.asarray(src).astype(jnp.bfloat16),
        jnp.asarray(tgt).astype(jnp.bfloat16), d0, p, max_d,
        reverse=reverse).astype(jnp.float32))
    np.testing.assert_array_equal(
        kernel_sum_emulation(src, tgt, *args), want)
    same = float(np.mean(plain.float().numpy() == want))
    ulp = np.abs(plain.float().numpy() - want) <= np.abs(want) * 2.0 ** -7
    print(f"C={c} p={p} D0={d0} {'rev' if reverse else 'fwd'}: plain K2 "
          f"bf16 bins equal to JAX's {same:.6f}")
    assert same >= K2_JAX_AGREE and ulp.all()


def test_k6_takes_float32_only():
    """No path of the JAX package runs the row-layout volume in bf16, so
    K6's wrapper refuses a bf16 pair where it would launch (checked
    before any launch: the tensors here only claim to be on the card)."""
    s = torch.zeros(2, 8, 16, dtype=BF16)
    with pytest.raises(NotImplementedError, match="row-layout"):
        costvol_cuda._check_descriptors(s, s, 16, 4, rows=True)
    costvol_cuda._check_descriptors(s, s, 16, 4)
    costvol_cuda._check_descriptors(s.float(), s.float(), 16, 4, rows=True)


@pytest.mark.parametrize("seed", [4, 8])
def test_plain_k1b_bf16_matches_jax_fused(seed):
    cfg = Config(max_disparity=24, descriptor="grad_hist", dtype="bfloat16")
    pcfg = carry_over(cfg)
    assert fused_cuda.supported(pcfg, pcfg.geometry(96, 144))
    left, right, gt = pair("bench", seed)
    got = api.match_stereo(left, right, pcfg, impl="fused", device="cpu")
    want = japi.match_stereo(left, right, cfg, impl="fused")
    raw, valid = agreement(got, want)
    print(f"grad_hist seed {seed} port fused vs JAX fused (bf16): "
          f"disparity_raw {raw:.5f}, valid {valid:.5f}")
    assert raw >= AGREE and valid >= AGREE
    assert got.score.dtype == np.float32
    assert bad_pixel_rate(got.disparity, gt, count_invalid=False) < 0.05


@pytest.mark.parametrize("kw", [
    dict(center_descriptors=True),
    dict(center_descriptors=True, descriptor="grad_hist"),
    dict(lr_mode="direct"),
], ids=["centred", "centred-grad_hist", "direct"])
@pytest.mark.parametrize("route", ["fused", "exact"])
def test_centred_and_direct_bf16_match_jax(kw, route):
    """Both take the descriptor route on 'fused' too, in either package."""
    cfg = Config(max_disparity=24, dtype="bfloat16", **kw)
    left, right, _ = pair("bench", 4)
    got = api.match_stereo(left, right, carry_over(cfg), impl=route,
                           device="cpu")
    want = japi.match_stereo(left, right, cfg,
                             impl="fused" if route == "fused" else "pallas")
    raw, valid = agreement(got, want)
    print(f"{kw} port {route} vs JAX (bf16): disparity_raw {raw:.5f}, "
          f"valid {valid:.5f}")
    assert raw >= AGREE and valid >= AGREE
    assert got.disparity.dtype == np.float32
    assert got.score.dtype == np.float32
