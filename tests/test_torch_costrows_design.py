"""K4's block schedule and routing (csrc/costrows.cu), on the CPU.

K4 stages a tile of th x 32 patches (th = 8, 4, 2 or 1 patch rows: the
tallest of which two blocks fit an SM) with the right strip from a
4-aligned column, and each thread streams one patch's costs over d.  At
p = 4 the thread holds its left pixels in registers and slides its window
through two aligned float4 per pixel row per step of four bins, carrying
the window norm; at any other p it reads the staged pixels per cost.
`fused_cuda.cost_smem_bytes` mirrors the block's layout (the library's
`dm_cost_rows_smem` is held to it on the card by chip_smoke.py), and
`fused_cuda.cost_route_bytes` keeps the earlier layout's bytes, on which
`cost_supported` still routes patch descriptors.  K4b, the same block
on grad_hist (magnitude, bin) planes, stages the bin planes as bytes
beside the floats and routes on its own layout.  These tests hold the
routing to the earlier rule, the layouts to two blocks per SM at every
routed shape, and rebuild the plain volume exactly from a numpy emulation
of the kernel's indexing, in both forms: an off-by-one in the strip, the
window's float4s, the bins or the masks shows here before a chip call
does.  Nothing here needs a card.
"""

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config, Geometry
from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda, pyramid_cuda

# Shared memory of an SM (233,472 B) over two blocks, less the 1 KB the
# card reserves per block: the most a block may take for 2 per SM.
TWO_PER_SM = 233472 // 2 - 1024
EPS = np.float32(1e-8)


def _geom(h0, w0, p, d0, levels=1):
    return Geometry(height=h0 * p, width=w0 * p, levels=levels,
                    padded_height=h0 * p, padded_width=w0 * p, grid_h=h0,
                    grid_w=w0, disparities=d0)


def _earlier_bytes(p, max_d):
    """The earlier K4 block: 8 x 32 patches, left pixels, the right strip
    from column p*x0 - (max_d - 1), window and patch norms, unpadded."""
    lw = 32 * p
    rw = lw + max_d - 1
    return 4 * (8 * p * (lw + rw) + 8 * (rw - p + 1) + 8 * 32)


@pytest.mark.parametrize("p", [3, 4, 5, 6, 7, 8])
def test_routing_takes_the_earlier_configurations(p):
    """cost_supported takes exactly the patch configurations it took
    before, over max_d 1-512 and levels 1-5; takes grad_hist (K4b) where
    its own layout fits a block; refuses centred descriptors."""
    taken = refused = 0
    for max_d in range(1, 513):
        for levels in range(1, 6):
            unit = 2 ** levels
            d0 = -(-max_d // unit) * unit
            cfg = Config(max_disparity=max_d, levels=levels, patch_size=p)
            geom = _geom(2 * unit, 3 * unit, p, d0, levels)
            earlier = _earlier_bytes(p, max_d) <= pyramid_cuda.MAX_SMEM
            assert fused_cuda.cost_route_bytes(p, max_d) == _earlier_bytes(
                p, max_d)
            assert fused_cuda.cost_supported(cfg, geom) == earlier
            taken += earlier
            refused += not earlier
        if max_d in (1, 64, 256):
            for kw in ({"center_descriptors": True},
                       {"descriptor": "grad_hist",
                        "center_descriptors": True}):
                cfg = Config(max_disparity=max_d, patch_size=p, **kw)
                assert not fused_cuda.cost_supported(cfg, _geom(8, 8, p, 64))
            cfg = Config(max_disparity=max_d, patch_size=p,
                         descriptor="grad_hist")
            assert fused_cuda.cost_supported(cfg, _geom(8, 8, p, 64)) == (
                fused_cuda.cost_smem_bytes(p, max_d, magbin=True)
                <= pyramid_cuda.MAX_SMEM)
    assert taken > 0
    assert refused == 0 or p >= 7   # p = 7, 8 outgrow a block at large max_d


@pytest.mark.parametrize("p", [3, 4, 5, 6, 7, 8])
def test_every_routed_shape_fits_two_blocks_per_sm(p):
    """The new layout fits two blocks per SM wherever K4 is routed: at 8
    patch rows for every max_d at p = 3 and up to max_d 256 at p = 4
    (KITTI's shapes), in fewer rows only where two blocks of 8 would not
    fit (p = 8 always)."""
    rows_seen = set()
    for max_d in range(1, 513):
        if _earlier_bytes(p, max_d) > pyramid_cuda.MAX_SMEM:
            continue
        th = fused_cuda.cost_tile_rows(p, max_d)
        got = fused_cuda.cost_smem_bytes(p, max_d)
        assert got <= TWO_PER_SM, (p, max_d, th, got)
        assert got % 16 == 0
        rows_seen.add(th)
        if th < 8:
            assert (fused_cuda._cost_layout_bytes(p, max_d, 2 * th)
                    > TWO_PER_SM)
    if p == 3:
        assert rows_seen == {8}
    else:
        assert len(rows_seen) > 1
    if p == 4:
        assert all(fused_cuda.cost_tile_rows(4, m) == 8 for m in range(257))


def test_kitti_layout():
    """KITTI (p = 4): 8 x 32 patches.  D0 = 128: left rows 32 x 128
    floats, right strip 32 rows of 256 columns (128 of the tile, 127 before
    it rounded up to 128) at a stride of 260 (4 mod 8), window norms 8 x
    272 (16 mod 32): 58,368 B, three blocks per SM.  D0 = 256: 78,848 B,
    two."""
    assert fused_cuda.cost_tile_rows(4, 128) == 8
    assert fused_cuda.cost_smem_bytes(4, 128) == 4 * (
        32 * 128 + 32 * 260 + 8 * 272) == 58368
    assert 3 * (58368 + 1024) <= 233472 < 4 * (58368 + 1024)
    assert fused_cuda.cost_smem_bytes(4, 256) == 4 * (
        32 * 128 + 32 * 388 + 8 * 400) == 78848
    assert 2 * (78848 + 1024) <= 233472 < 3 * (78848 + 1024)
    assert fused_cuda.cost_route_bytes(4, 128) == 58112
    for max_d in (128, 256):
        cfg = Config(max_disparity=max_d)
        assert fused_cuda.cost_supported(cfg, cfg.geometry(375, 1242))


def _stage(img, y, x, nrows, width):
    """Rows y.. and columns x.. of an (hp, wp) plane, 0 outside it."""
    hp, wp = img.shape
    out = np.zeros((nrows, width), np.float32)
    ys, xs = np.arange(y, y + nrows), np.arange(x, x + width)
    iy, ix = (ys >= 0) & (ys < hp), (xs >= 0) & (xs < wp)
    out[np.ix_(iy, ix)] = img[np.ix_(ys[iy], xs[ix])]
    return out


def _inv_norm(sq):
    """1 / max(sqrt(sq), eps) in float32, sq an exact sum of squares."""
    return np.float32(1.0) / np.maximum(np.sqrt(sq.astype(np.float32)), EPS)


def emulate(left, right, p, d0, max_d, left_bin=None, right_bin=None):
    """The kernel's schedule in numpy: the (n, d0, h0, w0) volume and how
    many times each bin was stored; with bin planes K4b's, whose products
    count where the bins agree.  Integer pixels make every sum exact,
    so the float32 roundings left are the norms and relu(raw * il * ir)."""
    n, hp, wp = left.shape
    h0, w0 = hp // p, wp // p
    magbin = left_bin is not None
    th = fused_cuda.cost_tile_rows(p, max_d, magbin)
    tw = fused_cuda.COST_TILE_W
    lw = p * tw
    lead = -(-(max_d - 1) // 4) * 4
    width = -(-(lw + lead) // 4) * 4
    vol = np.full((n, d0, h0, w0), np.nan, np.float32)
    written = np.zeros((n, d0, h0, w0), np.int64)
    I, J = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    u = np.arange(p)
    for b in range(n):
        for y0 in range(0, h0, th):
            for x0 in range(0, w0, tw):
                lx = p * x0
                rx = lx - (max_d - 1)
                rx0 = rx - (rx & 3)
                assert lx - rx0 == lead and rx0 % 4 == 0
                lt = _stage(left[b], p * y0, lx, p * th, lw).astype(np.int64)
                rt = _stage(right[b], p * y0, rx0, p * th, width
                            ).astype(np.int64)
                if magbin:      # bins as bytes; 0 outside the image
                    lbt = _stage(left_bin[b], p * y0, lx, p * th, lw)
                    rbt = _stage(right_bin[b], p * y0, rx0, p * th, width)
                else:           # one bin everywhere: every product counts
                    lbt, rbt = np.zeros_like(lt), np.zeros_like(rt)
                col = (rt * rt).reshape(th, p, width).sum(1)
                nwin = width - p + 1
                invr = _inv_norm(sum(col[:, dc:dc + nwin] for dc in range(p)))
                jg = x0 + J
                live = (y0 + I < h0) & (jg < w0)
                rows = p * I[..., None] + u                      # (th, tw, p)
                L = lt[rows[..., None], (p * J)[..., None, None] + u]
                LB = lbt[rows[..., None], (p * J)[..., None, None] + u]
                il = _inv_norm((L * L).sum((-1, -2)))

                def store(d, cost):
                    if d >= d0:
                        return
                    keep = live
                    vol[b, d, (y0 + I)[keep], jg[keep]] = cost[keep]
                    np.add.at(written, (b, d, (y0 + I)[keep], jg[keep]), 1)

                def scale(raw, iv, d):
                    c = np.maximum(raw.astype(np.float32) * il * iv,
                                   np.float32(0.0))
                    return np.where((d < max_d) & (p * jg >= d), c,
                                    np.float32(0.0))

                if p != 4:                  # the runtime-p instance
                    for d in range(d0):
                        w = np.clip(p * J + lead - d, 0, nwin - 1)
                        at = (rows[..., None], w[..., None, None] + u)
                        prod = L * rt[at] * (LB == rbt[at])
                        store(d, scale(prod.sum((-1, -2)), invr[I, w], d))
                    continue
                col0 = 4 * J + lead

                def win(plane, c0):
                    return plane[rows[..., None], c0[..., None, None] + u]

                ivc = invr[I, col0]
                d4 = 0
                while d4 < min(d0, max_d):
                    prev = d4 + 1 < max_d
                    col = col0 - d4
                    w8, b8 = (np.concatenate([
                        win(x, col - 4) if prev else np.zeros_like(
                            win(x, col)), win(x, col)], -1)
                        for x in (rt, rbt))
                    ip = (invr[I[..., None], col[..., None] - 4 + u] if prev
                          else np.zeros(I.shape + (4,), np.float32))
                    iv = [ivc, ip[..., 3], ip[..., 2], ip[..., 1]]
                    ivc = ip[..., 0]
                    for r in range(4):
                        same = LB == b8[..., 4 - r:8 - r]
                        raw = (L * w8[..., 4 - r:8 - r] * same).sum((-1, -2))
                        store(d4 + r, scale(raw, iv[r], d4 + r))
                    d4 += 4
                while d4 < d0:
                    for r in range(4):
                        store(d4 + r, np.zeros(I.shape, np.float32))
                    d4 += 4
    return vol, written


SCHEDULES = [
    # n, h0, w0, p, d0, max_d
    (2, 9, 40, 4, 24, 22),    # ragged tiles both ways, masked planes
    (1, 3, 33, 4, 14, 13),    # D0 not a multiple of 4 (L = 1)
    (1, 2, 35, 4, 16, 16),    # max_d - 1 not a multiple of 4
    (1, 2, 20, 4, 8, 1),      # max_d = 1: one live plane
    (1, 5, 35, 3, 24, 22),    # runtime p
    (1, 3, 33, 5, 18, 17),
    (1, 5, 33, 8, 200, 200),  # two blocks of 8 rows do not fit: 4 rows
]


@pytest.mark.parametrize("n,h0,w0,p,d0,max_d", SCHEDULES)
def test_schedule_rebuilds_the_plain_volume(n, h0, w0, p, d0, max_d):
    """Every bin is stored exactly once, and the emulated kernel equals
    `cost_volume_torch` bitwise (integer pixels, negative ones included so
    that the relu bites)."""
    rng = np.random.default_rng(n * 1000 + h0 * w0 + p + d0)
    left, right = (rng.integers(-2, 4, (n, h0 * p, w0 * p))
                   .astype(np.float32) for _ in range(2))
    if p == 8:
        assert fused_cuda.cost_tile_rows(p, max_d) == 4
    vol, written = emulate(left, right, p, d0, max_d)
    assert (written == 1).all()
    cfg = Config(max_disparity=max_d, levels=1, patch_size=p)
    want = fused_cuda.cost_volume_torch(torch.from_numpy(left),
                                        torch.from_numpy(right), cfg,
                                        _geom(h0, w0, p, d0)).numpy()
    np.testing.assert_array_equal(vol, want)
    # and the wrapper takes the plain path on CPU tensors
    got = fused_cuda.cost_volume_rows(torch.from_numpy(left),
                                      torch.from_numpy(right), cfg,
                                      _geom(h0, w0, p, d0))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,h0,w0,p,d0,max_d", SCHEDULES)
def test_magbin_schedule_rebuilds_the_plain_volume(n, h0, w0, p, d0, max_d):
    """K4b: the same schedule with the bin planes staged beside the
    magnitudes stores every bin once and equals `cost_volume_torch` on
    (magnitude, bin) planes (integer magnitudes, bins 0..7 drawn so that
    about one product in eight counts).  Every sum is exact, so the two
    differ only where a norm's square root rounds differently: this
    torch build's CPU sqrt is off the correctly rounded value by an ulp
    on some inputs (sqrt(267.0): numpy and the card's __fsqrt_rn agree,
    torch does not), which the non-negative magnitudes reach.  So the
    zeros (the masks) must coincide and the rest agree within 4 ulps; a
    wrong strip column, bin or mask is off by far more."""
    rng = np.random.default_rng(n * 1000 + h0 * w0 + p + d0 + 7)
    mags = [rng.integers(0, 4, (n, h0 * p, w0 * p)).astype(np.float32)
            for _ in range(2)]
    bins = [rng.integers(0, 8, (n, h0 * p, w0 * p)).astype(np.float32)
            for _ in range(2)]
    vol, written = emulate(*mags, p, d0, max_d, *bins)
    assert (written == 1).all()
    cfg = Config(max_disparity=max_d, levels=1, patch_size=p,
                 descriptor="grad_hist")
    geom = _geom(h0, w0, p, d0)
    planes = [torch.from_numpy(x) for x in mags + bins]
    want = fused_cuda.cost_volume_torch(*planes[:2], cfg, geom,
                                        *planes[2:]).numpy()
    np.testing.assert_array_equal(vol == 0, want == 0)
    np.testing.assert_allclose(vol, want, rtol=2.0 ** -21, atol=0)  # 4 ulps
    got = fused_cuda.cost_volume_rows(*planes[:2], cfg, geom, *planes[2:])
    np.testing.assert_array_equal(got.numpy(), want)
    # and a bin plane that agreed everywhere would be K4's volume
    assert not np.array_equal(vol, emulate(*mags, p, d0, max_d)[0])
