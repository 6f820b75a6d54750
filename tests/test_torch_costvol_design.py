"""The cost-volume kernel's block schedule (csrc/costvol.cu), on the CPU.

K2/K6 stage a tile of 32 patch columns' source descriptors and the target
strip their bins read into shared memory, C in chunks, and let each lane
of a warp compute four bins that share one target column, in runs
skewed by 3p.  `costvol_cuda.plan` mirrors the kernel's schedule (the
library's `dm_costvol_smem` is held to it on the card by chip_smoke.py).
These tests hold its shared memory to two blocks per SM at every shape
the routes can send, and rebuild the plain volume exactly from a numpy
emulation of the kernel's indexing (strip bounds, zero-filled columns, C
and d chunks, the skewed runs and the masks), block by block: an
off-by-one in a strip bound shows here before a chip call does.  Nothing
here needs a card.
"""

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.ops import costvol, costvol_cuda
from deepmatching_stereo_matching_tpu_torch.parallel import sharded

# Shared memory of an SM (233,472 B) over two blocks, less the 1 KB the
# card reserves per block: the most a block may take for 2 per SM.
TWO_PER_SM = 233472 // 2 - 1024


def test_bench_plan():
    """Bench (C = 16, D0 = 64, p = 4): one chunk of 64 bins in 3 runs of
    32 (64 + skew 12 <= 96), a strip of 4 * 28 + 96 = 208 columns at a
    stride of 20 floats, and 32 source rows: 240 x 20 floats = 19,200 B.
    grad_hist (C = 128) stages 32 floats at a time, double-buffered."""
    q = costvol_cuda.plan(16, 64, 4)
    assert (q.skew, q.dc, q.nch, q.nr, q.w, q.ck, q.nck, q.s) == (
        12, 64, 1, 3, 208, 16, 1, 20)
    assert q.smem == 4 * 240 * 20 == 19200
    g = costvol_cuda.plan(128, 64, 4)
    assert (g.ck, g.nck, g.s, g.bufs) == (32, 4, 36, 2)
    assert g.smem == 4 * 2 * 240 * 36


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
@pytest.mark.parametrize("p", [3, 4, 5, 6, 7, 8])
def test_every_route_shape_fits_two_blocks_per_sm(p, descriptor):
    """Every shape the routes send: C = p*p (patch) or 8*p*p (grad_hist),
    whole volumes of D0 up to 256 (and beyond: the chunk caps the bins),
    and dslab/ringd slabs of 4..64 bins.  The row stride is 4 mod 8
    floats (conflict-free float4 reads) and the strip covers every run."""
    c = p * p * (8 if descriptor == "grad_hist" else 1)
    for d0 in list(range(1, 257)) + [320, 512]:
        q = costvol_cuda.plan(c, d0, p)
        assert q.smem <= TWO_PER_SM, (c, d0, p, q)
        assert q.s % 8 == 4 and q.s >= q.ck
        assert q.nch * q.dc >= d0 and (q.nch - 1) * q.dc < d0
        assert q.dc + q.skew <= 32 * q.nr <= 32 * costvol_cuda.RUNS_MAX
        assert q.w == p * (costvol_cuda.TILE_J - 4) + 32 * q.nr
    for n_slab in (2, 4, 8, 16):
        cfg = Config(max_disparity=256, patch_size=p, descriptor=descriptor)
        glob, _ = sharded._slab_geometry(cfg, 375, 1242, n_slab)
        d_local = glob.disparities // n_slab
        assert 4 <= d_local <= 128
        assert costvol_cuda.smem_bytes(c, d_local, p) <= TWO_PER_SM


def test_large_patches_are_refused():
    """The tile takes p up to 23 with chunked C (a strip of 28p + 128
    columns in two buffers), up to 42 where the skew 3p still leaves a
    run for the bins; beyond, the wrapper raises rather than launch."""
    assert costvol_cuda.plan(23 * 23, 256, 23).smem <= 232448
    with pytest.raises(ValueError, match="more than 232448"):
        costvol_cuda.plan(24 * 24, 256, 24)
    assert costvol_cuda.plan(32, 16, 42).nr == costvol_cuda.RUNS_MAX
    with pytest.raises(ValueError, match="patch sizes up to 42"):
        costvol_cuda.plan(32, 16, 43)


def emulate(src, tgt, d0, p, max_d, reverse, oo, d_offset):
    """The kernel's schedule in numpy: (n, h0, d0, w0) volume and how many
    times each bin was written.  Dots in float64 per C chunk, so integer
    descriptors give exact sums whatever the order."""
    n, h0, w0, c = src.shape
    wt = tgt.shape[2]
    q = costvol_cuda.plan(c, d0, p)
    tj_, jr, warps = costvol_cuda.TILE_J, costvol_cuda.COLS_PER_WARP, \
        costvol_cuda.WARPS
    vol = np.full((n, h0, d0, w0), np.nan)
    written = np.zeros((n, h0, d0, w0), np.int64)
    g, r, lane, u = np.meshgrid(np.arange(warps), np.arange(q.nr),
                                np.arange(32), np.arange(jr), indexing="ij")
    e = 32 * r + lane
    idx = p * jr * g + (e if reverse else 32 * q.nr - 1 - e)
    jj = g * jr + u
    dd = e - u * p if reverse else e + u * p - q.skew
    for b in range(n):
        for i in range(h0):
            for tj in range(-(-w0 // tj_)):
                for ch in range(q.nch):
                    j0, dc0 = tj * tj_, ch * q.dc
                    dcn = min(q.dc, d0 - dc0)
                    xo = p * (j0 + oo)
                    x_lo = (xo + d_offset + dc0 if reverse else
                            xo - d_offset - dc0 + q.skew - (32 * q.nr - 1))
                    src_rows = np.zeros((tj_, c))
                    keep = min(tj_, w0 - j0)
                    src_rows[:keep] = src[b, i, j0:j0 + keep]
                    xs = x_lo + np.arange(q.w)
                    inside = (xs >= 0) & (xs < wt)
                    strip = np.zeros((q.w, c))
                    strip[inside] = tgt[b, i, xs[inside]]
                    acc = np.zeros(g.shape)
                    for kc in range(0, c, q.ck):
                        ks = slice(kc, min(c, kc + q.ck))
                        acc += np.einsum("...k,...k->...", src_rows[jj, ks],
                                         strip[idx, ks])
                    x = x_lo + idx
                    live = (x >= 0) & (x < wt) & (d_offset + dc0 + dd < max_d)
                    store = (dd >= 0) & (dd < dcn) & (j0 + jj < w0)
                    val = np.where(live, np.maximum(acc, 0.0), 0.0)
                    ds, js = (dc0 + dd)[store], (j0 + jj)[store]
                    vol[b, i, ds, js] = val[store]
                    np.add.at(written, (b, i, ds, js), 1)
    return vol, written


SCHEDULES = [
    # p, c, h0, w0, wt extra, d0, max_d, origin_offset, d_offset
    (4, 16, 2, 40, 3, 64, 64, 0, 0),       # bench-like, ragged last tile
    (4, 16, 2, 33, 3, 256, 250, 0, 0),     # three d chunks, masked bins
    (4, 16, 1, 32, 3 + 2 * 8, 24, 24, 2, 0),   # halo target
    (4, 128, 1, 20, 3, 16, 16, 0, 5),      # C chunks of 32, a slab
    (3, 9, 2, 45, 2, 24, 22, 0, 7),        # C = 9, 4-byte staging
    (5, 25, 1, 33, 4, 20, 20, 0, 3),
    (6, 36, 1, 21, 5, 48, 45, 1, 5),       # a ragged last C chunk of 4
    (7, 49, 1, 19, 6, 28, 25, 0, 0),       # and of 17
    (8, 64, 1, 20, 7, 40, 37, 0, 13),      # d_offset not a multiple of p
    (8, 512, 1, 12, 7, 24, 24, 0, 9),      # 16 C chunks
    (8, 64, 1, 40, 7, 256, 250, 0, 0),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("p,c,h0,w0,extra,d0,max_d,oo,d_offset", SCHEDULES)
def test_schedule_rebuilds_the_plain_volume(p, c, h0, w0, extra, d0, max_d,
                                            oo, d_offset, reverse):
    """Every bin of the volume is written exactly once, and the emulated
    kernel equals the plain K6 volume exactly (integer descriptors)."""
    rng = np.random.default_rng(p * 1000 + c + d0 + d_offset)
    wt = p * w0 + extra
    src = rng.integers(-3, 4, (2, h0, w0, c)).astype(np.float32)
    tgt = rng.integers(-3, 4, (2, h0, wt, c)).astype(np.float32)
    vol, written = emulate(src, tgt, d0, p, max_d, reverse, oo, d_offset)
    assert (written == 1).all()
    want = costvol.cost_volume_rows_torch(
        torch.from_numpy(src), torch.from_numpy(tgt), d0, p, max_d,
        reverse=reverse, origin_offset=oo, d_offset=d_offset).numpy()
    np.testing.assert_array_equal(vol, want)


def test_slabs_of_the_schedule_are_the_whole_volume():
    """A K6 slab at d_offset is the same bins of the whole volume, in the
    schedule as in the kernel contract (chunks differ between the two)."""
    rng = np.random.default_rng(3)
    src = rng.integers(-3, 4, (1, 1, 40, 16)).astype(np.float32)
    tgt = rng.integers(-3, 4, (1, 1, 163, 16)).astype(np.float32)
    whole, _ = emulate(src, tgt, 256, 4, 250, False, 0, 0)
    for d_offset in (0, 64, 100, 192):
        slab, _ = emulate(src, tgt, 64, 4, 250, False, 0, d_offset)
        np.testing.assert_array_equal(
            slab, whole[:, :, d_offset:d_offset + 64])
