"""K3's block schedule and routing (csrc/pyramid.cu), on the CPU.

K3 keeps no level-0 tile in shared memory: a thread owns one level-0
cell, the four cells of a 2x2 quad in adjacent lanes, streams its costs
over d from the volume, pools (2k-1, 2k, 2k+1) in registers, packs each
offset at 2 bits and forms the quad's 4-child mean by two xor-shuffles,
then x^lam on it: the level-1 map.  Levels >= 1 and the walk down run as
before, and the score is the volume at the chosen bin.
`pyramid_cuda.smem_bytes` mirrors the block's layout (the library's
`dm_pyramid_smem` is held to it on the card by chip_smoke.py);
`pyramid_cuda.route_bytes` keeps the earlier layout's bytes, on which
`supported` still routes.  These tests hold the routing to the earlier
rule, the layout to two blocks per SM at every routed shape, the lane map
to the quads the shuffles assume, and rebuild `pyramid_body(fast=False)`
bitwise from a numpy emulation of the streamed level 0 (the power
correctly rounded: the power in float64, rounded once, as K3's pow_rn
and the plain version take it).  Nothing here needs a card.
"""

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.ops import pyramid_cuda

TWO_PER_SM = 233472 // 2 - 1024
LAM = 1.4


def _earlier_bytes(d0, levels):
    """The earlier K3 block: the (D0, T, T) level-0 tile, levels 1..L and
    every level's offsets as int8 (16-byte aligned)."""
    t = 2 ** levels
    floats = d0 * t * t + sum((d0 >> l) * (t >> l) ** 2
                              for l in range(1, levels + 1))
    args = sum((d0 >> (l + 1)) * (t >> l) ** 2 for l in range(levels))
    return 4 * floats + ((args + 15) & ~15)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_routing_takes_the_earlier_configurations(levels):
    """`supported` takes exactly the (D0, L) it took before, over max_d
    1-512 rounded up to the tile (the same for every patch size p 3-8:
    K3 reads a volume), and the new block fits two per SM at each."""
    unit = 2 ** levels
    taken = 0
    for max_d in range(1, 513):
        d0 = -(-max_d // unit) * unit
        earlier = _earlier_bytes(d0, levels) <= pyramid_cuda.MAX_SMEM
        assert pyramid_cuda.route_bytes(d0, levels) == _earlier_bytes(
            d0, levels)
        assert pyramid_cuda.supported(d0, levels) == earlier
        assert not pyramid_cuda.supported(d0 + unit // 2, levels)
        if earlier:
            taken += 1
            got = pyramid_cuda.smem_bytes(d0, levels)
            assert got <= TWO_PER_SM and got % 16 == 0
            assert got < _earlier_bytes(d0, levels)
    assert taken > 0


def test_bench_layout():
    """Bench (D0 = 64, L = 4): levels 1..4, (32*64 + 16*16 + 8*4 + 4)
    floats, level-0 offsets 8 x 256 bytes, levels 1..3's 16*64 + 8*16 +
    4*4 bytes: 12,576 B against the earlier 84,256; D0 = 128 at L = 4:
    25,152 B."""
    assert pyramid_cuda.smem_bytes(64, 4) == (
        4 * (2048 + 256 + 32 + 4) + 8 * 256 + (1024 + 128 + 16)) == 12576
    assert pyramid_cuda.route_bytes(64, 4) == 84256
    assert pyramid_cuda.smem_bytes(128, 4) == 25152
    assert pyramid_cuda.supported(64, 4) and pyramid_cuda.supported(128, 4)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_lanes_hold_whole_quads(levels):
    """The level-0 lane map (pyramid.cu:level0): element e of a pass of
    256 threads owns cell (2I + sub/2, 2J + sub%2) of quad q = e/4; every
    cell is owned once, and lanes e^1 and e^2 hold the same quad's other
    cells (the shuffle partners).  Idle lanes of a partly filled warp
    shadow a real cell."""
    t = 2 ** levels
    cells, hs = t * t, t // 2

    def cell_of(e):
        ec = e & (cells - 1)
        q, sub = ec >> 2, ec & 3
        return 2 * (q // hs) + (sub >> 1), 2 * (q % hs) + (sub & 1)

    owned = []
    for base in range(0, cells, 256):
        for e in range(base, base + 256):
            if base + (e - base) // 32 * 32 >= cells:
                continue                    # the whole warp is idle
            i, j = cell_of(e)
            assert cell_of(e ^ 1) == (i, j ^ 1)    # m = q(i, j) + q(i, j^1)
            assert cell_of(e ^ 2) == (i ^ 1, j)    # then the other row's
            if e < cells:
                owned.append(i * t + j)
    assert sorted(owned) == list(range(cells))


def _pow(x):
    return np.power(x.astype(np.float64),
                    np.float64(np.float32(LAM))).astype(np.float32)


def _quad_sum(m):
    """((q00 + q01) + (q10 + q11)) over the last two axes, float32."""
    return ((m[..., 0::2, 0::2] + m[..., 0::2, 1::2])
            + (m[..., 1::2, 0::2] + m[..., 1::2, 1::2]))


def _pool(cur):
    """(D, ...) -> pooled (D/2, ...), offsets in {-1, 0, 1}: pad -1 below
    bin 0, ties lo, then even, then odd (pyramid.cuh:pyramid_up)."""
    ev, od = cur[0::2], cur[1::2]
    lo = np.concatenate([np.full_like(od[:1], -1.0), od[:-1]])
    pooled = np.maximum(np.maximum(lo, ev), od)
    arg = np.where(pooled == lo, -1, np.where(pooled == ev, 0, 1))
    return pooled, arg.astype(np.int8)


def emulate(cost, levels):
    """K3 on a (n, D0, H0, W0) float32 volume, tile by tile: the streamed
    level 0 (2-bit offsets, shuffle-order mean, x^lam), pyramid_up from
    level 1, descend_cell to level 1, the level-0 code, the score load."""
    n, d0, h0, w0 = cost.shape
    t, kn = 2 ** levels, d0 // 2
    disp = np.full((n, h0, w0), -7, np.int32)
    score = np.full((n, h0, w0), np.nan, np.float32)
    for b in range(n):
        for y0 in range(0, h0, t):
            for x0 in range(0, w0, t):
                tile = cost[b, :, y0:y0 + t, x0:x0 + t]
                # Level 0, per cell over d: prevc starts at the pad.
                prevc = np.full((t, t), -1.0, np.float32)
                codes = np.zeros((kn, t, t), np.uint32)
                lv1 = np.zeros((kn, t // 2, t // 2), np.float32)
                for k in range(kn):
                    lo, ev, od = prevc, tile[2 * k], tile[2 * k + 1]
                    pooled = np.maximum(np.maximum(lo, ev), od)
                    codes[k] = np.where(pooled == lo, 0,
                                        np.where(pooled == ev, 1, 2))
                    lv1[k] = _pow(_quad_sum(pooled) * np.float32(0.25))
                    prevc = od
                arg0 = np.zeros(((kn + 3) // 4, t, t), np.uint32)
                for k in range(kn):
                    arg0[k >> 2] |= codes[k] << (2 * (k & 3))
                assert arg0.max() < 256     # one byte per four bins
                # Levels >= 1 (exact: x^lam after every merge).
                cur, args = lv1, []
                for _ in range(1, levels):
                    pooled, arg = _pool(cur)
                    args.append(arg)
                    cur = _pow(_quad_sum(pooled) * np.float32(0.25))
                for y in range(t):
                    for x in range(t):
                        k = int(np.argmax(cur[:, 0, 0]))  # first max
                        for lvl in range(levels - 1, 0, -1):
                            k = 2 * k + int(args[lvl - 1][k, y >> lvl,
                                                          x >> lvl])
                        code = (int(arg0[k >> 2, y, x]) >> (2 * (k & 3))) & 3
                        k = 2 * k + code - 1
                        disp[b, y0 + y, x0 + x] = k
                        score[b, y0 + y, x0 + x] = tile[k, y, x]
    return disp, score


SHAPES = [
    # n, d0, h0, w0, levels
    (2, 64, 16, 32, 4),     # the bench's tile
    (1, 128, 16, 16, 4),    # D0 = 128 at L = 4
    (2, 16, 8, 12, 2),
    (1, 6, 4, 6, 1),        # D0 not a multiple of 4: a last partial byte
    (1, 10, 4, 2, 1),
    (1, 32, 32, 32, 5),     # 1024 cells: four passes of 256 threads
]


@pytest.mark.parametrize("n,d0,h0,w0,levels", SHAPES)
def test_streamed_level0_rebuilds_the_plain_pyramid(n, d0, h0, w0, levels):
    """Disparities and scores bitwise `pyramid_body(fast=False)`'s, on a
    volume of quarter steps with many ties (pool and argmax tie order)."""
    rng = np.random.default_rng(n * 100 + d0 + h0 + levels)
    cost = (rng.integers(0, 6, (n, d0, h0, w0)) / 4).astype(np.float32)
    disp, score = emulate(cost, levels)
    want_d, want_s = pyramid_cuda.pyramid_body(torch.from_numpy(cost),
                                               levels, LAM, fast=False)
    np.testing.assert_array_equal(disp, want_d.numpy())
    np.testing.assert_array_equal(score, want_s.numpy())
    # and the wrapper takes the same plain path on CPU tensors
    got_d, got_s = pyramid_cuda.pyramid_backtrack(torch.from_numpy(cost),
                                                  levels, LAM)
    assert torch.equal(got_d, want_d) and torch.equal(got_s, want_s)
