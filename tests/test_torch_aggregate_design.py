"""K5's block schedule (csrc/aggregate.cu), on the CPU.

K5 aggregates every level of a D-major volume in one launch: one block
per (instance, 32 x 32 tile of level-0 cells) walks D upward in chunks of
32 planes.  Four stream warps own the tile, a thread 2 rows x 4 columns.
Per plane pair a thread takes the pair from a cp.async ring that runs
three pairs ahead (the 16-byte form; float32 threads copy their own
words, bf16 lanes one 16-byte chunk of their warp's rows each; the narrow
form loads elements), pools level 0 against the previous odd plane it
keeps, stores its offsets a row at a time and merges its quads; on every
second pair it pools those level-1 cells against its level-1 halo, all
in registers, and merges the level-1 quads with its row partner (lane ^
8) into the chunk's level-2 map, one of two buffers in shared memory.  A
fifth warp runs levels 2..L-1 one chunk behind, item by item, each level
against its lo halo plane, the last level's merge going to the top map;
then every halo takes the chunk's last odd plane.  More than five levels
chain launches of at most five.

These tests emulate that schedule in numpy, with the kernel's index
arithmetic (the thread map, the ring's slots and bf16 chunks, the row
partners, the item map, the flat shared-memory layout
`pyramid_cuda.aggregate_layout`, the offsets buffer `arg_offsets`) and
its masks at ragged edges, running the level warp as far behind as its
barriers let it, and rebuild `aggregate_dmajor_torch` bitwise from it in
fast and exact mode, float32 and bfloat16 (every op rounded, lam rounded;
the power, in both, numpy's: `numpy_rectify`; exact mode's power after a
merge on float32 maps correctly rounded), at L 1-7, over ragged
tile counts, D0 = 2^L and D0 not a multiple of the chunk; every output
is written exactly once and every store is aligned to its width.  They
hold the block's shared memory and threads to two blocks per SM at the
routed shapes, and the plain version once more to the JAX package's slab
kernel over several 32-plane slabs.  Nothing here needs a card:
chip_smoke.py holds the kernel bitwise to the plain version on it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepmatching_stereo_matching_tpu.ops import pyramid_pallas
from deepmatching_stereo_matching_tpu_torch.ops import pool, pyramid_cuda

LAM = 1.4
TILE, CHUNK, MAXL, RING = (pyramid_cuda.AGG_TILE, pyramid_cuda.AGG_CHUNK,
                           pyramid_cuda.AGG_MAX_LEVELS, pyramid_cuda.AGG_RING)
# Two blocks per SM by shared memory: 228 KB per SM, 1 KB reserved a block.
TWO_PER_SM = 233472 // 2 - 1024


def rne(x):
    """float32 values rounded to the nearest bfloat16, ties to even."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


class Ops:
    """The kernel's arithmetic: float32, or every result rounded to bf16."""

    def __init__(self, bf16, lam):
        self.r = rne if bf16 else (lambda x: np.asarray(x, np.float32))
        self.lam = lam

    def pow(self, x):
        return self.r(np.power(np.asarray(x, np.float32), self.lam))

    def merge_pow(self, x):
        """The exact mode's power after a merge: correctly rounded on
        float32 maps (pyramid.cuh:pow_rn), `pow` on bfloat16 maps."""
        if self.r is rne:
            return self.pow(x)
        return np.power(np.asarray(x, np.float64),
                        np.float64(self.lam)).astype(np.float32)

    def quad(self, q00, q01, q10, q11):
        r = self.r
        return r(r(r(q00 + q01) + r(q10 + q11)) * np.float32(0.25))


def numpy_rectify(x, lam, exact=False):
    """`pool.rectify` with numpy's float32 power.  torch's CPU pow takes
    one code path for the body of a tensor and another for its last
    elements, which differ in the last bit on about a quarter of values,
    so its result depends on an element's position in the tensor; numpy's
    is a function of the value alone, so an emulation that visits the
    elements in another order can match it.  On the card both the kernel
    and the plain version use powf, and in `exact` mode on float32 maps
    both the power in float64 rounded once (as here)."""
    if exact and x.dtype == torch.float32:
        return torch.from_numpy(np.power(
            x.double().numpy(), np.float64(np.float32(lam))).astype(
                np.float32))
    y = torch.from_numpy(np.power(x.float().numpy(), np.float32(lam)))
    return y.to(x.dtype)


@pytest.fixture
def value_pow(monkeypatch):
    monkeypatch.setattr(pool, "rectify", numpy_rectify)


def pool3(lo, ev, od):
    p = np.maximum(np.maximum(lo, ev), od)
    return p, np.where(p == lo, -1, np.where(p == ev, 0, 1)).astype(np.int8)


V = 4        # level-0 columns a stream thread owns, in both dtypes


def units(bf16, y0, x0, h0, w0):
    """The level-0 thread map of one tile: per thread (tx = tid % cols, ty
    = tid // cols) its rows y, y + 1, its V columns from x, and its column
    pairs inside the volume (aggregate.cu: pairs_in).  Arrays over tid."""
    v = V
    cols = TILE // v
    tid = np.arange(pyramid_cuda.aggregate_threads() - 32)  # stream warps
    tx, ty = tid % cols, tid // cols
    y, x = y0 + 2 * ty, x0 + v * tx
    pairs = np.where(y < h0, np.minimum(v // 2, np.maximum(0, (w0 - x) // 2)),
                     0)
    return tid, tx, ty, y, x, pairs


def items(levels, lvl, depth, rows_in, cols_in):
    """The item map of level `lvl` in one chunk (aggregate.cu, stage 2):
    item e merges P parents (k, I, P*J + p), skipped outside the tile's
    in-range part.  -> (k, I, J) arrays of the items that run, and P."""
    sl = TILE >> lvl
    hs = sl >> 1
    p = 2 if levels - lvl >= 2 else 1
    groups = hs // p
    e = np.arange((depth >> (lvl + 1)) * hs * groups)
    j, r2 = e % groups, e // groups
    i, k = r2 % hs, r2 // hs
    run = (2 * i < (rows_in >> lvl)) & (2 * p * j < (cols_in >> lvl))
    return k[run], i[run], j[run], p


class Buffer:
    """The offsets buffer: bytes, a count of writes per byte, and every
    store's (byte address, width)."""

    def __init__(self, size):
        self.bytes = np.zeros(size, np.int8)
        self.writes = np.zeros(size, np.int32)
        self.stores = []

    def store(self, addr, values):
        """Stores of values.shape[-1] bytes at each of `addr` (an array)."""
        width = values.shape[-1]
        idx = addr.reshape(-1, 1) + np.arange(width)
        self.bytes[idx] = values.reshape(-1, width)
        np.add.at(self.writes, idx, 1)
        self.stores += [(int(a), width) for a in addr.reshape(-1)]


def emulate_launch(vol, levels, ops, fast, pow_first, vec, top, buf, base):
    """One K5 launch (levels <= 5) on a (n, d0, h0, w0) float32 array of
    the map type's values: writes `top` (NaN where unwritten) and the
    offsets into `buf` at byte `base` (each level at `arg_offsets`).  The
    level warp runs levels 2..L-1 of chunk c after the stream warps have
    done chunk c + 1, the furthest behind its barriers let it fall."""
    n, d0, h0, w0 = vol.shape
    bf16 = ops.r is rne
    v = V
    cols = TILE // v
    map2, maps, halos, nfloats = pyramid_cuda.aggregate_layout(levels)
    offs, _ = pyramid_cuda.arg_offsets(n, d0, h0, w0, levels)
    kn = d0 >> 1
    tiles_w, tiles_h = -(-w0 // TILE), -(-h0 // TILE)
    cval = np.arange(v)
    half = np.arange(v // 2)
    chunks = list(range(0, d0, CHUNK))
    for b in range(n):
        for t in range(tiles_h * tiles_w):
            y0, x0 = (t // tiles_w) * TILE, (t % tiles_w) * TILE
            rows_in, cols_in = min(TILE, h0 - y0), min(TILE, w0 - x0)
            assert rows_in % 2 ** levels == 0 == cols_in % 2 ** levels
            sm = np.full(nfloats, np.nan, np.float32)  # uninitialised
            for lvl, o in halos.items():
                sm[o:o + (TILE >> lvl) ** 2] = -1.0
            tid, tx, ty, y, x, pairs = units(bf16, y0, x0, h0, w0)
            live = pairs > 0
            even_row = ty % 2 == 0
            partner = tid ^ cols          # the row partner: lane ^ cols
            assert (ty[partner] == ty ^ 1).all() and (tid // 32 ==
                                                       partner // 32).all()
            # (thread, row, column) element indices and their masks.
            rr = y[:, None, None] + np.arange(2)[None, :, None]
            cc = x[:, None, None] + cval[None, None, :]
            inside = np.broadcast_to(cval[None, None, :] // 2
                                     < pairs[:, None, None], rr.shape[:2]
                                     + (v,))
            rr_c, cc_c = np.minimum(rr, h0 - 1), np.minimum(cc, w0 - 1)
            state = dict(prev=np.full(inside.shape, -1.0, np.float32),
                         lo1=np.full((len(tid), v // 2), -1.0, np.float32))
            state["ev1"] = state["lo1"].copy()
            # The ring (VEC): which pair each slot holds.
            ring = [None] * RING
            for k in range(min(RING - 1, kn)):
                ring[k % RING] = k

            def stream(ci):
                """The stream warps on chunk ci: levels 0 and 1."""
                c0 = chunks[ci]
                depth = min(CHUNK, d0 - c0)
                assert depth % 2 ** levels == 0
                for kk in range(depth // 2):
                    k = (c0 >> 1) + kk
                    if vec:
                        if k + RING - 1 < kn:
                            ring[(k + RING - 1) % RING] = k + RING - 1
                        got = ring[k % RING]
                    else:
                        got = k
                    ev = np.where(inside, vol[b, 2 * got][rr_c, cc_c], np.nan)
                    od = np.where(inside, vol[b, 2 * got + 1][rr_c, cc_c],
                                  np.nan)
                    # 1. Level 0.
                    p, off = pool3(state["prev"], ev, od)
                    if pow_first:
                        p = ops.pow(p)
                    state["prev"] = od
                    row = base + offs[0] + ((b * kn + k) * h0 + rr[:, :, 0]) \
                        * w0 + x[:, None]
                    if vec:        # one store of V offsets a row
                        buf.store(row[live], off[live])
                    else:          # a store per column pair in range
                        for c in range(0, v, 2):
                            sel = c // 2 < pairs
                            buf.store(row[sel] + c, off[sel, :, c:c + 2])
                    m1 = ops.quad(p[:, 0, 0::2], p[:, 0, 1::2], p[:, 1, 0::2],
                                  p[:, 1, 1::2])
                    if not fast:
                        m1 = ops.merge_pow(m1)
                    ok = half[None, :] < pairs[:, None]
                    if levels == 1:
                        ti = np.broadcast_to((y >> 1)[:, None], ok.shape)
                        tj = (x >> 1)[:, None] + half[None, :]
                        assert np.isnan(top[b, k][ti[ok], tj[ok]]).all()
                        top[b, k][ti[ok], tj[ok]] = m1[ok]
                        continue
                    if kk % 2 == 0:
                        state["ev1"] = m1
                        continue
                    # 2. Level 1, in registers.
                    p1, off1 = pool3(state["lo1"], state["ev1"], m1)
                    if fast:
                        p1 = ops.pow(p1)
                    state["lo1"] = m1
                    k1, w1 = k >> 1, w0 >> 1
                    a1 = base + offs[1] + ((b * (d0 >> 2) + k1) * (h0 >> 1)
                                           + (y >> 1)) * w1 + (x >> 1)
                    if vec and levels >= 3:      # pairs of threads
                        st = live & (tx % 2 == 0)
                        buf.store(a1[st], np.concatenate(
                            [off1[st], off1[tid[st] ^ 1]], axis=1))
                    elif vec:
                        buf.store(a1[live], off1[live])
                    else:
                        for c in range(v // 2):
                            sel = c < pairs
                            buf.store(a1[sel] + c, off1[sel, c:c + 1])
                    mine = ops.r(p1[:, 0::2] + p1[:, 1::2])
                    other = mine[partner]
                    first = np.where(even_row[:, None], mine, other)
                    second = np.where(even_row[:, None], other, mine)
                    m2 = ops.r(ops.r(first + second) * np.float32(0.25))
                    if not fast:
                        m2 = ops.merge_pow(m2)
                    quarter_c = np.arange(v // 4)
                    ok2 = even_row[:, None] & (2 * quarter_c[None, :]
                                               < pairs[:, None])
                    if levels == 2:
                        ti = np.broadcast_to((y >> 2)[:, None], ok2.shape)
                        tj = (x >> 2)[:, None] + quarter_c[None, :]
                        assert np.isnan(top[b, k1][ti[ok2], tj[ok2]]).all()
                        top[b, k1][ti[ok2], tj[ok2]] = m2[ok2]
                    else:
                        o = (map2[ci % 2] + ((kk >> 1) * (TILE // 4)
                                             + (ty >> 1)) * (TILE // 4)
                             + ((x - x0) >> 2))[:, None] + quarter_c[None, :]
                        sm[o[ok2]] = m2[ok2]

            def level_warp(ci):
                """The level warp on chunk ci: levels 2..L-1, item by item,
                lanes 0..31."""
                c0 = chunks[ci]
                depth = min(CHUNK, d0 - c0)
                for lvl in range(2, levels):
                    sl = TILE >> lvl
                    hs = sl >> 1
                    hl, wl, knl = h0 >> lvl, w0 >> lvl, d0 >> (lvl + 1)
                    k, i, j, p = items(levels, lvl, depth, rows_in, cols_in)
                    cells = ((2 * i[:, None, None] + np.arange(2)[:, None])
                             * sl + 2 * p * j[:, None, None]
                             + np.arange(2 * p))
                    kb = k[:, None, None]
                    mp = map2[ci % 2] if lvl == 2 else maps[lvl]
                    lo = np.where(kb > 0,
                                  sm[mp + np.maximum(2 * kb - 1, 0) * sl * sl
                                     + cells],
                                  sm[halos[lvl] + cells])
                    ev = sm[mp + 2 * kb * sl * sl + cells]
                    od = sm[mp + (2 * kb + 1) * sl * sl + cells]
                    pooled, off = pool3(lo, ev, od)
                    if fast:
                        pooled = ops.pow(pooled)
                    addr = base + offs[lvl] + (
                        ((b * knl + (c0 >> (lvl + 1)) + k[:, None]) * hl
                         + (y0 >> lvl) + 2 * i[:, None] + np.arange(2))
                        * wl + (x0 >> lvl) + 2 * p * j[:, None])
                    buf.store(addr, off)
                    m = ops.quad(pooled[:, 0, 0::2], pooled[:, 0, 1::2],
                                 pooled[:, 1, 0::2], pooled[:, 1, 1::2])
                    if not fast:
                        m = ops.merge_pow(m)
                    col = p * j[:, None] + np.arange(p)
                    if lvl + 1 == levels:
                        tk = np.broadcast_to(((c0 >> levels) + k)[:, None],
                                             col.shape)
                        ti = np.broadcast_to(((y0 >> levels) + i)[:, None],
                                             col.shape)
                        tj = (x0 >> levels) + col
                        assert np.isnan(top[b][tk, ti, tj]).all()
                        top[b][tk, ti, tj] = m
                    else:
                        sm[maps[lvl + 1] + (k[:, None] * hs + i[:, None])
                           * hs + col] = m
                # Every level's halo: the chunk's last odd plane.
                for lvl in range(2, levels):
                    s2 = (TILE >> lvl) ** 2
                    mp = map2[ci % 2] if lvl == 2 else maps[lvl]
                    last = mp + ((depth >> lvl) - 1) * s2
                    sm[halos[lvl]:halos[lvl] + s2] = sm[last:last + s2]

            for ci in range(len(chunks)):
                stream(ci)
                if levels > 2 and ci >= 1:
                    level_warp(ci - 1)
            if levels > 2:
                level_warp(len(chunks) - 1)


def emulate(vol, levels, lam, fast, bf16, misaligned=False):
    """K5 through its wrapper's launches: -> (top, args, buffer)."""
    n, d0, h0, w0 = vol.shape
    ops = Ops(bf16, np.float32(pool.map_lam(
        lam, torch.bfloat16 if bf16 else torch.float32)))
    offs, size = pyramid_cuda.arg_offsets(n, d0, h0, w0, levels)
    buf = Buffer(size)
    cur, first = vol, 0
    assert pyramid_cuda.aggregate_launches(levels) == -(-levels // MAXL)
    while first < levels:
        lv = min(levels - first, MAXL)
        d, h, w = cur.shape[1:]
        out = np.full((n, d >> lv, h >> lv, w >> lv), np.nan, np.float32)
        vec = pyramid_cuda.aggregate_vec(
            w, torch.bfloat16 if bf16 else torch.float32,
            1 if misaligned and first == 0 else 0)
        emulate_launch(cur, lv, ops, fast, fast and first > 0, vec, out,
                       buf, offs[first])
        cur, first = out, first + lv
    args = [buf.bytes[o:o + n * (d0 >> (l + 1)) * (h0 >> l) * (w0 >> l)]
            .reshape(n, d0 >> (l + 1), h0 >> l, w0 >> l)
            for l, o in enumerate(offs)]
    return cur, args, buf


def volume(seed, shape, bf16, ties):
    """relu'd normal costs (many exact zeros) or quarter steps 0..1.25
    (ties everywhere), rounded to bf16 for the bf16 instance."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 6, shape) / 4 if ties
         else np.maximum(rng.standard_normal(shape), 0.0)).astype(np.float32)
    return rne(x) if bf16 else x


SHAPES = [
    # n, d0, h0, w0, levels
    (2, 64, 32, 64, 5),      # whole tiles, two chunks
    (1, 32, 64, 32, 5),      # D0 = 2^L: one chunk, one top plane
    (1, 96, 64, 96, 5),      # three chunks; 2 x 3 tiles
    (1, 48, 48, 80, 4),      # D0 not a multiple of 32; ragged tiles (16 rows)
    (2, 16, 16, 16, 4),      # D0 = 2^L, one partial tile
    (1, 40, 40, 24, 3),      # D0 = 40: a last chunk of 8; ragged both ways
    (1, 8, 8, 48, 3),        # D0 = 2^L
    (1, 36, 12, 36, 2),      # D0 = 36; W0 = 4 mod 8: bf16 narrow form
    (2, 6, 6, 10, 1),        # L = 1, W0 = 2 mod 4: narrow form
    (1, 66, 4, 70, 1),       # L = 1: a last chunk of 2 planes, 3 tiles
    (1, 64, 64, 64, 6),      # two launches: levels 0-4, then level 5
    (1, 128, 128, 128, 7),   # two launches: levels 0-4, then 5-6
]


@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("n,d0,h0,w0,levels", SHAPES)
def test_schedule_rebuilds_the_plain_aggregation(n, d0, h0, w0, levels,
                                                 fast, bf16, ties, value_pow):
    """The emulated launch(es) bitwise `aggregate_dmajor_torch`: the top
    map and every level's offsets, each written exactly once, each store
    aligned to its width (4-byte offsets where the level allows)."""
    cost = volume(n * 1000 + d0 + h0 + w0 + levels, (n, d0, h0, w0), bf16,
                  ties)
    top, args, buf = emulate(cost, levels, LAM, fast, bf16)
    vol = torch.from_numpy(cost)
    if bf16:
        vol = vol.to(torch.bfloat16)
        assert np.array_equal(vol.float().numpy(), cost)
    wtop, wargs = pyramid_cuda.aggregate_dmajor_torch(vol, levels, LAM, fast)
    assert not np.isnan(top).any()
    np.testing.assert_array_equal(top, wtop.float().numpy())
    assert len(args) == len(wargs) == levels
    for a, w in zip(args, wargs):
        np.testing.assert_array_equal(a, w.numpy())
    offs, _ = pyramid_cuda.arg_offsets(n, d0, h0, w0, levels)
    for lvl, o in enumerate(offs):     # every byte of every level written
        size = n * (d0 >> (lvl + 1)) * (h0 >> lvl) * (w0 >> lvl)
        assert (buf.writes[o:o + size] == 1).all()
        assert o % 16 == 0
    for addr, width in buf.stores:
        assert addr % width == 0, (addr, width)
    widths = {w for _, w in buf.stores}
    if pyramid_cuda.aggregate_vec(w0, vol.dtype, 0):
        assert 4 in widths     # level 0: one store a row
    if levels >= 3:
        assert 4 in widths     # levels <= L - 2: four offsets a store
    # ... and the wrapper runs the plain version on a CPU tensor.
    gtop, gargs = pyramid_cuda.aggregate_dmajor(vol, levels, LAM, fast)
    assert torch.equal(gtop, wtop)
    assert all(torch.equal(a, b) for a, b in zip(gargs, wargs))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_misaligned_base_takes_the_narrow_form(bf16, value_pow):
    """A volume off 16-byte alignment: element loads and pair stores, the
    same outputs."""
    cost = volume(5, (1, 32, 32, 64), bf16, True)
    for fast in (False, True):
        a, args_a, buf_a = emulate(cost, 5, LAM, fast, bf16)
        b, args_b, buf_b = emulate(cost, 5, LAM, fast, bf16, misaligned=True)
        np.testing.assert_array_equal(a, b)
        for x, y in zip(args_a, args_b):
            np.testing.assert_array_equal(x, y)
        level0 = pyramid_cuda.arg_offsets(1, 32, 32, 64, 5)[0][1]
        assert {w for addr, w in buf_b.stores if addr < level0} == {2}
        assert {w for addr, w in buf_a.stores if addr < level0} == {V}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_thread_map_owns_every_cell_once(bf16):
    """Each in-range level-0 cell of a ragged tile belongs to exactly one
    thread, in whole quads (2 rows x column pairs); consecutive threads
    own consecutive 4-column words of a row (coalesced)."""
    h0, w0 = 48, 40            # tiles of 32x32, 32x8, 16x32, 16x8 cells
    v = V
    owned = np.zeros((h0, w0), int)
    for y0 in range(0, h0, TILE):
        for x0 in range(0, w0, TILE):
            tid, tx, ty, y, x, pairs = units(bf16, y0, x0, h0, w0)
            assert (y % 2 == 0).all() and (x % v == 0).all()
            for yy, xx, pp in zip(y, x, pairs):
                owned[yy:yy + 2, xx:xx + 2 * pp] += 1
            # lanes tid and tid + 1 of one row read adjacent words
            same = ty[1:] == ty[:-1]
            assert (x[1:][same] == x[:-1][same] + v).all()
    assert (owned == 1).all()


def test_bf16_lanes_copy_the_words_their_warp_reads():
    """bf16 ring: lane l of warp w copies the 16-byte chunk (row 8w + l/4,
    columns 8 (l % 4) ..) of each plane into 8-byte words 2l, 2l + 1 of the
    warp's plane block; thread (tx, ty) of that warp reads word (2 (ty % 4)
    + r) * 8 + tx for its row 2 ty + r: the same bytes of the volume."""
    for wid in range(4):
        copied = {}
        for lane in range(32):
            row, col = 8 * wid + lane // 4, 8 * (lane % 4)
            for h in range(2):          # the chunk's two 8-byte words
                copied[2 * lane + h] = (row, col + 4 * h)
        for tid in range(32 * wid, 32 * wid + 32):
            tx, ty = tid % 8, tid // 8
            for r in range(2):
                word = (2 * (ty % 4) + r) * 8 + tx
                assert copied[word] == (2 * ty + r, 4 * tx)
    ring = pyramid_cuda.aggregate_ring_bytes(torch.bfloat16)
    assert ring == RING * 4 * 2 * 512     # kRing x 4 warps x 2 planes x 512 B


def test_items_cover_every_parent_once():
    """Stage 3's items cover each in-range parent of each level 2..L-1
    exactly once per chunk, P = 2 parents (4 offsets a store) at levels
    <= L - 2 and P = 1 at L - 1."""
    for levels in range(3, MAXL + 1):
        for rows_in, cols_in in ((TILE, TILE), (2 ** levels, TILE),
                                 (TILE, 2 ** levels)):
            for lvl in range(2, levels):
                depth = CHUNK
                seen = np.zeros((depth >> (lvl + 1), TILE >> (lvl + 1),
                                 TILE >> (lvl + 1)), int)
                k, i, j, p = items(levels, lvl, depth, rows_in, cols_in)
                assert p == (2 if levels - lvl >= 2 else 1)
                for q in range(p):
                    np.add.at(seen, (k, i, p * j + q), 1)
                hi, wi = rows_in >> (lvl + 1), cols_in >> (lvl + 1)
                assert (seen[:, :hi, :wi] == 1).all()
                assert seen.sum() == seen[:, :hi, :wi].size


@pytest.mark.parametrize("name,n,d0,h0,w0,levels", [
    ("KITTI D=128 x 16", 16, 128, 96, 384, 5),
    ("KITTI D=256 x 8", 8, 256, 96, 384, 5),
    ("dslab bench x 32", 32, 64, 96, 128, 4),
])
def test_block_fits_two_per_sm(name, n, d0, h0, w0, levels):
    """The block's shared memory (its ring, 4 pairs x 64 B a thread, and
    levels 2..L-1 of one 32-plane chunk with their halos: 35,440 B float32
    and 19,056 B bf16 at L = 5, whatever D0) and threads (128 float32, 64
    bf16) let an SM hold at least two blocks (six and eleven by shared
    memory); the grid at the routed shapes has more blocks than the card
    has SMs, in one launch."""
    assert pyramid_cuda.aggregate_layout(5)[3] == (
        2 * 8 * 64 + 4 * 16 + 2 * 4 + 64 + 16 + 4) == 1180
    threads = pyramid_cuda.aggregate_threads()
    for dt, ring, by_smem in ((torch.float32, 32768, 6),
                              (torch.bfloat16, 16384, 10)):
        smem = pyramid_cuda.aggregate_smem_bytes(levels, dt)
        assert pyramid_cuda.aggregate_ring_bytes(dt) == ring == \
            RING * 4 * (16 if dt == torch.float32 else 8) * (threads - 32)
        assert smem <= TWO_PER_SM and smem % 16 == 0
        assert smem == pyramid_cuda.aggregate_smem_bytes(levels + 7, dt) \
            or levels < MAXL
        assert threads == 160    # four stream warps and the level warp
        assert 228 * 1024 // (smem + 1024) >= by_smem
    assert pyramid_cuda.aggregate_blocks(n, h0, w0) >= 2 * 132
    assert pyramid_cuda.aggregate_launches(levels) == 1


def test_arg_offsets_are_aligned_views():
    offs, size = pyramid_cuda.arg_offsets(3, 24, 8, 12, 3)
    sizes = [3 * 12 * 8 * 12, 3 * 6 * 4 * 6, 3 * 3 * 2 * 3]
    assert offs == [0, 3456, 3456 + 432] and size == 3456 + 432 + 64
    assert all(o % 16 == 0 for o in offs)
    assert all(b - a >= s for a, b, s in zip(offs, offs[1:] + [size],
                                              sizes))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("levels,d,h0,w0", [(3, 128, 16, 32),
                                            (5, 96, 32, 64)])
def test_plain_aggregate_matches_slabs_over_many_slabs(levels, d, h0, w0,
                                                       fast):
    """Plain K5 vs pyramid_pallas.aggregate_slabs (interpret mode) where
    D0 spans 3-4 of its 32-plane slabs, each slab threading its halos:
    the offsets bitwise, the top map to rtol 1e-5 (pow across libraries);
    JAX keeps full-resolution duplicated cells, subsampled here."""
    rng = np.random.default_rng(levels * d)
    cost = np.maximum(rng.standard_normal((d, h0, w0)), 0.0).astype(
        np.float32)
    assert pyramid_pallas.slab_supported(d, h0, w0, levels)
    assert d // pyramid_pallas._SLAB >= 3
    wtop, wargs = pyramid_pallas.aggregate_slabs(jnp.asarray(cost), levels,
                                                 LAM, fast=fast)
    gtop, gargs = pyramid_cuda.aggregate_dmajor(torch.from_numpy(cost),
                                                levels, LAM, fast)
    s = 2 ** levels
    np.testing.assert_allclose(gtop.numpy(), np.asarray(wtop)[:, ::s, ::s],
                               rtol=1e-5)
    for lvl, (ga, wa) in enumerate(zip(gargs, wargs)):
        sl = 2 ** lvl
        np.testing.assert_array_equal(
            ga.numpy(), np.asarray(wa.astype(jnp.int32))[:, ::sl, ::sl])
