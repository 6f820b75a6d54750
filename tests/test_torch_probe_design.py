"""P3's schedule (csrc/probe.cu:shift_kernel), on the CPU.

P3 runs persistent blocks of 128 threads, each walking (row, copy) items
of the TPU probe's grid (`probe_cuda.shift_grid`), a row staged in one of
two shared-memory buffers while the other is read.  Per repetition a
thread reads its 31 aligned operands, then, product by product in the
TPU order, each of the 88 shifted windows the first time a product needs
it, multiplies and adds without FMA, and stores its total.  The mix is
the measurement, so these tests emulate that read order, count its reads
and its floating-point operations per repetition and output element (31
+ 88 reads, 256 multiplies, 255 adds: the first plane starts the total),
hold its output bitwise to `shift_torch`, and check the item walk: every
item once, no block more than one item behind another.  chip_smoke.py holds the kernel's SASS to the same
counts and its output to the plain version on the card.
"""

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu_torch.ops import probe_cuda
from deepmatching_stereo_matching_tpu_torch import work

W0, NSRC = probe_cuda.W0, probe_cuda.NSRC
ROWS, SHIFT_W = probe_cuda.SHIFT_ROWS, probe_cuda.SHIFT_W


class Row:
    """One staged row, (32, 160) floats, counting the thread's reads."""

    def __init__(self, a, row):
        self.data = np.ascontiguousarray(a[:, row, :])
        self.reads = 0

    def read(self, j, col):
        self.reads += 1
        return self.data[j, col]


class Counter:
    def __init__(self):
        self.fmul = self.fadd = 0

    def mul(self, x, y):
        self.fmul += 1
        return np.multiply(x, y, dtype=np.float32)

    def add(self, x, y):
        self.fadd += 1
        return np.add(x, y, dtype=np.float32)


def repetition(row, ops):
    """One repetition of every thread c of a block (columns vectorised),
    in the kernel's order: the aligned operands, then the products, each
    window read at its first product."""
    c = np.arange(W0)
    x = [row.read(j, c) for j in range(31)]
    w = {}
    total = None
    for d in range(probe_cuda.NPLANES):
        acc = None
        for i in range(4):
            k = 4 * d + i
            j1, j2, o = probe_cuda.TRIPS[k]
            if k < probe_cuda.SHIFT_WINDOW_READS:
                w[k] = row.read(j2, c + o)
            t = ops.mul(x[j1], w[k % probe_cuda.SHIFT_WINDOW_READS])
            acc = t if acc is None else ops.add(acc, t)
        total = acc if total is None else ops.add(total, acc)
    return total


def test_read_order_rebuilds_shift_torch_with_the_mix():
    """Every output row bitwise `shift_torch`'s; per repetition and output
    element 31 + 88 shared-memory reads, 256 multiplies and 255 adds (the
    8 operations a plane that the bound counts, less the add of the first
    plane into a zero total)."""
    a = probe_cuda.make_input("shift").numpy()
    want = probe_cuda.shift_torch(probe_cuda.make_input("shift"), 1).numpy()
    for r in range(ROWS):
        row, ops = Row(a, r), Counter()
        got = repetition(row, ops)
        np.testing.assert_array_equal(got, want[r])
        assert row.reads == (probe_cuda.SHIFT_ALIGNED_READS
                             + probe_cuda.SHIFT_WINDOW_READS) == 119
        assert (ops.fmul, ops.fadd) == (probe_cuda.SHIFT_FMUL,
                                        probe_cuda.SHIFT_FADD) == (256, 255)
    assert (ops.fmul + ops.fadd) == probe_cuda.FLOPS_PER_PLANE * \
        probe_cuda.NPLANES - 1


def test_windows_and_operands_stay_inside_the_row():
    """The aligned reads stay in columns 0..127 of planes 0..30, and the
    windows in the 160-column row: 128 + 11 <= 160."""
    assert max(j for j, _, _ in probe_cuda.TRIPS) == 30
    assert max(c + o for _, _, o in probe_cuda.TRIPS
               for c in (W0 - 1,)) < SHIFT_W
    # each window (j2, o) is read once per repetition: products k and
    # k + 88 share it
    firsts = {}
    for k, (_, j2, o) in enumerate(probe_cuda.TRIPS):
        firsts.setdefault((j2, o), k)
    assert sorted(firsts.values()) == list(range(88))


@pytest.mark.parametrize("slots", [132 * 4, 132 * 3, 100, 7])
@pytest.mark.parametrize("inner", [1, 2, 8, 16])
def test_item_walk_covers_the_grid_evenly(slots, inner):
    """Block b walks items b, b + grid, ...: every (row, copy) item of
    the TPU grid once, at most `slots` blocks, none walking more than
    ceil(items / slots) items nor one fewer; a row is staged once per
    item (`l2_bytes`)."""
    _, _, repeats, _ = probe_cuda.PROBES["shift"]
    copies = repeats // inner
    items = ROWS * copies
    grid = probe_cuda.shift_grid(copies, slots)
    assert grid <= slots
    seen = np.zeros(items, int)
    counts = []
    for b in range(grid):
        mine = list(range(b, items, grid))
        counts.append(len(mine))
        seen[mine] += 1
    assert (seen == 1).all()
    each = -(-items // slots)
    assert max(counts) == each and min(counts) >= each - 1
    rows_of = np.arange(items) % ROWS
    assert (np.bincount(rows_of, minlength=ROWS) == copies).all()
    read = work.probe("shift").bytes["read"]
    assert copies * read == (repeats // inner) * read


def test_full_grid_on_the_h100():
    """At the TPU probe's inner of 8: 16 copies of 192 rows, 3072 items on
    132 SMs x 4 blocks: 512 blocks of six items each."""
    _, _, repeats, inner = probe_cuda.PROBES["shift"]
    assert (repeats, inner) == (128, 8)
    assert probe_cuda.shift_grid(repeats // inner, 132 * 4) == 512
