"""P1-P3: the streaming mul/add probes (csrc/probe.cu) and their plain
versions.

P1 replaces `tools/vpu_ceiling.py:59 kernel`, P2 `:120 small_kernel`, P3
`:165 shift_kernel`.  Each output element is the sum over 64 planes of
four products of the input's planes, in the schedule below, and the TPU
grid repeated that work GRID, 8 * GRID and 2 * GRID times.  What bounds
the kernels on the card and how the repetitions are kept from merging:
see the note at the top of csrc/probe.cu.  P3 runs persistent blocks over
the (row, copy) items of the TPU probe's grid (`shift_grid`), staging the
next item's row while it computes the current one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._dispatch import run_kernel

NSRC, BP, W0, NPLANES, GRID = 32, 384, 128, 64, 64
SMALL_ROWS = 96
SHIFT_ROWS, SHIFT_W = 192, W0 + 32

# Operand schedules (tools/vpu_ceiling.py:54-55, :161-162): product i of
# plane d is k = 4 d + i.  Every product is a distinct (j1, j2) pair, or a
# distinct (j1, j2, lane offset) triple, so no two can be merged as one.
PAIRS = [((5 * k + 1) % 31, ((3 * k + 7) % 29) + 3)
         for k in range(NPLANES * 4)]
assert len(set(PAIRS)) == len(PAIRS), "mergeable duplicate pairs"
assert max(max(p) for p in PAIRS) < NSRC
TRIPS = [((5 * k + 1) % 31, ((3 * k + 7) % 8) + 3, ((7 * k + 3) % 11) + 1)
         for k in range(NPLANES * 4)]
assert len(set(TRIPS)) == len(TRIPS), "mergeable duplicate triples"
assert max(o for _, _, o in TRIPS) + W0 <= SHIFT_W

# name -> (input shape, output shape, repetitions, repetitions per thread).
PROBES = {
    "stream": ((NSRC, BP, W0), (BP, W0), GRID, 8),
    "small": ((NSRC, BP, W0), (SMALL_ROWS, W0), 8 * GRID, 16),
    "shift": ((NSRC, SHIFT_ROWS, SHIFT_W), (SHIFT_ROWS, W0), 2 * GRID, 8),
}
FLOPS_PER_PLANE = 8   # 4 mul + 3 add + the add into the total, as JAX counts
# A probe's work (bytes and FLOPs) is counted by work.py:probe.


# P3's mix per repetition and output element (csrc/probe.cu:shift_kernel):
# shared-memory reads of the aligned operands and of the shifted windows,
# and float32 multiplies and adds (no FMA).  The first plane starts the
# total, so there is one add fewer than FLOPS_PER_PLANE counts.
SHIFT_ALIGNED_READS, SHIFT_WINDOW_READS = 31, 88
SHIFT_FMUL, SHIFT_FADD = 4 * NPLANES, 4 * NPLANES - 1


def shift_grid(copies: int, slots: int) -> int:
    """Blocks of one P3 launch of `copies` copies of its 192 rows on a
    card holding `slots` blocks at once: those that ceil(items / slots)
    rounds of items need (csrc/probe.cu:shift_grid)."""
    items = SHIFT_ROWS * copies
    each = -(-items // slots)
    return -(-items // each)


def shift_occupancy(copies: int = 2 * GRID // PROBES["shift"][3]):
    """(blocks per SM, blocks of a launch of `copies` copies) of P3 on the
    current card (CUDA's occupancy calculator).  Needs the card."""
    lib = _build.library()
    per_sm, grid = lib.dm_probe_shift_blocks_per_sm(), \
        lib.dm_probe_shift_grid(copies)
    for n in (per_sm, grid):
        if n < 0:
            _build.check(-n, "shift probe occupancy")
    return per_sm, grid


def make_input(name: str, device="cpu") -> torch.Tensor:
    """The TPU probe's input: standard normal f32 from its numpy seed (0
    for P1 and P2, 1 for P3)."""
    seed = 1 if name == "shift" else 0
    a = np.random.default_rng(seed).standard_normal(PROBES[name][0],
                                                    dtype=np.float32)
    return torch.from_numpy(a).to(device)


def _planes_torch(operand, schedule) -> torch.Tensor:
    """sum over planes of the four products, one stock op per product and
    sum, in the kernel's order."""
    total = None
    for d in range(NPLANES):
        acc = None
        for i in range(4):
            t = torch.mul(*operand(*schedule[4 * d + i]))
            acc = t if acc is None else torch.add(acc, t)
        total = acc if total is None else torch.add(total, acc)
    return total


def _repeat(fn, repeats: int) -> torch.Tensor:
    out = None
    for _ in range(repeats):
        out = fn()
    return out


def stream_torch(a: torch.Tensor, repeats: int = GRID) -> torch.Tensor:
    """Plain P1: (32, 384, 128) -> (384, 128), computed `repeats` times."""
    return _repeat(lambda: _planes_torch(lambda j1, j2: (a[j1], a[j2]),
                                         PAIRS), repeats)


def small_torch(a: torch.Tensor, repeats: int = 8 * GRID) -> torch.Tensor:
    """Plain P2: rows [:96] of (32, 384, 128) -> (96, 128)."""
    return _repeat(lambda: _planes_torch(
        lambda j1, j2: (a[j1, :SMALL_ROWS], a[j2, :SMALL_ROWS]), PAIRS),
        repeats)


def shift_torch(a: torch.Tensor, repeats: int = 2 * GRID) -> torch.Tensor:
    """Plain P3: (32, 192, 160) -> (192, 128); each product's second
    operand at lane offset o: a[j1, :, 0:128] * a[j2, :, o:o + 128]."""
    return _repeat(lambda: _planes_torch(
        lambda j1, j2, o: (a[j1, :, :W0], a[j2, :, o:o + W0]), TRIPS),
        repeats)


def _launch(kernel: str, name: str, a: torch.Tensor, repeats: int,
            inner: int) -> torch.Tensor:
    in_shape, out_shape, _, _ = PROBES[name]
    if tuple(a.shape) != in_shape or a.dtype != torch.float32:
        raise ValueError(f"probe {name!r} takes a float32 {in_shape} input, "
                         f"got {a.dtype} {tuple(a.shape)}")
    if inner < 1 or repeats % inner:
        raise ValueError(f"repeats {repeats} must be a multiple of inner "
                         f"{inner} >= 1")
    a = a.contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    _build.launch(kernel, f"dm_probe_{name}", a.device, a.data_ptr(),
                  out.data_ptr(), inner, repeats // inner)
    return out


def stream(a: torch.Tensor, repeats: int = GRID,
           inner: int = PROBES["stream"][3]) -> torch.Tensor:
    """P1 on the card (plain version on the CPU)."""
    if not run_kernel(a):
        return stream_torch(a, repeats)
    return _launch("P1", "stream", a, repeats, inner)


def small(a: torch.Tensor, repeats: int = 8 * GRID,
          inner: int = PROBES["small"][3]) -> torch.Tensor:
    """P2 on the card (plain version on the CPU)."""
    if not run_kernel(a):
        return small_torch(a, repeats)
    return _launch("P2", "small", a, repeats, inner)


def shift(a: torch.Tensor, repeats: int = 2 * GRID,
          inner: int = PROBES["shift"][3]) -> torch.Tensor:
    """P3 on the card (plain version on the CPU)."""
    if not run_kernel(a):
        return shift_torch(a, repeats)
    return _launch("P3", "shift", a, repeats, inner)


KERNELS = {"stream": stream, "small": small, "shift": shift}
PLAIN = {"stream": stream_torch, "small": small_torch, "shift": shift_torch}
