"""K2 and K6: the cost-volume kernel (csrc/costvol.cu) in its D-major
and row layouts, and their plain versions.

K2 replaces `deepmatching_stereo_matching_tpu/ops/costvol_pallas.py:
_kernel_dmajor` (via `cost_volume_dmajor`); K6 replaces
`costvol_pallas.py:_kernel` (via `cost_volume` and `cost_volume_slab`,
here one wrapper whose `d_offset` selects the slab).  Both layouts are
one kernel with the same dot-product loop, so a K6 slab is bitwise equal
to the same bins of K2.  What bounds it on the card and how it is laid
out: see the note at the top of csrc/costvol.cu; `plan` mirrors its
block schedule.

K2 also takes bfloat16 descriptors (Config.dtype='bfloat16' on the
descriptor routes, `costvol_pallas.py:117-118` on bf16 descriptors) and
returns a bfloat16 volume: each bin is the float32 dot of the exact
widenings, relu'd and masked, rounded once.  Its instance widens the
descriptors as it stages them into the float32 layout, so `plan` and
`smem_bytes` hold for both dtypes, and its volume is bitwise the float32
kernel's on the widened descriptors, rounded.  K6 takes float32 only: no
path of the JAX package runs its row-layout volume in bfloat16 (dslab,
ringd and wtiled below the top level build it from float32 descriptors).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from . import costvol
from .pyramid_cuda import MAX_SMEM
from ._dispatch import run_kernel


# Mirrors csrc/costvol.cu: patch columns per warp, warps per block (so
# TILE_J patch columns per block), runs of 32 bins per lane, descriptor
# floats per staged chunk.
COLS_PER_WARP, WARPS, RUNS_MAX, C_CHUNK = 4, 8, 4, 32
TILE_J = COLS_PER_WARP * WARPS


class Plan(NamedTuple):
    """One block's schedule (csrc/costvol.cu:costvol_plan)."""
    skew: int    # (COLS_PER_WARP - 1) * p: a run's shift across a warp
    dc: int      # bins per chunk of d0
    nch: int     # chunks of d0
    nr: int      # runs of 32 bins per lane
    w: int       # target strip columns
    ck: int      # descriptor floats per C chunk
    nck: int     # C chunks
    s: int       # shared row stride in floats, 4 mod 8
    bufs: int    # staging buffers (2: C chunks double-buffered)
    buf: int     # floats per buffer: TILE_J source rows, then w strip rows
    smem: int    # bytes


def plan(c: int, d0: int, p: int) -> Plan:
    """The cost-volume kernel's schedule for descriptors of C floats, d0
    bins and patch size p.  Raises where the tile cannot take p: a run of
    32 * RUNS_MAX bins must cover the skew 3 * p (p <= 42), and the strip
    of 28 * p + 128 columns must fit a block (p <= 23 where C > 32)."""
    skew = (COLS_PER_WARP - 1) * p
    dcmax = 32 * RUNS_MAX - skew
    if dcmax <= 0:
        raise ValueError(f"the cost-volume kernel takes patch sizes up to "
                         f"42, not {p}")
    nch = -(-d0 // dcmax)
    dc = -(-d0 // nch) if nch else 0
    nr = -(-(dc + skew) // 32)
    w = p * (TILE_J - COLS_PER_WARP) + 32 * nr
    ck = min(c, C_CHUNK)
    nck = -(-c // ck)
    s = -(-ck // 4) * 4
    s += 4 if s % 8 == 0 else 0
    bufs = 2 if nck > 1 else 1
    buf = (TILE_J + w) * s
    smem = -(-4 * max(bufs * buf, dc * (TILE_J + 1)) // 16) * 16
    if smem > MAX_SMEM:
        raise ValueError(f"the cost-volume kernel's block would take {smem} "
                         f"B of shared memory at patch size {p} (C = {c}), "
                         f"more than {MAX_SMEM}")
    return Plan(skew, dc, nch, nr, w, ck, nck, s, bufs, buf, smem)


def smem_bytes(c: int, d0: int, p: int) -> int:
    """Shared memory of one block; mirrors `dm_costvol_smem`, and
    chip_smoke.py holds the two equal (0 for no bins, as there)."""
    q = plan(c, d0, p)
    return q.smem if q.nch else 0


def blocks_per_sm(c: int, d0: int, p: int, rows: bool = False,
                  bf16: bool = False) -> int:
    """Blocks of K6 (rows) or K2 (float32, or its bfloat16 instance) that
    one SM of the current card holds (CUDA's occupancy calculator, through
    `dm_costvol_blocks_per_sm`).  Needs the card."""
    n = _build.library().dm_costvol_blocks_per_sm(c, d0, p, int(rows),
                                                  int(bf16))
    if n < 0:
        _build.check(-n, "cost-volume kernel occupancy")
    return n


def _check_descriptors(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                       disparities: int, patch_size: int,
                       rows: bool = False):
    """(lead, h0, w0, wt, c) of a source/target descriptor pair the
    kernel takes: both float32, or both bfloat16 in the D-major layout."""
    *lead, h0, w0, c = desc_src.shape
    wt = desc_tgt.shape[-2]
    if tuple(desc_tgt.shape) != (*lead, h0, wt, c):
        raise ValueError(f"descriptor shapes {tuple(desc_src.shape)} and "
                         f"{tuple(desc_tgt.shape)} do not pair")
    if (desc_src.dtype != desc_tgt.dtype
            or desc_src.dtype not in (torch.float32, torch.bfloat16)):
        raise NotImplementedError(
            f"the cost-volume kernel takes a float32 or bfloat16 descriptor "
            f"pair, not {desc_src.dtype} and {desc_tgt.dtype}")
    if rows and desc_src.dtype == torch.bfloat16:
        raise NotImplementedError(
            "the row-layout cost volume (K6) takes float32 descriptors: no "
            "path of the JAX package runs it in bfloat16")
    plan(c, disparities, patch_size)
    return lead, h0, w0, wt, c


def cost_volume_dmajor_torch(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                             disparities: int, patch_size: int,
                             max_disparity: int, reverse: bool = False,
                             origin_offset: int = 0) -> torch.Tensor:
    """Plain K2: `costvol.cost_volume` moved to (..., D, H0, W0)."""
    vol = costvol.cost_volume(desc_src, desc_tgt, disparities, patch_size,
                              max_disparity, reverse, origin_offset)
    return vol.movedim(-1, -3).contiguous()


def cost_volume_dmajor(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                       disparities: int, patch_size: int, max_disparity: int,
                       reverse: bool = False, origin_offset: int = 0
                       ) -> torch.Tensor:
    """K2: (..., H0, W0, C) source patches, (..., H0, Wt, C) target
    sliding descriptors, both float32 or both bfloat16 -> (..., D, H0, W0)
    D-major cost volume in the descriptors' dtype."""
    if not run_kernel(desc_src, desc_tgt):
        return cost_volume_dmajor_torch(desc_src, desc_tgt, disparities,
                                        patch_size, max_disparity, reverse,
                                        origin_offset)
    lead, h0, w0, wt, c = _check_descriptors(
        desc_src, desc_tgt, disparities, patch_size)
    bf16 = desc_src.dtype == torch.bfloat16
    src = desc_src.contiguous()
    tgt = desc_tgt.contiguous()
    out = torch.empty((*lead, disparities, h0, w0), dtype=src.dtype,
                      device=src.device)
    if out.numel():
        _build.launch("K2 bf16" if bf16 else "K2",
                      "dm_costvol_dmajor_bf16" if bf16 else "dm_costvol_dmajor",
                      src.device, src.data_ptr(), tgt.data_ptr(),
                      out.data_ptr(), math.prod(lead), h0, w0, wt, c,
                      disparities, patch_size, max_disparity, int(reverse),
                      origin_offset)
    return out


def cost_volume_rows(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                     disparities: int, patch_size: int, max_disparity: int,
                     reverse: bool = False, origin_offset: int = 0,
                     d_offset: int = 0) -> torch.Tensor:
    """K6: float32 descriptors as for K2 -> (..., H0, D, W0) f32
    row-layout cost volume of the global bins [d_offset, d_offset + D)."""
    if not run_kernel(desc_src, desc_tgt):
        return costvol.cost_volume_rows_torch(
            desc_src, desc_tgt, disparities, patch_size, max_disparity,
            reverse, origin_offset, d_offset)
    lead, h0, w0, wt, c = _check_descriptors(
        desc_src, desc_tgt, disparities, patch_size, rows=True)
    src = desc_src.contiguous()
    tgt = desc_tgt.contiguous()
    out = torch.empty((*lead, h0, disparities, w0), dtype=torch.float32,
                      device=src.device)
    if out.numel():
        _build.launch("K6", "dm_costvol_rows", src.device, src.data_ptr(),
                      tgt.data_ptr(), out.data_ptr(), math.prod(lead), h0, w0,
                      wt, c, disparities, patch_size, max_disparity,
                      int(reverse), origin_offset, d_offset)
    return out


def cost_volume(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                disparities: int, patch_size: int, max_disparity: int,
                reverse: bool = False, origin_offset: int = 0,
                d_offset: int = 0) -> torch.Tensor:
    """K6 as `costvol.cost_volume`: the (..., H0, W0, D) D-minor view of
    the row-layout volume (JAX's `costvol_pallas.cost_volume` contract)."""
    return cost_volume_rows(desc_src, desc_tgt, disparities, patch_size,
                            max_disparity, reverse, origin_offset,
                            d_offset).transpose(-1, -2)
