"""K1/K1b: the fused image->disparity kernel (csrc/fused.cu), K4/K4b: the
image->cost-volume kernel (csrc/costrows.cu), and their plain versions.

K1 replaces `deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_kernel`
(via `_match_rows` / `match_rows`; here `match_planes`) in its patch
form, K1b in its magbin form (grad_hist descriptors as (magnitude, bin)
plane pairs, which `pipeline.one_direction` builds); K4 replaces
`fused_pallas.py:_cost_only_kernel` (via `cost_volume_rows`), the
large-D route's prologue; K4b is K4 in the magbin form, for grad_hist
past K1b's block (the TPU package sends grad_hist there to its descriptor
route).  The TPU kernels' selection-matmul phasing and
split-bf16 scheme were workarounds for Mosaic and the MXU, so
`Config.fused_dot_precision` is accepted and ignored: the kernels read
pixels directly in f32.  K1/K1b and K4/K4b compile one cost block,
csrc/cost.cuh (K4's volume is K1's bitwise witness, K4b's K1b's); what
bounds each on the card: see the notes in the .cu files.

Config.dtype='bfloat16' (K1, K1b, K4 and K4b): the planes stay float32 and
the float32 cost is rounded to bfloat16 once, after the relu and the mask
(fused_pallas.py:_cost_block's `c.astype(dtype)`, in the patch and the
magbin form).  K4/K4b then store a bfloat16 volume, bitwise its float32
volume rounded; K1/K1b pool the rounded costs through a pyramid whose
maps are rounded after each op (pyramid_cuda's plain versions define the
rounding), with the fast rectification in float32 at lam as given, and
return the rounded score widened to float32.  All keep the float32
layouts: K1's levels are floats that hold bfloat16 values, so the
shared-memory mirrors hold for either dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import Config, Geometry
from . import _build
from ._dispatch import map_dtype, run_kernel
from .pyramid_cuda import (MAX_SMEM, arg_bytes, level_floats, pyramid_body,
                           scratch_bytes)

_EPS = 1e-8
# Mirrors csrc/costrows.cu: K4's tile is COST_TILE_W patch columns (one
# warp) by the first of COST_TILE_ROWS patch rows of which two blocks fit
# an SM (TWO_PER_SM bytes each: an H100 SM's 233,472 B of shared memory
# over two blocks, less the 1 KB reserved per block).
COST_TILE_W = 32
COST_TILE_ROWS = (8, 4, 2, 1)
TWO_PER_SM = 233472 // 2 - 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(p: int, d0: int, max_d: int, levels: int,
               magbin: bool = False) -> int:
    """Shared memory of one K1/K1b block (csrc/fused.cu:fused_layout): the
    staged tile (left rows, the right strip from a 4-aligned column, the
    window and patch norms, the bin planes as bytes for grad_hist), the
    pyramid levels 1..L, the level-0 pool offsets at 2 bits and those of
    levels 1..L-1 at one byte.  No level-0 volume.  A mirror, so that
    routing needs no build; chip_smoke.py holds it to the library's own
    `dm_fused_smem`."""
    t = 2 ** levels
    rows = lw = p * t
    lead = _round_up(max_d - 1, 4) if lw % 4 == 0 else max_d + 2
    right = _round_up(lw + lead, 4)
    strides = (_round_up(lw, 4), right | 4, ((right + 15) & ~31) + 16)
    floats = (rows * (strides[0] + strides[1]) + t * strides[2] + t * t
              + level_floats(d0, t, levels))
    bins = rows * (_round_up(lw, 16) + 4 * (_round_up(right // 4, 4) | 4))
    kn = d0 // 2
    args = (kn + 3) // 4 * t * t + arg_bytes(d0, t, levels) - kn * t * t
    return _round_up(4 * floats + (bins if magbin else 0) + args, 16)


def route_bytes(p: int, d0: int, max_d: int, levels: int,
                magbin: bool = False) -> int:
    """Shared memory of a block that holds the whole (D0, T, T) level-0
    tile beside the larger of the staged tile (bins as f32) and the
    pyramid scratch: the kernel's earlier layout.  K1/K1b take only the
    configurations such a block fits, so routing stays as it was: a
    configuration that only the volume-free layout fits (450x375 at
    max_disparity 192 and levels 4, say) still goes to K4 -> K5 or the
    `exact` route."""
    t = 2 ** levels
    lw = p * t
    rw = lw + max_d - 1
    images = ((2 if magbin else 1) * p * t * (lw + rw) + t * (rw - p + 1)
              + t * t)
    scratch = (max(images, scratch_bytes(d0, t, levels) // 4) + 3) & ~3
    return 4 * (d0 * t * t + scratch)


def cost_route_bytes(p: int, max_d: int) -> int:
    """Shared memory of a block of K4's earlier layout: 8 x 32 patches,
    the left pixels, the right strip from column p*x0 - (max_d - 1) and
    both norms, unpadded.  K4 takes the configurations such a block fits,
    so its routing stays as it was."""
    th, tw = 8, 32
    lw = p * tw
    rw = lw + max_d - 1
    return 4 * (p * th * (lw + rw) + th * (rw - p + 1) + th * tw)


def _cost_layout_bytes(p: int, max_d: int, th: int,
                       magbin: bool = False) -> int:
    lw = p * COST_TILE_W
    right = _round_up(lw + _round_up(max_d - 1, 4), 4)
    rs, is_ = right | 4, ((right + 15) & ~31) + 16
    floats = _round_up(4 * (p * th * (lw + rs) + th * is_), 16)
    if not magbin:
        return floats
    bins = p * th * (_round_up(lw, 16) + 4 * (_round_up(right // 4, 4) | 4))
    return _round_up(floats + bins, 16)


def cost_tile_rows(p: int, max_d: int, magbin: bool = False) -> int:
    """Patch rows of K4's (K4b's) tile: the first of COST_TILE_ROWS whose
    block fits two per SM (the last, 1, otherwise)."""
    return next((th for th in COST_TILE_ROWS
                 if _cost_layout_bytes(p, max_d, th, magbin) <= TWO_PER_SM),
                1)


def cost_smem_bytes(p: int, max_d: int, magbin: bool = False) -> int:
    """Shared memory of one K4 block (csrc/costrows.cu:rows_layout): the
    tile's left pixel rows, the right strip from a 4-aligned column at a
    stride of 4 mod 8 floats and its window norms at 16 mod 32; with
    magbin, one K4b block: the same floats, then the bin planes as bytes,
    left rows at a multiple of 16 bytes and the strip at 4 mod 8 words.
    A mirror of `dm_cost_rows_smem`, which chip_smoke.py holds it to, and
    of `dm_cost_rows_magbin_smem`, which tests/test_torch_cost_magbin_card.py
    (test_layout_mirror_and_occupancy) holds it to."""
    return _cost_layout_bytes(p, max_d, cost_tile_rows(p, max_d, magbin),
                              magbin)


def cost_blocks_per_sm(p: int, max_d: int, bf16: bool = False,
                       magbin: bool = False) -> int:
    """Blocks of K4 (K4b with magbin), its float32 or bfloat16 instance,
    that one SM of the current card holds at (p, max_d) (CUDA's occupancy
    calculator, through `dm_cost_rows_blocks_per_sm` /
    `dm_cost_rows_magbin_blocks_per_sm`).  Needs the card."""
    lib = _build.library()
    fn = (lib.dm_cost_rows_magbin_blocks_per_sm if magbin
          else lib.dm_cost_rows_blocks_per_sm)
    n = fn(p, max_d, int(bf16))
    if n < 0:
        _build.check(-n, "cost-volume rows kernel occupancy")
    return n


def _magbin(cfg: Config) -> bool:
    return cfg.descriptor == "grad_hist"


def supported(cfg: Config, geom: Geometry) -> bool:
    """True when K1 (patch) or K1b (grad_hist), in either dtype, covers
    this configuration: not centred, a patch grid and D0 aligned to the
    2^L quadtree tile, and `route_bytes` (which bounds `smem_bytes`)
    inside one block's shared memory — the KITTI large-D geometry is
    not."""
    if cfg.center_descriptors:
        return False
    unit = 2 ** geom.levels
    if geom.grid_h % unit or geom.grid_w % unit or geom.disparities % unit:
        return False
    shape = (cfg.patch_size, geom.disparities, cfg.max_disparity,
             geom.levels, _magbin(cfg))
    return max(route_bytes(*shape), smem_bytes(*shape)) <= MAX_SMEM


def blocks_per_sm(cfg: Config, geom: Geometry) -> int:
    """Blocks of K1 (patch) or K1b (grad_hist), the instance of
    cfg.dtype, that one SM of the current card holds at this
    configuration (CUDA's occupancy calculator, through
    `dm_fused_blocks_per_sm`).  Needs the card."""
    n = _build.library().dm_fused_blocks_per_sm(
        cfg.patch_size, geom.disparities, cfg.max_disparity, geom.levels,
        int(_magbin(cfg)), int(_bf16(cfg)))
    if n < 0:
        _build.check(-n, "fused kernel occupancy")
    return n


def cost_supported(cfg: Config, geom: Geometry) -> bool:
    """True when K4 (patch) or K4b (grad_hist) covers this configuration:
    not centred, and inside one block's shared memory (any grid; ragged
    edges are masked): for K4 `cost_route_bytes`, its earlier layout's
    bytes, so that its routing stays as it was; for K4b its own layout,
    `cost_smem_bytes(..., magbin=True)`.  Either dtype."""
    if cfg.center_descriptors:
        return False
    p, max_d = cfg.patch_size, cfg.max_disparity
    if _magbin(cfg):
        return cost_smem_bytes(p, max_d, magbin=True) <= MAX_SMEM
    return cost_route_bytes(p, max_d) <= MAX_SMEM


def cost_volume_torch(left: torch.Tensor, right: torch.Tensor,
                      cfg: Config, geom: Geometry,
                      left_bin: Optional[torch.Tensor] = None,
                      right_bin: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(..., Hp, Wp) padded planes -> (..., D0, H0, W0) cost volume with
    the kernels' algebraic normalisation: relu(raw * invL * invR).  The
    planes are the pixels (patch), or the gradient magnitudes with their
    orientation bins (grad_hist: raw sums mag_L * mag_R where the bins
    are equal)."""
    p, d0, max_d = cfg.patch_size, geom.disparities, cfg.max_disparity
    *lead, hp, wp = left.shape
    h0, w0 = hp // p, wp // p
    lpatch = left.reshape(*lead, h0, p, w0, p)             # [i, dr, j, dc]
    invl = 1.0 / (lpatch * lpatch).sum(-1).sum(-2).sqrt().clamp_min(_EPS)
    rrows = right.reshape(*lead, h0, p, wp)                # [i, dr, x]
    col = (rrows * rrows).sum(-2)                          # over patch rows
    invr = 1.0 / col.unfold(-1, p, 1).sum(-1).sqrt().clamp_min(_EPS)
    rwin = rrows.unfold(-1, p, 1)                          # [i, dr, x0, dc]
    if left_bin is not None:
        lbpatch = left_bin.reshape(*lead, h0, p, w0, p)
        rbwin = right_bin.reshape(*lead, h0, p, wp).unfold(-1, p, 1)
    jj = torch.arange(w0, device=left.device)
    zero = torch.zeros((*lead, h0, w0), dtype=left.dtype, device=left.device)
    planes = []
    for d in range(d0):
        if d >= max_d:
            planes.append(zero)
            continue
        x0 = (p * jj - d).clamp_min(0)
        prod = lpatch * rwin.index_select(-2, x0)
        if left_bin is not None:
            prod = torch.where(lbpatch == rbwin.index_select(-2, x0), prod,
                               torch.zeros((), dtype=prod.dtype,
                                           device=prod.device))
        raw = prod.sum(-1).sum(-2)
        corr = raw * invl * invr.index_select(-1, x0)
        planes.append(torch.where(p * jj >= d, corr.clamp_min(0.0), zero))
    return torch.stack(planes, dim=-3)


def match_planes_torch(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                       geom: Geometry, left_bin: Optional[torch.Tensor] = None,
                       right_bin: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1/K1b: the cost volume above, rounded to
    cfg.dtype, through the fast pyramid (deferred power rectification,
    lam in float32)."""
    cost = cost_volume_torch(left, right, cfg, geom, left_bin, right_bin)
    return pyramid_body(cost.to(map_dtype(cfg.dtype)), geom.levels, cfg.lam,
                        fast=True)


def _check_pair(left: torch.Tensor, right: torch.Tensor,
                geom: Geometry) -> None:
    if tuple(right.shape) != tuple(left.shape):
        raise ValueError(f"left/right shapes differ: {tuple(left.shape)} "
                         f"vs {tuple(right.shape)}")
    if tuple(left.shape[-2:]) != (geom.padded_height, geom.padded_width):
        raise ValueError(f"padded pair {tuple(left.shape[-2:])} does not "
                         f"match geometry "
                         f"{(geom.padded_height, geom.padded_width)}")


def _bf16(cfg: Config) -> bool:
    return map_dtype(cfg.dtype) == torch.bfloat16


def _check_planes(*tensors: torch.Tensor) -> None:
    """The kernels take float32 planes, in either Config.dtype."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise NotImplementedError("the fused kernels take float32 planes")


def match_planes(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                 geom: Geometry, left_bin: Optional[torch.Tensor] = None,
                 right_bin: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hp, Wp) f32 padded planes -> (disp int32, score f32),
    (..., H0, W0), one pair-direction per leading index: K1 on pixel
    pairs (patch), K1b on (magnitude, bin) pairs (grad_hist; the bins are
    integers 0..7 held as f32, and K1b stages them as bytes); each in its
    bfloat16 instance where cfg.dtype says so."""
    p = cfg.patch_size
    *lead, hp, wp = left.shape
    planes = [x for x in (left, right, left_bin, right_bin) if x is not None]
    for x in planes[1:]:
        _check_pair(left, x, geom)
    if ((left_bin is None) != (right_bin is None)
            or (left_bin is not None) != _magbin(cfg)):
        raise ValueError("bin planes come for both images exactly when "
                         "descriptor='grad_hist'")
    if not run_kernel(*planes):
        return match_planes_torch(left, right, cfg, geom, left_bin,
                                  right_bin)
    _check_planes(*planes)
    if not supported(cfg, geom):
        raise NotImplementedError(
            f"the fused kernel does not cover {cfg} at {geom}")
    n = math.prod(lead)
    lval, rval, lbin, rbin = (x.contiguous() if x is not None else None
                              for x in (left, right, left_bin, right_bin))
    h0, w0 = hp // p, wp // p
    disp = torch.empty((*lead, h0, w0), dtype=torch.int32, device=lval.device)
    score = torch.empty((*lead, h0, w0), dtype=torch.float32,
                        device=lval.device)
    if n:
        kernel = (("K1b" if lbin is not None else "K1")
                  + (" bf16" if _bf16(cfg) else ""))
        _build.launch(
            kernel, "dm_fused_match", lval.device, lval.data_ptr(),
            rval.data_ptr(), lbin.data_ptr() if lbin is not None else None,
            rbin.data_ptr() if rbin is not None else None,
            disp.data_ptr(), score.data_ptr(), n, hp, wp, p,
            geom.disparities, cfg.max_disparity, geom.levels, cfg.lam,
            int(_bf16(cfg)))
    return disp, score


def cost_volume_rows(left_p: torch.Tensor, right_p: torch.Tensor,
                     cfg: Config, geom: Geometry,
                     left_bin: Optional[torch.Tensor] = None,
                     right_bin: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(..., Hp, Wp) f32 padded planes -> (..., D0, H0, W0) D-major cost
    volume in cfg.dtype: K4 on pixel pairs (patch), K4b on (magnitude,
    bin) pairs (grad_hist; the bins are integers 0..7 held as f32, from
    `descriptors.grad_hist_magbin`); in bfloat16 it is the float32 volume
    rounded."""
    p, d0 = cfg.patch_size, geom.disparities
    *lead, hp, wp = left_p.shape
    planes = [x for x in (left_p, right_p, left_bin, right_bin)
              if x is not None]
    for x in planes[1:]:
        _check_pair(left_p, x, geom)
    if ((left_bin is None) != (right_bin is None)
            or (left_bin is not None) != _magbin(cfg)):
        raise ValueError("bin planes come for both images exactly when "
                         "descriptor='grad_hist'")
    dtype = map_dtype(cfg.dtype)
    if not run_kernel(*planes):
        return cost_volume_torch(left_p, right_p, cfg, geom, left_bin,
                                 right_bin).to(dtype)
    _check_planes(*planes)
    if not cost_supported(cfg, geom):
        raise NotImplementedError(
            f"the cost-volume kernel does not cover {cfg} at {geom}")
    n = math.prod(lead)
    left, right = left_p.contiguous(), right_p.contiguous()
    out = torch.empty((*lead, d0, hp // p, wp // p), dtype=dtype,
                      device=left.device)
    if out.numel():
        kernel = (("K4b" if left_bin is not None else "K4")
                  + (" bf16" if _bf16(cfg) else ""))
        symbol, inputs = "dm_cost_rows", (left, right)
        if left_bin is not None:
            symbol = "dm_cost_rows_magbin"
            inputs += (left_bin.contiguous(), right_bin.contiguous())
        _build.launch(kernel, symbol, left.device,
                      *(x.data_ptr() for x in inputs), out.data_ptr(), n, hp,
                      wp, p, d0, cfg.max_disparity, int(_bf16(cfg)))
    return out
