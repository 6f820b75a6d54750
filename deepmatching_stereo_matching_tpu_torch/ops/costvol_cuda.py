"""K2 and K6: the cost-volume kernel (csrc/costvol.cu) in its D-major
and row layouts, and their plain versions.

K2 replaces `deepmatching_stereo_matching_tpu/ops/costvol_pallas.py:
_kernel_dmajor` (via `cost_volume_dmajor`); K6 replaces
`costvol_pallas.py:_kernel` (via `cost_volume` and `cost_volume_slab`,
here one wrapper whose `d_offset` selects the slab).  Both layouts are
one kernel with the same dot-product loop, so a K6 slab is bitwise equal
to the same bins of K2.  What bounds it on the card and how it is laid
out: see the note at the top of csrc/costvol.cu.
"""

from __future__ import annotations

import math

import torch

from . import _build
from . import costvol
from ._dispatch import run_kernel


def _check_descriptors(desc_src: torch.Tensor, desc_tgt: torch.Tensor):
    """(lead, h0, w0, wt, c) of a source/target descriptor pair."""
    *lead, h0, w0, c = desc_src.shape
    wt = desc_tgt.shape[-2]
    if tuple(desc_tgt.shape) != (*lead, h0, wt, c):
        raise ValueError(f"descriptor shapes {tuple(desc_src.shape)} and "
                         f"{tuple(desc_tgt.shape)} do not pair")
    if desc_src.dtype != torch.float32 or desc_tgt.dtype != torch.float32:
        raise NotImplementedError("the cost-volume kernel takes float32 only")
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
    sliding descriptors -> (..., D, H0, W0) f32 D-major cost volume."""
    if not run_kernel(desc_src, desc_tgt):
        return cost_volume_dmajor_torch(desc_src, desc_tgt, disparities,
                                        patch_size, max_disparity, reverse,
                                        origin_offset)
    lead, h0, w0, wt, c = _check_descriptors(desc_src, desc_tgt)
    src = desc_src.contiguous()
    tgt = desc_tgt.contiguous()
    out = torch.empty((*lead, disparities, h0, w0), dtype=torch.float32,
                      device=src.device)
    if out.numel():
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _build.library().dm_costvol_dmajor(
            src.data_ptr(), tgt.data_ptr(), out.data_ptr(), math.prod(lead),
            h0, w0, wt, c, disparities, patch_size, max_disparity,
            int(reverse), origin_offset, stream)
        _build.check(rc, "cost-volume kernel launch")
        cost_volume_dmajor.launches += 1
    return out


cost_volume_dmajor.launches = 0


def cost_volume_rows(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                     disparities: int, patch_size: int, max_disparity: int,
                     reverse: bool = False, origin_offset: int = 0,
                     d_offset: int = 0) -> torch.Tensor:
    """K6: descriptors as for K2 -> (..., H0, D, W0) f32 row-layout cost
    volume of the global bins [d_offset, d_offset + D)."""
    if not run_kernel(desc_src, desc_tgt):
        return costvol.cost_volume_rows_torch(
            desc_src, desc_tgt, disparities, patch_size, max_disparity,
            reverse, origin_offset, d_offset)
    lead, h0, w0, wt, c = _check_descriptors(desc_src, desc_tgt)
    src = desc_src.contiguous()
    tgt = desc_tgt.contiguous()
    out = torch.empty((*lead, h0, disparities, w0), dtype=torch.float32,
                      device=src.device)
    if out.numel():
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _build.library().dm_costvol_rows(
            src.data_ptr(), tgt.data_ptr(), out.data_ptr(), math.prod(lead),
            h0, w0, wt, c, disparities, patch_size, max_disparity,
            int(reverse), origin_offset, d_offset, stream)
        _build.check(rc, "row cost-volume kernel launch")
        cost_volume_rows.launches += 1
    return out


cost_volume_rows.launches = 0


def cost_volume(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                disparities: int, patch_size: int, max_disparity: int,
                reverse: bool = False, origin_offset: int = 0,
                d_offset: int = 0) -> torch.Tensor:
    """K6 as `costvol.cost_volume`: the (..., H0, W0, D) D-minor view of
    the row-layout volume (JAX's `costvol_pallas.cost_volume` contract)."""
    return cost_volume_rows(desc_src, desc_tgt, disparities, patch_size,
                            max_disparity, reverse, origin_offset,
                            d_offset).transpose(-1, -2)
