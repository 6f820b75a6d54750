"""K2: the D-major cost-volume kernel (csrc/costvol.cu) and its plain version.

Replaces `deepmatching_stereo_matching_tpu/ops/costvol_pallas.py:
_kernel_dmajor` (via `cost_volume_dmajor`).  What bounds it on the card
and how it is laid out: see the note at the top of csrc/costvol.cu.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._dispatch import run_kernel
from .costvol import cost_volume


def cost_volume_dmajor_torch(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                             disparities: int, patch_size: int,
                             max_disparity: int, reverse: bool = False,
                             origin_offset: int = 0) -> torch.Tensor:
    """Plain version: `costvol.cost_volume` moved to (..., D, H0, W0)."""
    vol = cost_volume(desc_src, desc_tgt, disparities, patch_size,
                      max_disparity, reverse, origin_offset)
    return vol.movedim(-1, -3).contiguous()


def cost_volume_dmajor(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                       disparities: int, patch_size: int, max_disparity: int,
                       reverse: bool = False, origin_offset: int = 0
                       ) -> torch.Tensor:
    """(..., H0, W0, C) source patches, (..., H0, Wt, C) target sliding
    descriptors -> (..., D, H0, W0) f32 D-major cost volume."""
    if not run_kernel(desc_src, desc_tgt):
        return cost_volume_dmajor_torch(desc_src, desc_tgt, disparities,
                                        patch_size, max_disparity, reverse,
                                        origin_offset)
    *lead, h0, w0, c = desc_src.shape
    wt = desc_tgt.shape[-2]
    if tuple(desc_tgt.shape) != (*lead, h0, wt, c):
        raise ValueError(f"descriptor shapes {tuple(desc_src.shape)} and "
                         f"{tuple(desc_tgt.shape)} do not pair")
    if desc_src.dtype != torch.float32 or desc_tgt.dtype != torch.float32:
        raise NotImplementedError("the cost-volume kernel takes float32 only")
    n = math.prod(lead)
    src = desc_src.contiguous()
    tgt = desc_tgt.contiguous()
    out = torch.empty((*lead, disparities, h0, w0), dtype=torch.float32,
                      device=src.device)
    if out.numel():
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _build.library().dm_costvol_dmajor(
            src.data_ptr(), tgt.data_ptr(), out.data_ptr(), n, h0, w0, wt,
            c, disparities, patch_size, max_disparity, int(reverse),
            origin_offset, stream)
        _build.check(rc, "cost-volume kernel launch")
        cost_volume_dmajor.launches += 1
    return out


cost_volume_dmajor.launches = 0
