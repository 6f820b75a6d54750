"""Level-0 correlation cost volume (C4) in stock torch ops.

Counterpart of the JAX package's `ops/costvol.py`: the semantic anchor
that the 'torch' route runs and the plain version of the cost-volume
kernels (ops/costvol_cuda.py: K2 in the D-major layout, K6 in the row
layout).  Leading batch dimensions are allowed.
"""

from __future__ import annotations

import torch


def cost_volume(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                disparities: int, patch_size: int, max_disparity: int,
                reverse: bool = False, origin_offset: int = 0,
                d_offset: int = 0) -> torch.Tensor:
    """C0[..., i, j, d] = max(0, <src[i, j], tgt[i, p*(j + origin_offset) -+ (d_offset + d)]>).

    Forward (reverse=False): src = left patches, tgt = right sliding
    descriptors, target column p*j - d.  Reverse: target column p*j + d.
    Out-of-range targets and padded bins (d_offset + d >= max_disparity)
    score 0.  The volume covers the global bins [d_offset, d_offset +
    disparities): one disparity slab of a sharded volume.

    Args:
      desc_src: (..., H0, W0, C) normalised source patch descriptors.
      desc_tgt: (..., H0, Wt, C) target sliding descriptors.
    Returns: (..., H0, W0, disparities) in the descriptors' dtype.  In
    bfloat16 the products of the exact float32 widenings (exact) are
    summed in float32 and the relu'd sum is rounded once, as JAX's
    einsum with preferred_element_type=float32 does.
    """
    dt = desc_src.dtype
    src, tgt_all = desc_src.float(), desc_tgt.float()
    w0 = desc_src.shape[-2]
    wt = desc_tgt.shape[-2]
    dev = desc_src.device
    xs = (torch.arange(w0, device=dev) + origin_offset) * patch_size
    planes = []
    for d in range(d_offset, d_offset + disparities):
        x0 = xs + d if reverse else xs - d
        valid = (x0 >= 0) & (x0 < wt) & (d < max_disparity)
        tgt = tgt_all.index_select(-2, x0.clamp(0, wt - 1))
        corr = (src * tgt).sum(-1).clamp_min(0.0).to(dt)
        planes.append(torch.where(valid, corr, torch.zeros_like(corr)))
    return torch.stack(planes, dim=-1)


def cost_volume_rows_torch(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                           disparities: int, patch_size: int,
                           max_disparity: int, reverse: bool = False,
                           origin_offset: int = 0, d_offset: int = 0
                           ) -> torch.Tensor:
    """`cost_volume` in the row layout (..., H0, disparities, W0): the
    plain version of K6 (ops/costvol_cuda.py:cost_volume_rows)."""
    vol = cost_volume(desc_src, desc_tgt, disparities, patch_size,
                      max_disparity, reverse, origin_offset, d_offset)
    return vol.transpose(-1, -2).contiguous()
