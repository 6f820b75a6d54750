"""K1: the fused image->disparity kernel (csrc/fused.cu) and its plain
version `match_rows_torch`.

Replaces `deepmatching_stereo_matching_tpu/ops/fused_pallas.py:_kernel`
(patch form, via `_match_rows` / `match_rows`).  The TPU kernel's
selection-matmul phasing and split-bf16 scheme were workarounds for
Mosaic and the MXU, so `Config.fused_dot_precision` is accepted and
ignored: the kernel reads pixels directly in f32.  What bounds it on the
card and how it is laid out: see the note at the top of csrc/fused.cu.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from deepmatching_stereo_matching_tpu.config import Config, Geometry

from . import _build
from ._dispatch import run_kernel
from .pyramid_cuda import MAX_SMEM, pyramid_body, scratch_bytes

_EPS = 1e-8


def smem_bytes(p: int, d0: int, max_d: int, levels: int) -> int:
    """Shared memory of one K1 block (mirrors csrc/fused.cu:fused_layout)."""
    t = 2 ** levels
    pt = p * t
    rw = pt + max_d - 1
    nwin = rw - p + 1
    images = pt * pt + pt * rw + t * nwin + t * t
    scratch = (max(images, scratch_bytes(d0, t, levels) // 4) + 3) & ~3
    return 4 * (d0 * t * t + scratch)


def supported(cfg: Config, geom: Geometry) -> bool:
    """True when the fused kernel covers this configuration: patch
    descriptors, not centred, float32, a patch grid and D0 aligned to the
    2^L quadtree tile, and the tile's working set inside one block's
    shared memory (the KITTI large-D route is not)."""
    if (cfg.descriptor != "patch" or cfg.center_descriptors
            or cfg.dtype != "float32"):
        return False
    unit = 2 ** geom.levels
    if geom.grid_h % unit or geom.grid_w % unit or geom.disparities % unit:
        return False
    return smem_bytes(cfg.patch_size, geom.disparities, cfg.max_disparity,
                      geom.levels) <= MAX_SMEM


def cost_volume_torch(left_p: torch.Tensor, right_p: torch.Tensor,
                      cfg: Config, geom: Geometry) -> torch.Tensor:
    """(..., Hp, Wp) padded pixels -> (..., D0, H0, W0) cost volume with
    the kernel's algebraic normalisation: relu(raw * invL * invR)."""
    p, d0, max_d = cfg.patch_size, geom.disparities, cfg.max_disparity
    *lead, hp, wp = left_p.shape
    h0, w0 = hp // p, wp // p
    lpatch = left_p.reshape(*lead, h0, p, w0, p)          # [i, dr, j, dc]
    invl = 1.0 / (lpatch * lpatch).sum(-1).sum(-2).sqrt().clamp_min(_EPS)
    rrows = right_p.reshape(*lead, h0, p, wp)              # [i, dr, x]
    col = (rrows * rrows).sum(-2)                          # over patch rows
    invr = 1.0 / col.unfold(-1, p, 1).sum(-1).sqrt().clamp_min(_EPS)
    rwin = rrows.unfold(-1, p, 1)                          # [i, dr, x0, dc]
    jj = torch.arange(w0, device=left_p.device)
    zero = torch.zeros((*lead, h0, w0), dtype=left_p.dtype,
                       device=left_p.device)
    planes = []
    for d in range(d0):
        if d >= max_d:
            planes.append(zero)
            continue
        x0 = (p * jj - d).clamp_min(0)
        raw = (lpatch * rwin.index_select(-2, x0)).sum(-1).sum(-2)
        corr = raw * invl * invr.index_select(-1, x0)
        planes.append(torch.where(p * jj >= d, corr.clamp_min(0.0), zero))
    return torch.stack(planes, dim=-3)


def match_rows_torch(left_p: torch.Tensor, right_p: torch.Tensor,
                     cfg: Config, geom: Geometry
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused kernel: the cost volume above through
    the fast pyramid (deferred power rectification)."""
    return pyramid_body(cost_volume_torch(left_p, right_p, cfg, geom),
                        geom.levels, cfg.lam, fast=True)


def match_rows(left_p: torch.Tensor, right_p: torch.Tensor, cfg: Config,
               geom: Geometry) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hp, Wp) f32 padded pixel pairs -> (disp int32, score f32),
    (..., H0, W0), one pair-direction per leading index."""
    p = cfg.patch_size
    *lead, hp, wp = left_p.shape
    if tuple(right_p.shape) != tuple(left_p.shape):
        raise ValueError(f"left/right shapes differ: {tuple(left_p.shape)} "
                         f"vs {tuple(right_p.shape)}")
    if (hp, wp) != (geom.padded_height, geom.padded_width):
        raise ValueError(f"padded pair {(hp, wp)} does not match geometry "
                         f"{(geom.padded_height, geom.padded_width)}")
    if not run_kernel(left_p, right_p):
        return match_rows_torch(left_p, right_p, cfg, geom)
    if not supported(cfg, geom):
        raise NotImplementedError(
            f"the fused kernel does not cover {cfg} at {geom}")
    if left_p.dtype != torch.float32 or right_p.dtype != torch.float32:
        raise NotImplementedError("the fused kernel takes float32 images")
    n = math.prod(lead)
    left = left_p.contiguous()
    right = right_p.contiguous()
    h0, w0 = hp // p, wp // p
    disp = torch.empty((*lead, h0, w0), dtype=torch.int32, device=left.device)
    score = torch.empty((*lead, h0, w0), dtype=torch.float32,
                        device=left.device)
    if n:
        stream = torch.cuda.current_stream(left.device).cuda_stream
        rc = _build.library().dm_fused_match(
            left.data_ptr(), right.data_ptr(), disp.data_ptr(),
            score.data_ptr(), n, hp, wp, p, geom.disparities,
            cfg.max_disparity, geom.levels, cfg.lam, stream)
        _build.check(rc, "fused kernel launch")
        match_rows.launches += 1
    return disp, score


match_rows.launches = 0
