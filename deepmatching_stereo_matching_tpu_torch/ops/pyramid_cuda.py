"""K3: the pyramid + backtracking kernel (csrc/pyramid.cu) and its plain
version `pyramid_body`.

Replaces `deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:_kernel`
(via `pyramid_backtrack`).  The device-side pyramid lives in
csrc/pyramid.cuh, which the fused kernel (ops/fused_cuda.py) includes
too; what bounds it on the card: see the note at the top of
csrc/pyramid.cu.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from . import pool
from ._dispatch import run_kernel

# Mirrors csrc/pyramid.cuh (kMaxSmem, level_floats, pyramid_scratch_bytes).
MAX_SMEM = 232448


def level_floats(d0: int, t: int, levels: int) -> int:
    return sum((d0 >> l) * (t >> l) ** 2 for l in range(1, levels + 1))


def scratch_bytes(d0: int, t: int, levels: int) -> int:
    args = sum((d0 >> (l + 1)) * (t >> l) ** 2 for l in range(levels))
    return 4 * level_floats(d0, t, levels) + ((args + 15) & ~15)


def smem_bytes(d0: int, levels: int) -> int:
    """Shared memory of one K3 block: the (D0, T, T) tile + its pyramid."""
    t = 2 ** levels
    return 4 * d0 * t * t + scratch_bytes(d0, t, levels)


def supported(d0: int, levels: int) -> bool:
    """True when one 2^L x 2^L-patch tile's pyramid fits a block."""
    return d0 % (2 ** levels) == 0 and smem_bytes(d0, levels) <= MAX_SMEM


def pyramid_body(cost: torch.Tensor, levels: int, lam: float,
                 fast: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (..., D0, H0, W0) -> (disp int32, score f32), (..., H0, W0).

    fast=False rectifies after every merge (the exact path); fast=True
    defers each level's x**lam past the next level's pool and skips it at
    the top, as the fused kernel does.
    """
    args = []
    cur = cost
    for lvl in range(levels):
        pooled, arg = pool.pool3_subsample_dmajor(cur)
        args.append(arg)
        if fast and lvl > 0:
            pooled = torch.pow(pooled, lam)
        merged = pool.quad_mean(pooled, -2)
        cur = merged if fast else torch.pow(merged, lam)
    k = torch.argmax(cur, dim=-3)                  # first max wins ties
    for arg in reversed(args):
        kr = k.repeat_interleave(2, -2).repeat_interleave(2, -1)
        off = torch.gather(arg, -3, kr.unsqueeze(-3)).squeeze(-3)
        k = 2 * kr + off
    score = torch.gather(cost, -3, k.unsqueeze(-3)).squeeze(-3)
    return k.to(torch.int32), score


def _check_aligned(d0: int, h0: int, w0: int, levels: int) -> None:
    unit = 2 ** levels
    if h0 % unit or w0 % unit or d0 % unit:
        raise ValueError(f"cost volume (D={d0}, H0={h0}, W0={w0}) not "
                         f"aligned to 2**levels={unit}")


def pyramid_backtrack(cost_dm: torch.Tensor, levels: int, lam: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D0, H0, W0) f32 D-major volume -> (disp int32, score f32)."""
    *lead, d0, h0, w0 = cost_dm.shape
    _check_aligned(d0, h0, w0, levels)
    if not run_kernel(cost_dm):
        return pyramid_body(cost_dm, levels, lam, fast=False)
    if not supported(d0, levels):
        raise NotImplementedError(
            f"pyramid kernel: a (D0={d0}, 2^{levels} x 2^{levels}) tile needs "
            f"{smem_bytes(d0, levels)} B of shared memory, more than "
            f"{MAX_SMEM}")
    if cost_dm.dtype != torch.float32:
        raise NotImplementedError("the pyramid kernel takes float32 only")
    n = math.prod(lead)
    cost = cost_dm.contiguous()
    disp = torch.empty((*lead, h0, w0), dtype=torch.int32, device=cost.device)
    score = torch.empty((*lead, h0, w0), dtype=torch.float32,
                        device=cost.device)
    if n:
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        rc = _build.library().dm_pyramid_backtrack(
            cost.data_ptr(), disp.data_ptr(), score.data_ptr(), n, d0, h0,
            w0, levels, lam, stream)
        _build.check(rc, "pyramid kernel launch")
        pyramid_backtrack.launches += 1
    return disp, score


pyramid_backtrack.launches = 0
