"""K3: the pyramid + backtracking kernel (csrc/pyramid.cu), K5: the
level-aggregation kernel (csrc/aggregate.cu), and their plain versions.

K3 replaces `deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:_kernel`
(via `pyramid_backtrack`); its device-side pyramid lives in
csrc/pyramid.cuh, which the fused kernel (ops/fused_cuda.py) includes too.
K5 replaces `pyramid_pallas.py:_slab_kernel` (via `aggregate_slabs`): the
same aggregation on volumes whose quadtree tile does not fit one block's
shared memory (the large-D route), every level in one launch (up to five;
`AGG_MAX_LEVELS`): a block walks D over one 32 x 32 tile, levels 0 and 1
in its stream warps' registers, levels >= 2 in shared memory in a level
warp a chunk behind, and writes only the offsets and the top map.  What
bounds each on the card: see the notes at the top of the .cu files.

The plain versions share one definition of the pool, the merge
(`aggregate_dmajor_torch`) and the descent (`descend`, `backtrack_top`).

bfloat16 volumes (K3 and K5 each have a bfloat16 instance): every map is
rounded to bfloat16 after each op, the offsets stay int8, scores are
widened to float32, and the exponent is rounded to bfloat16 as the JAX
package's `jnp.asarray(lam, dt)` does (`pool.map_lam`), except in K1's
fast rectification (`pyramid_body(fast=True)`), which JAX runs in
float32.  K3's levels stay floats holding bfloat16 values, so
`route_bytes`, `smem_bytes` and the blocks per SM hold for both dtypes.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..utils.logging import span
from . import _build
from . import pool
from ._dispatch import run_kernel

# Dynamic shared memory one block may take on an H100.
MAX_SMEM = 232448


def level_floats(d0: int, t: int, levels: int) -> int:
    """Floats of pyramid levels 1..levels (csrc/pyramid.cuh)."""
    return sum((d0 >> l) * (t >> l) ** 2 for l in range(1, levels + 1))


def arg_bytes(d0: int, t: int, levels: int) -> int:
    """Bytes of every level's pool offsets as int8 (csrc/pyramid.cuh)."""
    return sum((d0 >> (l + 1)) * (t >> l) ** 2 for l in range(levels))


def scratch_bytes(d0: int, t: int, levels: int) -> int:
    """Levels 1..L and every level's offsets as int8, 16-byte aligned: the
    pyramid scratch of the kernels' earlier layouts."""
    return (4 * level_floats(d0, t, levels)
            + ((arg_bytes(d0, t, levels) + 15) & ~15))


def route_bytes(d0: int, levels: int) -> int:
    """Shared memory of a block of K3's earlier layout: the (D0, T, T)
    level-0 tile and its pyramid.  K3 takes the configurations such a
    block fits, so its routing stays as it was."""
    t = 2 ** levels
    return 4 * d0 * t * t + scratch_bytes(d0, t, levels)


def smem_bytes(d0: int, levels: int) -> int:
    """Shared memory of one K3 block (csrc/pyramid.cu:pyramid_layout):
    levels 1..L, the level-0 offsets at 2 bits and those of levels
    1..L-1 at one byte; no level-0 tile.  A mirror of `dm_pyramid_smem`,
    which chip_smoke.py holds it to."""
    t = 2 ** levels
    kn = d0 // 2
    total = (4 * level_floats(d0, t, levels) + (kn + 3) // 4 * t * t
             + arg_bytes(d0, t, levels) - kn * t * t)
    return (total + 15) & ~15


def supported(d0: int, levels: int) -> bool:
    """True when D0 is aligned to the 2^L tile and `route_bytes` fits a
    block."""
    return d0 % (2 ** levels) == 0 and route_bytes(d0, levels) <= MAX_SMEM


def blocks_per_sm(d0: int, levels: int, bf16: bool = False) -> int:
    """Blocks of K3 (float32, or its bfloat16 instance) that one SM of
    the current card holds (CUDA's occupancy calculator, through
    `dm_pyramid_blocks_per_sm`).  Needs the card."""
    n = _build.library().dm_pyramid_blocks_per_sm(d0, levels, int(bf16))
    if n < 0:
        _build.check(-n, "pyramid kernel occupancy")
    return n


def aggregate_dmajor_torch(cost: torch.Tensor, levels: int, lam: float,
                           fast: bool = False, round_lam: bool = True,
                           pow_first: bool = False
                           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain K5: (..., D0, H0, W0) -> (top, args), in the volume's dtype.

    top is the (..., D0>>L, H0>>L, W0>>L) map; args[l] the int8 pool
    offsets (..., D0>>(l+1), H0>>l, W0>>l).  fast=False rectifies after
    every merge (the exact path); fast=True defers each level's x**lam
    past the next level's pool and skips it at the top (max commutes
    with the monotone power, so the winners are the same).
    round_lam=False keeps lam in float32 on bfloat16 maps (K1's fast
    rectification); K5 rounds it.  pow_first (fast mode) takes the power
    at level 0's pool too: the volume is a level above 0, as in a K5 pass
    that starts above level 0 (`aggregate_dmajor`).
    """
    if round_lam:
        lam = pool.map_lam(lam, cost.dtype)
    args = []
    cur = cost
    for lvl in range(levels):
        pooled, arg = pool.pool3_subsample_dmajor(cur)
        args.append(arg)
        if fast and (lvl > 0 or pow_first):
            pooled = pool.rectify(pooled, lam)
        merged = pool.quad_mean(pooled, -2)
        cur = merged if fast else pool.rectify(merged, lam, exact=True)
    return cur, args


def descend(k: torch.Tensor, args: List[torch.Tensor], dim: int = -3
            ) -> torch.Tensor:
    """Walk the (..., H, W) bins `k` of level len(args) down to level 0.

    Each step doubles the spatial grid and refines the bin by the
    recorded pool offset: k = 2k + arg[k].  `dim` is the disparity axis
    of the args: -3 for D-major (..., D, H, W), -1 for D-minor.
    """
    for arg in reversed(args):
        kr = k.repeat_interleave(2, -2).repeat_interleave(2, -1)
        off = torch.gather(arg, dim, kr.unsqueeze(dim)).squeeze(dim)
        k = 2 * kr + off
    return k


def backtrack_top(cost: torch.Tensor, top: torch.Tensor,
                  args: List[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-max argmax over the top map, the descent, and the level-0
    score gather, widened to float32: -> (disp int32, score f32),
    (..., H0, W0)."""
    k = descend(torch.argmax(top, dim=-3), args)   # first max wins ties
    score = torch.gather(cost, -3, k.unsqueeze(-3)).squeeze(-3)
    return k.to(torch.int32), score.float()


def pyramid_body(cost: torch.Tensor, levels: int, lam: float,
                 fast: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3 (fast=False) and the pyramid of plain K1 (fast=True):
    (..., D0, H0, W0) -> (disp int32, score f32), (..., H0, W0)."""
    return backtrack_top(cost, *aggregate_dmajor_torch(
        cost, levels, lam, fast, round_lam=not fast))


def _check_aligned(d0: int, h0: int, w0: int, levels: int) -> None:
    unit = 2 ** levels
    if h0 % unit or w0 % unit or d0 % unit:
        raise ValueError(f"cost volume (D={d0}, H0={h0}, W0={w0}) not "
                         f"aligned to 2**levels={unit}")


def _check_dtype(cost_dm: torch.Tensor, what: str,
                 dtypes: Tuple[torch.dtype, ...]) -> None:
    if cost_dm.dtype not in dtypes:
        raise NotImplementedError(
            f"the {what} kernel takes {' or '.join(map(str, dtypes))}, not "
            f"{cost_dm.dtype}")


def pyramid_backtrack(cost_dm: torch.Tensor, levels: int, lam: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D0, H0, W0) f32 or bf16 D-major volume -> (disp int32, score
    f32), exact mode (lam rounded to the volume's dtype)."""
    *lead, d0, h0, w0 = cost_dm.shape
    _check_aligned(d0, h0, w0, levels)
    if not run_kernel(cost_dm):
        return pyramid_body(cost_dm, levels, lam, fast=False)
    if not supported(d0, levels):
        raise NotImplementedError(
            f"pyramid kernel: a (D0={d0}, 2^{levels} x 2^{levels}) tile "
            f"routes by {route_bytes(d0, levels)} B of shared memory, more "
            f"than {MAX_SMEM}")
    _check_dtype(cost_dm, "pyramid", (torch.float32, torch.bfloat16))
    bf16 = cost_dm.dtype == torch.bfloat16
    n = math.prod(lead)
    cost = cost_dm.contiguous()
    disp = torch.empty((*lead, h0, w0), dtype=torch.int32, device=cost.device)
    score = torch.empty((*lead, h0, w0), dtype=torch.float32,
                        device=cost.device)
    if n:
        _build.launch("K3 bf16" if bf16 else "K3", "dm_pyramid_backtrack",
                      cost.device, cost.data_ptr(), disp.data_ptr(),
                      score.data_ptr(), n, d0, h0, w0, levels,
                      pool.map_lam(lam, cost.dtype), int(bf16))
    return disp, score


# K5's block (csrc/aggregate.cu): levels per launch, the level-0 tile
# side, the planes of a chunk of its D walk, the plane pairs of its
# cp.async ring.
AGG_MAX_LEVELS, AGG_TILE, AGG_CHUNK, AGG_RING = 5, 32, 32, 4


def aggregate_threads() -> int:
    """Threads of one K5 block: the stream warps, a thread owning 2 rows x
    4 columns (one 16-byte word of float32, 8-byte of bf16) of the 32 x 32
    tile, and the level warp (levels 2..L-1)."""
    return (AGG_TILE // 2) * (AGG_TILE // 4) + 32


def aggregate_layout(levels: int) -> Tuple[List[int], dict, dict, int]:
    """(map2, maps, halos, floats) of one K5 block's level maps in shared
    memory, after its ring (csrc/aggregate.cu:agg_map_off, agg_halo_off),
    as float offsets: the two buffers of the level-2 chunk map, (32 >> 2)
    planes of (32 >> 2)^2 cells each (chunk c in buffer c % 2), the chunk
    map of each level l in 3..L-1, the lo halo plane of each level in
    2..L-1, and the floats in all.  L is capped at AGG_MAX_LEVELS, a
    launch's levels; levels 0 and 1 live in registers, and below L = 3
    there are none of these."""
    lv = min(levels, AGG_MAX_LEVELS)
    if lv <= 2:
        return [], {}, {}, 0

    def floats(lvl, planes=True):
        return ((AGG_CHUNK >> lvl) if planes else 1) * (AGG_TILE >> lvl) ** 2
    map2 = [0, floats(2)]
    maps, halos, o = {}, {}, 2 * floats(2)
    for lvl in range(3, lv):
        maps[lvl] = o
        o += floats(lvl)
    for lvl in range(2, lv):
        halos[lvl] = o
        o += floats(lvl, planes=False)
    return map2, maps, halos, o


def aggregate_ring_bytes(dtype: torch.dtype) -> int:
    """K5's cp.async ring: AGG_RING plane pairs of the stream warps' rows,
    2 planes x 2 rows x 4 columns a stream thread (64 bytes float32, 32
    bf16)."""
    elem = torch.empty((), dtype=dtype).element_size()
    return AGG_RING * 2 * 2 * 4 * elem * (aggregate_threads() - 32)


def aggregate_smem_bytes(levels: int, dtype: torch.dtype) -> int:
    """Shared memory of one K5 block: the ring and the level maps, a
    mirror of `dm_aggregate_smem`, which chip_smoke.py holds it to.  It
    does not grow with D0."""
    return aggregate_ring_bytes(dtype) + 4 * aggregate_layout(levels)[3]


def aggregate_blocks(n: int, h0: int, w0: int) -> int:
    """Blocks of one K5 launch: one per instance and 32 x 32 tile."""
    return n * -(-h0 // AGG_TILE) * -(-w0 // AGG_TILE)


def aggregate_launches(levels: int) -> int:
    """K5 launches of one `aggregate_dmajor` call: one per five levels."""
    return -(-levels // AGG_MAX_LEVELS)


def aggregate_blocks_per_sm(levels: int, bf16: bool = False,
                            fast: bool = True) -> int:
    """Blocks of K5's 16-byte form (float32 or bfloat16; fast or exact)
    one SM of the current card holds at `levels` (CUDA's occupancy
    calculator, through `dm_aggregate_blocks_per_sm`).  Needs the card."""
    n = _build.library().dm_aggregate_blocks_per_sm(
        min(levels, AGG_MAX_LEVELS), int(bf16), int(fast))
    if n < 0:
        _build.check(-n, "aggregation kernel occupancy")
    return n


def aggregate_vec(w0: int, dtype: torch.dtype, ptr: int) -> bool:
    """True where K5 takes its 16-byte form: W0 a multiple of the columns
    one 16-byte load holds (4 float32, 8 bf16) and a 16-byte aligned base
    (csrc/aggregate.cu:vec_form); else the narrow form."""
    return w0 % (16 // torch.empty((), dtype=dtype).element_size()) == 0 \
        and ptr % 16 == 0


def arg_offsets(n: int, d0: int, h0: int, w0: int, levels: int
                ) -> Tuple[List[int], int]:
    """Byte offsets of each level's offsets in K5's one int8 buffer, and
    its size: level l's (n, D0>>(l+1), H0>>l, W0>>l) bytes, rounded up to
    16 (csrc/aggregate.cu:agg_arg_offset)."""
    offs, o = [], 0
    for lvl in range(levels):
        offs.append(o)
        o += (n * (d0 >> (lvl + 1)) * (h0 >> lvl) * (w0 >> lvl) + 15) & ~15
    return offs, o


def aggregate_dmajor(cost_dm: torch.Tensor, levels: int, lam: float,
                     fast: bool = False
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(..., D0, H0, W0) f32 or bf16 D-major volume -> (top, args) as
    `aggregate_dmajor_torch`, through K5: one launch for every level (one
    per five levels above five), only the offsets and the top map in
    device memory, the top map in the volume's dtype.  Any D0 and shape
    aligned to 2**levels; no shared-memory limit on D.  Pass k (a launch,
    or on the CPU the plain version over the same levels) runs in the
    span `pipeline.aggregate_pass<k>`, so that a profile tells the passes
    apart."""
    *lead, d0, h0, w0 = cost_dm.shape
    _check_aligned(d0, h0, w0, levels)
    on_card = run_kernel(cost_dm)
    if on_card:
        _check_dtype(cost_dm, "aggregation", (torch.float32, torch.bfloat16))
        bf16 = cost_dm.dtype == torch.bfloat16
        kernel = "K5 bf16" if bf16 else "K5" if fast else "K5 exact"
        n = math.prod(lead)
        offs, size = arg_offsets(n, d0, h0, w0, levels)
        buf = torch.empty(size, dtype=torch.int8, device=cost_dm.device)
        args = [buf[o:o + n * (d0 >> (lvl + 1)) * (h0 >> lvl) * (w0 >> lvl)]
                .view(*lead, d0 >> (lvl + 1), h0 >> lvl, w0 >> lvl)
                for lvl, o in enumerate(offs)]
    else:
        args = []
    lam = pool.map_lam(lam, cost_dm.dtype)
    cur = cost_dm.contiguous()
    first = 0
    while first < levels:    # one pass for every level up to five
        lv = min(levels - first, AGG_MAX_LEVELS)
        pow_first = fast and first > 0
        with span(f"pipeline.aggregate_pass{first // AGG_MAX_LEVELS}"):
            if on_card:
                d, h, w = d0 >> first, h0 >> first, w0 >> first
                out = torch.empty((*lead, d >> lv, h >> lv, w >> lv),
                                  dtype=cost_dm.dtype, device=cur.device)
                if cur.numel():
                    _build.launch(kernel, "dm_aggregate", cur.device,
                                  cur.data_ptr(), out.data_ptr(),
                                  buf.data_ptr() + offs[first], n, d, h, w,
                                  lv, int(fast), int(pow_first), lam,
                                  int(bf16))
                cur = out
            else:
                cur, part = aggregate_dmajor_torch(cur, lv, lam, fast,
                                                   pow_first=pow_first)
                args += part
        first += lv
    return cur, args
