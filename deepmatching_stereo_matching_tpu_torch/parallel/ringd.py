"""Ring pass over disparity slabs: the cost volume stays D-sharded through
the whole pyramid.

Counterpart of the JAX package's `parallel/ringd.py` (why: its
docstring).  Only (H, W) planes cross ranks:

  * level-0 correlation builds the rank's slab [k*Dl, (k+1)*Dl) (K6);
  * each level's 3-wide disparity pool needs one halo plane, the ring
    predecessor's last odd plane, moved by `ppermute`; with it
    `pool3_subsample_dmajor(lo_pad=...)` equals the unsharded pool;
  * the top-level argmax is a ring reduce of (value, global bin) pairs,
    value first, then the smallest bin: the unsharded first-max rule;
  * backtracking resolves each level's pool offset with a `psum`: the one
    slab that owns a cell's bin contributes its offset, the others 0.

The per-level pools are torch ops, as they are XLA in JAX.  Every rank
ends with the same winner maps, bitwise equal to the unsharded ones.
The slab volume is built from float32 descriptors in either Config.dtype,
as in the JAX package, so a bfloat16 config runs bitwise its float32 run.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import Config, Geometry

from ..models import descriptors, pipeline
from ..ops import pool as pool_ops
from . import collectives
from .mesh import axis_index, axis_size
from .sharded import (Outputs, _slab_geometry, finish, input_spec,
                      slab_cost_volume)


def _from_prev(x: torch.Tensor, mesh: DeviceMesh, n: int, fill: float
               ) -> torch.Tensor:
    """Slab k receives slab k-1's x; slab 0 receives `fill`."""
    out = collectives.ppermute(x, mesh, "model",
                               [(i, i + 1) for i in range(n - 1)])
    if axis_index(mesh, "model") == 0:
        out.fill_(fill)
    return out


def _ring_argmax(val: torch.Tensor, k: torch.Tensor, mesh: DeviceMesh,
                 n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring all-reduce of (max value, smallest bin on ties) pairs: n-1
    steps, each passing the accumulated pair to the ring successor.  The
    merge is associative, commutative and idempotent, so every rank ends
    with the reduction over all slabs; slabs are ordered by disparity, so
    it is the unsharded first-max argmax."""
    perm = [(i, (i + 1) % n) for i in range(n)]
    for _ in range(n - 1):
        v_in = collectives.ppermute(val, mesh, "model", perm)
        k_in = collectives.ppermute(k, mesh, "model", perm)
        better = (v_in > val) | ((v_in == val) & (k_in < k))
        val = torch.where(better, v_in, val)
        k = torch.where(better, k_in, k)
    return val, k


def _ringd_direction(srcs: torch.Tensor, tgts: torch.Tensor, cfg: Config,
                     geom: Geometry, mesh: DeviceMesh, reverse: bool,
                     route: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction with a D-sharded pyramid.

    srcs/tgts: (..., Hp, Wp) full padded images.  Returns (disp_patch,
    score), each (..., H0, W0), the same on every rank of "model".
    """
    n = axis_size(mesh, "model")
    ax = axis_index(mesh, "model")
    d_local = geom.disparities // n
    cost = slab_cost_volume(
        descriptors.left_descriptors(srcs, cfg),
        descriptors.right_sliding_descriptors(tgts, cfg), cfg, d_local,
        ax * d_local, reverse, route)
    cost0 = cost.movedim(-2, -3)                # (..., Dl, H0, W0) view
    args = []
    cur = cost0
    for _ in range(geom.levels):
        halo = _from_prev(cur[..., -1, :, :], mesh, n, -1.0)
        sub, arg = pool_ops.pool3_subsample_dmajor(cur, lo_pad=halo)
        cur = pool_ops.aggregate_children_dmajor(sub, cfg.lam)
        args.append(arg)

    n_top = cur.shape[-3]
    k_loc = torch.argmax(cur, dim=-3) + ax * n_top    # first max wins ties
    _, k = _ring_argmax(cur.amax(dim=-3), k_loc, mesh, n)

    def owned(planes, k):
        """planes[k] where this slab owns global bin k, else 0, summed
        over the slabs: exactly one owns it, and x + 0 == x."""
        n_loc = planes.shape[-3]
        k_rel = k - ax * n_loc
        mine = (k_rel >= 0) & (k_rel < n_loc)
        v = torch.gather(planes, -3, k_rel.clamp(0, n_loc - 1)
                         .unsqueeze(-3)).squeeze(-3)
        return collectives.psum(torch.where(mine, v, torch.zeros_like(v)),
                                mesh, "model")

    for arg in reversed(args):
        kr = k.repeat_interleave(2, -2).repeat_interleave(2, -1)
        k = 2 * kr + owned(arg.to(torch.int32), kr)
    return k.to(torch.int32), owned(cost0, k)


def _check_replicated(x: torch.Tensor, mesh: DeviceMesh, n: int,
                      name: str) -> None:
    """Raise unless x is the same on every rank of "model": the sum over
    the ranks of |x - x of the ring successor| is 0 exactly then."""
    nb = collectives.ppermute(x, mesh, "model",
                              [(i, (i + 1) % n) for i in range(n)])
    resid = collectives.psum((x - nb).abs().to(torch.float32).sum(), mesh,
                             "model")
    if resid.item() != 0.0:
        raise RuntimeError(f"ringd {name} not replicated over the model "
                           f"axis (residual {resid.item()})")


def match_batch_ringd(lefts_p, rights_p, cfg: Config, height: int,
                      width: int, mesh: DeviceMesh, route: str = "fused",
                      debug_checks: bool = False) -> Outputs:
    """Batched pipeline; cost volume D-sharded through the whole pyramid.

    Args:
      lefts_p/rights_p: (B, Hp, Wp) padded pairs (`pad_batch(...,
        strategy="ringd")`, the dslab geometry), the full batch on every
        rank.
      debug_checks: raise unless the winner maps are the same on every
        rank of "model" after the ring merges.
    Returns the (B, height, width) outputs.
    """
    n = axis_size(mesh, "model")
    _, local = _slab_geometry(cfg, height, width, n)
    spec = input_spec("ringd")
    lp, rp = (collectives.shard(x, mesh, spec) for x in (lefts_p, rights_p))

    def match(srcs, tgts, reverse):
        return _ringd_direction(srcs, tgts, cfg, local, mesh, reverse, route)

    disp_fwd, score, disp_r = pipeline.lr_directions(lp, rp, cfg, match)
    out = pipeline.lr_outputs(disp_fwd, score, disp_r, cfg,
                              local.disparities)
    if debug_checks and n > 1:
        _check_replicated(out["disparity_raw"], mesh, n, "disparity")
        _check_replicated(out["score"], mesh, n, "score")
    return finish(out, mesh, spec, cfg, height, width)
