"""Pyramid level ops (C5-C7) in stock torch ops.

Counterpart of the JAX package's `ops/pool.py`: 3-wide disparity
max-pool + x2 subsample with recorded argmax offsets, and the quadtree
4-child merge + power rectification, in the D-minor (..., H, W, D) and
D-major (..., D, H, W) layouts.  Same -1.0 pool pad, same lo/even/odd tie
order and same ((q00 + q01) + (q10 + q11)) * 0.25 summation order, so the
pools are bitwise equal to the oracle's.  x**lam after a merge (the exact
mode) is correctly rounded: the power in float64, rounded once, as K3 and
K5 compute it (`pow_rn`, csrc/pyramid.cuh); float32 `torch.pow` (powf
on the card, up to 2 ULP off) flipped a pool near-tie off the oracle's
decisions where the correctly rounded power keeps them.  The fast mode's
deferred power stays float32 `torch.pow`, as K1 and K5's fast mode use
powf.

On bfloat16 maps every op rounds its result to bfloat16 (torch eager, as
XLA does on the JAX side), and the power follows `rectify` with the
exponent of `map_lam`.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional, Tuple

import torch


@functools.lru_cache(maxsize=None)
def map_lam(lam: float, dtype: torch.dtype) -> float:
    """`lam` as the JAX package holds it for maps of `dtype`
    (`jnp.asarray(lam, dt)`): rounded to bfloat16 on bfloat16 maps (1.4
    becomes 1.3984375), unchanged on float32 maps.  Cached: a kernel
    wrapper asks for it on every call, and a tensor costs host time."""
    if dtype == torch.float32:
        return lam
    return float(torch.tensor(lam, dtype=dtype))


def rectify(x: torch.Tensor, lam: float, exact: bool = False
            ) -> torch.Tensor:
    """x**lam with the exponent exactly as given.  On bfloat16 maps, the
    power of the exact float32 widening rounded once to bfloat16:
    `torch.pow` on a bfloat16 tensor would round a scalar exponent to
    bfloat16 by itself, which K1's fast rectification must not.  `exact`
    (the power after a merge) on float32 maps: x**float32(lam) in
    float64, rounded once to float32."""
    if x.dtype == torch.float32:
        if exact:   # lam as the kernels' float parameter holds it
            lam32 = struct.unpack("f", struct.pack("f", lam))[0]
            return torch.pow(x.double(), lam32).float()
        return torch.pow(x, lam)
    return torch.pow(x.float(), lam).to(x.dtype)


def _pool(lo_first: torch.Tensor, even: torch.Tensor, odd: torch.Tensor,
          dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.cat([lo_first, odd.narrow(dim, 0, odd.shape[dim] - 1)], dim)
    pooled = torch.maximum(torch.maximum(lo, even), odd)
    # masked_fill_, not boolean-mask assignment: the latter waits for the
    # device to count the mask.
    arg = torch.ones(pooled.shape, dtype=torch.int8, device=pooled.device)
    arg.masked_fill_(pooled == even, 0)
    arg.masked_fill_(pooled == lo, -1)  # lo wins ties, then even, then odd
    return pooled, arg


def pool3_subsample(maps: torch.Tensor,
                    lo_pad: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W, D) -> (pooled, arg), both (..., H, W, D//2).

    arg[..., k] in {-1, 0, +1} is the offset of the pool winner around
    d = 2k; the -1.0 pad below bin 0 never wins against a correlation.
    `lo_pad` (..., H, W) replaces that pad: a disparity slab of a sharded
    volume passes the previous slab's last odd plane, so that its pool
    equals the unsharded one (parallel/ringd.py).
    """
    even, odd = maps[..., 0::2], maps[..., 1::2]
    lo = (torch.full_like(odd[..., :1], -1.0) if lo_pad is None
          else lo_pad.to(maps.dtype)[..., None])
    return _pool(lo, even, odd, -1)


def pool3_subsample_dmajor(maps: torch.Tensor,
                           lo_pad: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`pool3_subsample` on the D-major (..., D, H, W) layout."""
    even, odd = maps[..., 0::2, :, :], maps[..., 1::2, :, :]
    lo = (torch.full_like(odd[..., :1, :, :], -1.0) if lo_pad is None
          else lo_pad.to(maps.dtype)[..., None, :, :])
    return _pool(lo, even, odd, -3)


def quad_mean(sub: torch.Tensor, h_dim: int) -> torch.Tensor:
    """Quadtree 4-child mean over spatial dims (h_dim, h_dim + 1), both
    negative, in ((q00 + q01) + (q10 + q11)) * 0.25 order: w pairs
    first, then h."""
    def q(u, v):
        idx = [slice(None)] * sub.dim()
        idx[h_dim] = slice(u, None, 2)
        idx[h_dim + 1] = slice(v, None, 2)
        return sub[tuple(idx)]
    return ((q(0, 0) + q(0, 1)) + (q(1, 0) + q(1, 1))) * 0.25


def aggregate_children(sub: torch.Tensor, lam: float) -> torch.Tensor:
    """(..., H, W, K) -> (..., H/2, W/2, K): 4-child mean, then x**lam
    (lam rounded to the maps' dtype, as in JAX)."""
    return rectify(quad_mean(sub, -3), map_lam(lam, sub.dtype), exact=True)


def aggregate_children_dmajor(sub: torch.Tensor, lam: float) -> torch.Tensor:
    """`aggregate_children` on the D-major (..., K, H, W) layout."""
    return rectify(quad_mean(sub, -2), map_lam(lam, sub.dtype), exact=True)
