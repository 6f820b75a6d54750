"""The JAX collectives the sharded strategies use, on a mesh axis's group.

  ppermute(x, perm)        -> batch_isend_irecv to and from the neighbours
  all_to_all(tiled=True)   -> all_to_all_single (split axis first)
  all_gather(tiled=True)   -> all_gather, concatenated along a dim
  psum                     -> all_reduce(SUM)

plus the two ends of JAX's `shard_map` specs: `shard` cuts this rank's
block out of a full array, `gather_global` assembles every rank's block
into the full array on every rank of the mesh.  A spec is a tuple naming, for each
dim, the mesh axis it is split over (None: not split); mesh axes a spec
does not name are replicated.  Every op runs on the tensors' own device
through the world's backend (NCCL on CUDA, gloo on the CPU).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_index, axis_size, mesh_device

Spec = Sequence[Optional[str]]


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """For each (src, dst) of `perm` (indices along `axis`), dst receives
    src's x.  A rank that no pair sends to receives zeros, as in JAX; a
    rank with no pair sends and receives nothing (so at axis size 1 no op
    is issued)."""
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str
               ) -> torch.Tensor:
    """x (n, ...): chunk i goes to index i along `axis`; returns (n, ...)
    whose chunk k came from index k."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.get_group(axis))
    return out


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int
               ) -> torch.Tensor:
    """Every index's x along `axis`, concatenated along `dim` in index
    order (JAX's tiled all_gather)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out


def shard(x, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """This rank's block of the full array `x` (numpy or torch), on its
    device."""
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    for dim, name in enumerate(spec):
        if name is not None:
            n = axis_size(mesh, name)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split over {n} '{name}' shards")
            size = t.shape[dim] // n
            t = t.narrow(dim, axis_index(mesh, name) * size, size)
    return t.to(mesh_device(mesh))


def gather_global(x: torch.Tensor, mesh: DeviceMesh, spec: Spec
                  ) -> torch.Tensor:
    """Every rank's block -> the full array, on every rank of the mesh:
    one all_gather along each mesh axis (none at axis size 1)."""
    if x.dtype == torch.bool:       # gloo does not move bool tensors
        return gather_global(x.to(torch.uint8), mesh, spec).bool()
    names = list(mesh.mesh_dim_names)
    g = x.contiguous()
    for name in reversed(names):    # the outermost mesh axis ends first
        g = g.unsqueeze(0)
        if axis_size(mesh, name) > 1:
            g = all_gather(g, mesh, name, 0)
    for i in reversed(range(len(names))):       # replicated: take index 0
        if names[i] not in spec:
            g = g.select(i, 0)
            del names[i]
    perm, shape = [], []
    for dim, name in enumerate(spec):
        if name is not None:
            perm.append(names.index(name))
        perm.append(len(names) + dim)
        shape.append(x.shape[dim] * (axis_size(mesh, name) if name else 1))
    return g.permute(perm).reshape(shape)
