"""Meshes and sharded pipelines on torch.distributed (NCCL on CUDA, gloo
on the CPU).  The stream runner is not ported yet."""

from .mesh import auto_mesh, make_mesh, make_mesh2d, tiled_geometry
from .sharded import (
    input_spec,
    match_batch_dslab,
    match_batch_sharded,
    match_batch_tiled,
    pad_batch,
)
from .wtiled import match_batch_tiled2d, tiled2d_geometry

__all__ = [
    "auto_mesh",
    "make_mesh",
    "make_mesh2d",
    "tiled_geometry",
    "tiled2d_geometry",
    "input_spec",
    "match_batch_dslab",
    "match_batch_sharded",
    "match_batch_tiled",
    "match_batch_tiled2d",
    "pad_batch",
]
