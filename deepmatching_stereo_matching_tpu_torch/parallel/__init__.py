"""Meshes, sharded pipelines and the batched stream on torch.distributed
(NCCL on CUDA, gloo on the CPU)."""

from .mesh import auto_mesh, make_mesh, make_mesh2d, tiled_geometry
from .runner import (
    StreamReport,
    init_distributed,
    pairs_from_paths,
    run_stream,
    scaling_sweep,
)
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
    "StreamReport",
    "init_distributed",
    "pairs_from_paths",
    "run_stream",
    "scaling_sweep",
    "input_spec",
    "match_batch_dslab",
    "match_batch_sharded",
    "match_batch_tiled",
    "match_batch_tiled2d",
    "pad_batch",
]
