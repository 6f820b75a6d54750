"""Device meshes over a torch.distributed world, and tile-aligned geometry.

Counterpart of the JAX package's `parallel/mesh.py`.  Each process is one
rank; a mesh is a `torch.distributed.device_mesh.DeviceMesh` over all of
them, with the JAX axis names: ("data", "model"), and ("data", "th",
"tw") for the 2-D tile strategy; the stream's scaling sweep also builds
meshes over the leading ranks of a larger world.  A rank's mesh coordinate along an axis
(`axis_index`, JAX's `lax.axis_index`) is a host int, so slab and tile
offsets are plain ints here.  The device follows the process group's
backend: NCCL ranks run on their CUDA device, gloo ranks on the CPU;
nothing falls back from one to the other.

Why aligned row tiles need no halo: see the JAX module's docstring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import Config, Geometry


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          part_of_world: bool) -> DeviceMesh:
    need = math.prod(shape)
    world = dist.get_world_size()
    if need > world or (need != world and not part_of_world):
        raise ValueError(f"a {shape} mesh needs {need} ranks; the world "
                         f"has {world}")
    if need == world:
        return init_device_mesh(_device_type(), shape, mesh_dim_names=names)
    return DeviceMesh(_device_type(), torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_data: int, n_model: int, part_of_world: bool = False
              ) -> DeviceMesh:
    """("data", "model") mesh over the whole world (n_data * n_model
    ranks), or with `part_of_world` over ranks 0 .. n_data * n_model - 1
    of a larger one: every rank of the world constructs it, and the ranks
    outside it (`in_mesh` False) take part in none of its collectives."""
    return _mesh((n_data, n_model), ("data", "model"), part_of_world)


def make_mesh2d(n_data: int, n_th: int, n_tw: int,
                part_of_world: bool = False) -> DeviceMesh:
    """("data", "th", "tw") mesh for the 2-D tile strategy; ``tw``, the
    halo-exchange axis, is minor, so W-neighbours are adjacent ranks.
    `part_of_world` as for `make_mesh`."""
    return _mesh((n_data, n_th, n_tw), ("data", "th", "tw"), part_of_world)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return dist.get_rank() in mesh.mesh.flatten().tolist()


def auto_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """Default mesh over n ranks (the world): data axis 2 if possible,
    the rest model."""
    n = n_devices if n_devices is not None else dist.get_world_size()
    n_data = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh(n_data, n // n_data)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along mesh axis `name`."""
    return mesh.get_local_rank(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tiled_geometry(cfg: Config, height: int, width: int,
                   n_tiles: int) -> Tuple[Geometry, Geometry]:
    """(global, per-tile) geometry with H padded so tiles stay aligned.

    The global padded height is rounded up to a multiple of
    ``n_tiles * patch_size * 2**levels`` so each tile owns whole quadtree
    row-blocks; the extra all-zero rows produce zero descriptors and
    never change the cropped result.
    """
    g = cfg.geometry(height, width)
    block = cfg.patch_size * (cfg.subsample ** g.levels)
    unit = block * n_tiles
    hp = ((g.padded_height + unit - 1) // unit) * unit
    glob = dataclasses.replace(
        g, padded_height=hp, grid_h=hp // cfg.patch_size)
    local = dataclasses.replace(
        glob,
        padded_height=hp // n_tiles,
        grid_h=hp // n_tiles // cfg.patch_size,
        height=hp // n_tiles,
    )
    return glob, local
