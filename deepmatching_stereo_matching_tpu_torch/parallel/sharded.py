"""Sharded end-to-end pipeline over a ("data", "model") mesh.

Counterpart of the JAX package's `parallel/sharded.py`, on
torch.distributed: each rank runs the shard body on its own block, with
the collectives written out (parallel/collectives.py) where JAX used
`shard_map`.

  * ``match_batch_tiled`` — pairs over "data", H-tiles over "model";
    each tile runs the whole unsharded pipeline (`match_padded_core`, so
    'fused' runs K1, or K4 -> K5 at large D) with no communication.
  * ``match_batch_dslab`` — disparity slabs over "model": each rank
    builds the bins [k*Dl, (k+1)*Dl) of the full image (K6), ONE
    all_to_all reshards them H-major, and the pyramid (K5) and LR check
    run on the rank's rows.

Every strategy returns the same cropped, post-filtered outputs as the
unsharded `pipeline.match_padded` run at the strategy's padded extents,
bitwise: ties break by index, every reduction keeps its order, padded
rows and bins score 0 and never win, and a K6 slab is bitwise the same
bins of the unsharded cost volume (csrc/costvol.cu).

Config.dtype='bfloat16', as the JAX package runs it: ``tiled`` and
``wtiled`` with merge_level None run the unsharded pipeline's bfloat16
path in each tile (K1/K1b bf16, or the descriptor route K2 bf16 -> K3/K5
bf16), bitwise the unsharded bf16 pipeline.  ``dslab``, ``ringd`` and
``wtiled`` below the top level build their volumes from float32
descriptors and never cast them (the JAX package's `parallel/sharded.py`,
`ringd.py` and `wtiled.py` do the same), so they compute in float32
whatever cfg.dtype says: their outputs are bitwise their float32 run's.
That is the reference's behaviour, kept, not a widening of the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import Config, Geometry
from ..oracle import reference as oracle

from ..models import descriptors, pipeline
from ..ops import costvol as costvol_ops
from ..ops import costvol_cuda, prep_cuda, pyramid_cuda
from ..ops._dispatch import check_route
from . import collectives
from . import mesh as mesh_lib
from .mesh import axis_index, axis_size

Outputs = Dict[str, torch.Tensor]


def finish(out: Outputs, mesh: DeviceMesh, spec: collectives.Spec,
           cfg: Config, height: int, width: int) -> Outputs:
    """Every rank's padded output blocks -> the global cropped,
    post-filtered outputs, on every rank."""
    full = {k: collectives.gather_global(v, mesh, spec)
            for k, v in out.items()}
    return pipeline.apply_postfilter(pipeline.crop(full, height, width), cfg)


# ---------------------------------------------------------------------------
# Strategy 1: DP + spatial H-tiles (zero-communication SP)
# ---------------------------------------------------------------------------


def match_batch_tiled(lefts_p, rights_p, cfg: Config, height: int,
                      width: int, mesh: DeviceMesh, route: str = "fused"
                      ) -> Outputs:
    """Batched pipeline, pairs over "data", H-tiles over "model".

    Args:
      lefts_p/rights_p: (B, Hp, Wp) pairs padded with `pad_batch` (Hp is
        the tiled padded height of `mesh_lib.tiled_geometry`), the full
        batch on every rank.
    Returns the (B, height, width) outputs of `pipeline.match_padded`.
    """
    _, local = mesh_lib.tiled_geometry(cfg, height, width,
                                       axis_size(mesh, "model"))
    spec = input_spec("tiled")
    lp, rp = (collectives.shard(x, mesh, spec) for x in (lefts_p, rights_p))
    out = pipeline.match_padded_core(lp, rp, cfg, local, route)
    return finish(out, mesh, spec, cfg, height, width)


# ---------------------------------------------------------------------------
# Strategy 2: DP + disparity-slab TP with an all_to_all reshard
# ---------------------------------------------------------------------------


def _slab_geometry(cfg: Config, height: int, width: int, n_slab: int
                   ) -> Tuple[Geometry, Geometry]:
    """Geometry with D padded to a multiple of n_slab * 2**L and H
    tile-aligned: bins at or above max_disparity score 0 and never win,
    and the pyramid runs H-sharded after the reshard."""
    glob, local = mesh_lib.tiled_geometry(cfg, height, width, n_slab)
    unit = n_slab * (cfg.subsample ** glob.levels)
    d0 = ((glob.disparities + unit - 1) // unit) * unit
    return (dataclasses.replace(glob, disparities=d0),
            dataclasses.replace(local, disparities=d0))


def slab_cost_volume(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                     cfg: Config, d_local: int, d_offset: int, reverse: bool,
                     route: str) -> torch.Tensor:
    """One rank's disparity slab [d_offset, d_offset + d_local) in the row
    layout (..., H0, Dl, W0): K6 on the kernel routes, stock torch on
    'torch'; float32 in either Config.dtype, as in the JAX package."""
    volume = (costvol_ops.cost_volume_rows_torch
              if check_route(route) == "torch"
              else costvol_cuda.cost_volume_rows)
    return volume(desc_src, desc_tgt, d_local, cfg.patch_size,
                  cfg.max_disparity, reverse=reverse, d_offset=d_offset)


def _dslab_direction(srcs: torch.Tensor, tgts: torch.Tensor, cfg: Config,
                     geom: Geometry, mesh: DeviceMesh, reverse: bool,
                     route: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction with the cost volume disparity-sharded.

    srcs/tgts: (..., Hp, Wp) full padded images (replicated over
    "model").  Returns (disp_patch, score), each (..., H0 / n, W0): this
    rank's rows after the reshard.
    """
    n = axis_size(mesh, "model")
    d_local = geom.disparities // n
    cost = slab_cost_volume(
        descriptors.left_descriptors(srcs, cfg),
        descriptors.right_sliding_descriptors(tgts, cfg), cfg, d_local,
        axis_index(mesh, "model") * d_local, reverse, route)
    *lead, h0, _, w0 = cost.shape
    hl = h0 // n
    # Reshard: H-chunk i of every instance goes to rank i, which receives
    # slab k's bins of its rows from rank k — global bins k*Dl + d.
    send = cost.reshape(-1, n, hl, d_local, w0).transpose(0, 1)
    recv = collectives.all_to_all(send, mesh, "model")
    cost_dm = recv.permute(1, 0, 3, 2, 4).reshape(*lead, n * d_local, hl, w0)
    if route == "torch":
        return pyramid_cuda.pyramid_body(cost_dm, geom.levels, cfg.lam)
    return pipeline.match_dmajor(cost_dm, geom.levels, cfg.lam)


def match_batch_dslab(lefts_p, rights_p, cfg: Config, height: int,
                      width: int, mesh: DeviceMesh, route: str = "fused"
                      ) -> Outputs:
    """Batched pipeline with disparity-slab-parallel correlation.

    Args:
      lefts_p/rights_p: (B, Hp, Wp) padded pairs (`pad_batch(...,
        strategy="dslab")`), the full batch on every rank.
    Returns the (B, height, width) outputs.
    """
    _, local = _slab_geometry(cfg, height, width, axis_size(mesh, "model"))
    lp, rp = (collectives.shard(x, mesh, input_spec("dslab"))
              for x in (lefts_p, rights_p))

    def match(srcs, tgts, reverse):
        return _dslab_direction(srcs, tgts, cfg, local, mesh, reverse, route)

    disp_fwd, score, disp_r = pipeline.lr_directions(lp, rp, cfg, match)
    out = pipeline.lr_outputs(disp_fwd, score, disp_r, cfg,
                              local.disparities)
    return finish(out, mesh, ("data", "model", None), cfg, height, width)


# ---------------------------------------------------------------------------
# Host-side batch prep and the entry point
# ---------------------------------------------------------------------------


def strategy_geometry(cfg: Config, height: int, width: int,
                      mesh: DeviceMesh, strategy: str = "tiled",
                      merge_level: Optional[int] = None) -> Geometry:
    """GLOBAL padded geometry of the given sharded strategy
    (`merge_level` must be the one later passed to "wtiled": it changes
    the W padding)."""
    if strategy == "wtiled":
        from . import wtiled
        glob, _, _ = wtiled.tiled2d_geometry(
            cfg, height, width, axis_size(mesh, "th"),
            axis_size(mesh, "tw"), merge_level)
    elif strategy == "tiled":
        glob, _ = mesh_lib.tiled_geometry(cfg, height, width,
                                          axis_size(mesh, "model"))
    elif strategy in ("dslab", "ringd"):
        glob, _ = _slab_geometry(cfg, height, width,
                                 axis_size(mesh, "model"))
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return glob


class PaddedPlane(np.ndarray):
    """Marker view: a float32 (Hp, Wp) plane ALREADY grayscale-normalised
    and padded to a strategy geometry.  `pad_batch` copies marked planes
    through untouched; plain arrays always go through grayscale
    normalisation (an aligned-size float image in 8-bit range must not
    skip the /255)."""


def as_padded(plane) -> PaddedPlane:
    """Tag a pre-padded float32 plane for `pad_batch` pass-through."""
    a = np.ascontiguousarray(plane, dtype=np.float32)
    if a.ndim != 2:
        raise ValueError(f"pre-padded plane must be 2-D, got {a.shape}")
    return a.view(PaddedPlane)


def raw_batch(images, height: int, width: int) -> bool:
    """True where `pad_batch` pads the batch on its device: every image a
    uint8 array of exactly (height, width), or every one (height, width,
    3 or 4), all of one shape."""
    shapes = {np.shape(img) if isinstance(img, np.ndarray)
              and img.dtype == np.uint8 else None for img in images}
    return len(shapes) == 1 and shapes.pop() in (
        (height, width), *((height, width, c) for c in prep_cuda.CHANNELS))


def pad_batch(images, cfg: Config, height: int, width: int,
              mesh: DeviceMesh, strategy: str = "tiled",
              merge_level: Optional[int] = None,
              device: Optional[torch.device] = None):
    """Grayscale-normalise and zero-pad a batch for the given strategy:
    a (B, Hp, Wp) float32 array whose extents satisfy the tile and slab
    alignment for `mesh`.  `as_padded` planes are copied through.

    With `device`, the (B, Hp, Wp) float32 tensor on it: a `raw_batch` is
    packed image by image into one host buffer of its uint8 bytes, copied
    in as one copy and padded there (`prep_cuda.gray_pad`, bitwise the
    host path); any other batch is padded on the host, then copied in.
    For a CUDA device the buffer is page-locked, from PyTorch's caching
    host allocator, so the copy does not block the host; the allocator
    hands the buffer out again only once the copy has read it."""
    glob = strategy_geometry(cfg, height, width, mesh, strategy,
                             merge_level)
    if device is not None and raw_batch(images, height, width):
        raw = torch.empty((len(images), *images[0].shape), dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        np.stack(images, out=raw.numpy())
        return prep_cuda.gray_pad(raw.to(device, non_blocking=True),
                                  glob.padded_height, glob.padded_width)
    out = np.zeros((len(images), glob.padded_height, glob.padded_width),
                   dtype=np.float32)
    for i, img in enumerate(images):
        if isinstance(img, PaddedPlane):
            if img.shape != out.shape[1:]:
                raise ValueError(
                    f"pre-padded plane {img.shape} does not match the "
                    f"{strategy!r} padded geometry {out.shape[1:]}")
            out[i] = img
            continue
        g = oracle.to_grayscale_f32(img)
        out[i, : g.shape[0], : g.shape[1]] = g
    return out if device is None else torch.from_numpy(out).to(device)


def input_spec(strategy: str = "tiled") -> Tuple[Optional[str], ...]:
    """How a strategy splits its (B, Hp, Wp) inputs over the mesh (JAX's
    `input_sharding` PartitionSpec); every rank cuts its own block."""
    if strategy == "wtiled":
        return ("data", "th", "tw")
    if strategy == "tiled":
        return ("data", "model", None)
    return ("data", None, None)


def match_batch_sharded(lefts_p, rights_p, cfg: Config, height: int,
                        width: int, mesh: DeviceMesh,
                        strategy: str = "tiled", route: str = "fused",
                        merge_level: Optional[int] = None,
                        debug_checks: bool = False) -> Outputs:
    """Entry point: one sharded strategy on every rank of `mesh`.

    `lefts_p`/`rights_p` are the full (B, Hp, Wp) batch from `pad_batch`
    on every rank; every rank returns the full (B, height, width)
    outputs.  `debug_checks` (ringd only) asserts that the winner maps
    are replicated over the model axis.  In bfloat16, dslab, ringd and
    wtiled below the top level compute in float32, as in the JAX package
    (module docstring)."""
    pipeline.check_supported(cfg, route)
    if strategy == "tiled":
        return match_batch_tiled(lefts_p, rights_p, cfg, height, width,
                                 mesh, route)
    if strategy == "dslab":
        return match_batch_dslab(lefts_p, rights_p, cfg, height, width,
                                 mesh, route)
    if strategy == "ringd":
        from . import ringd
        return ringd.match_batch_ringd(lefts_p, rights_p, cfg, height,
                                       width, mesh, route, debug_checks)
    if strategy == "wtiled":
        from . import wtiled
        return wtiled.match_batch_tiled2d(lefts_p, rights_p, cfg, height,
                                          width, mesh, route, merge_level)
    raise ValueError(f"unknown strategy {strategy!r}")
