"""2-D spatial tiles with `ppermute` halo exchange.

Counterpart of the JAX package's `parallel/wtiled.py` (the design: its
docstring), on a ("data", "th", "tw") mesh:

  * W-tiles over ``tw``: each tile receives ceil(D/p) patch columns of
    pixels from each W-neighbour (zeros past the image) and builds its
    sliding descriptors with the global-window mask;
  * H-tiles over ``th``: 'grad_hist' rows couple through the gradient, so
    they exchange a 1-row halo;
  * coarse pyramid merges: tiles are aligned to p * 2**l0 pixels; levels
    up to l0 run tile-local (K6's volume, the D-minor torch pyramid), ONE
    all_gather over ``tw`` merges the level-l0 maps full-width, the coarse
    levels run replicated, and backtracking re-enters the tile at l0.
    With l0 == levels the tile runs `match_from_descriptors` (K2 -> K3 or
    K5) and the pyramid needs no communication;
  * the LR check's dR[x - dL] gather reaches into the left neighbour's
    trailing patch columns; 'flip' mode's global flip is a local flip
    plus the tile permutation i -> n-1-i.  So the tile keeps the torch
    chain (`pipeline.lr_consistency_patch_padded` on the halo-padded
    right map at the tile's global column offset, then
    `pipeline.pixel_outputs`) where the other strategies launch EPI
    (`pipeline.lr_outputs`), whose right map has neither; no benchmark
    cell runs wtiled.

Every output is bitwise equal to the unsharded pipeline's at the same
padded extents, for both LR modes.

Config.dtype='bfloat16', as the JAX package runs it: with l0 == levels the
tile runs `match_from_descriptors`, which rounds the descriptors to
bfloat16 (K2 bf16 -> K3/K5 bf16); with l0 < levels the tile's volume (K6)
and its pyramid are built from float32 descriptors, as in the JAX
package's `_match_tile`, so that run is bitwise its float32 run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import Config, Geometry

from ..models import descriptors, pipeline
from ..ops import costvol as costvol_ops
from ..ops import costvol_cuda
from . import collectives
from .mesh import axis_index, axis_size
from .sharded import Outputs, finish, input_spec

_SENTINEL = torch.iinfo(torch.int32).min // 2


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def tiled2d_geometry(cfg: Config, height: int, width: int, n_th: int,
                     n_tw: int, merge_level: Optional[int] = None
                     ) -> Tuple[Geometry, Geometry, int]:
    """(global, per-tile, l0) geometry for an (n_th, n_tw) tile grid.

    Heights are padded to a multiple of ``n_th * p * 2**L``, widths to
    ``lcm(p * 2**L, n_tw * p * 2**l0)``, so the global pyramid is
    well-formed and each W-tile owns whole level-l0 blocks.  ``l0`` is
    the deepest tile-local level: ``levels`` when merge_level is None,
    else ``min(merge_level, levels)``.
    """
    g = cfg.geometry(height, width)
    lvl = g.levels
    l0 = lvl if merge_level is None else max(0, min(merge_level, lvl))
    p = cfg.patch_size
    s = cfg.subsample
    unit_h = n_th * p * (s ** lvl)
    hp = -(-g.padded_height // unit_h) * unit_h
    unit_w = math.lcm(p * (s ** lvl), n_tw * p * (s ** l0))
    wp = -(-g.padded_width // unit_w) * unit_w
    glob = dataclasses.replace(g, padded_height=hp, padded_width=wp,
                               grid_h=hp // p, grid_w=wp // p)
    local = dataclasses.replace(
        glob,
        padded_height=hp // n_th, grid_h=hp // n_th // p,
        height=hp // n_th,
        padded_width=wp // n_tw, grid_w=wp // n_tw // p,
        width=wp // n_tw)
    return glob, local, l0


def halo_patches(cfg: Config) -> int:
    """Target-descriptor halo width in patch columns: ceil(D / p)."""
    return -(-cfg.max_disparity // cfg.patch_size)


# ---------------------------------------------------------------------------
# Neighbour exchange (zeros past the grid boundary)
# ---------------------------------------------------------------------------


def _from_prev(x: torch.Tensor, mesh: DeviceMesh, axis: str, width: int,
               dim: int) -> torch.Tensor:
    """Each shard receives the previous shard's trailing `width` slice;
    the first receives zeros."""
    n = axis_size(mesh, axis)
    sl = x.narrow(dim, x.shape[dim] - width, width)
    return collectives.ppermute(sl, mesh, axis,
                                [(i, i + 1) for i in range(n - 1)])


def _from_next(x: torch.Tensor, mesh: DeviceMesh, axis: str, width: int,
               dim: int) -> torch.Tensor:
    """Each shard receives the next shard's leading `width` slice."""
    n = axis_size(mesh, axis)
    return collectives.ppermute(x.narrow(dim, 0, width), mesh, axis,
                                [(i + 1, i) for i in range(n - 1)])


def _extend(x: torch.Tensor, mesh: DeviceMesh, axis: str, width: int,
            dim: int) -> torch.Tensor:
    """[prev halo, x, next halo] along `dim`."""
    if width == 0:
        return x
    return torch.cat([_from_prev(x, mesh, axis, width, dim), x,
                      _from_next(x, mesh, axis, width, dim)], dim)


def _mirror(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int
            ) -> torch.Tensor:
    """Global reverse of a sharded dim: local flip + tile i -> n-1-i."""
    n = axis_size(mesh, axis)
    rev = x.flip(dim)
    if n == 1:
        return rev
    return collectives.ppermute(rev, mesh, axis,
                                [(i, n - 1 - i) for i in range(n)])


# ---------------------------------------------------------------------------
# Halo-exact pixel features
# ---------------------------------------------------------------------------


def _features_slab(slab: torch.Tensor, cfg: Config, row0: int, col0: int,
                   hg: int, wg: int, mr: int) -> torch.Tensor:
    """Pixel features of a halo-extended slab, bitwise equal to global.

    Args:
      slab: (..., Hl + 2*mr, Wl + 2*(halo_px + mc)) pixels, mc = 1 for
        'grad_hist' (one gradient-margin pixel per side), 0 for 'patch'.
      row0/col0: GLOBAL coordinates of the returned block's [0, 0] pixel
        (col0 = tile start - halo_px).
      hg/wg: global padded image extents.
      mr: row margin (1 when 'grad_hist' rows are sharded over th).

    Returns (..., Hl, Wl + 2*halo_px, F).  Entries whose global column
    lies outside the image are garbage and are masked by
    `sliding_descriptors`' global-window mask; in-image entries are the
    unsharded `pixel_features`' bits: interior pixels take the same
    central differences, pixels on the global border the same one-sided
    ones (the xg/rg overrides).
    """
    if cfg.descriptor == "patch":
        return slab[..., None]      # mc = mr = 0: already the output extent
    hs, ws = slab.shape[-2:]
    core = slab[..., mr: hs - mr, :]
    left, mid, right = core[..., :-2], core[..., 1:-1], core[..., 2:]
    gx = (right - left) * 0.5
    xg = col0 + torch.arange(ws - 2, device=slab.device)
    gx = torch.where(xg == 0, right - mid, gx)
    gx = torch.where(xg == wg - 1, mid - left, gx)
    if mr:
        up, vmid, down = (slab[..., :-2, :], slab[..., 1:-1, :],
                          slab[..., 2:, :])
        gy = (down - up) * 0.5
        rg = (row0 + torch.arange(hs - 2, device=slab.device))[:, None]
        gy = torch.where(rg == 0, down - vmid, gy)
        gy = torch.where(rg == hg - 1, vmid - up, gy)
        gy = gy[..., 1:-1]
    else:
        # The tile spans the full image height: np.gradient's edge
        # semantics are already the global ones.
        gy = descriptors._gradient_1d(slab, -2)[..., 1:-1]
    return descriptors.hist_from_gradients(gx, gy)


# ---------------------------------------------------------------------------
# Per-tile matching (cost volume -> pyramid -> backtracking)
# ---------------------------------------------------------------------------


def _match_tile(desc_src: torch.Tensor, desc_tgt: torch.Tensor, cfg: Config,
                local: Geometry, l0: int, halo_q: int, route: str,
                reverse: bool, mesh: DeviceMesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction on a tile with halo-extended targets.

    With l0 == levels the whole pyramid is tile-local:
    `match_from_descriptors`.  Otherwise K6 builds the tile's volume,
    levels up to l0 run tile-local, ONE all_gather over ``tw`` merges
    the level-l0 maps full-width, the coarse levels and the top argmax
    run on every tile alike, and backtracking re-enters the tile at l0.
    """
    if l0 == local.levels:
        return pipeline.match_from_descriptors(
            desc_src, desc_tgt, cfg, local, route, reverse=reverse,
            origin_offset=halo_q)
    volume = (costvol_ops.cost_volume if route == "torch"
              else costvol_cuda.cost_volume)
    cost0 = volume(desc_src, desc_tgt, local.disparities, cfg.patch_size,
                   cfg.max_disparity, reverse=reverse, origin_offset=halo_q)
    maps, args = pipeline.build_pyramid(cost0, l0, cfg.lam)
    top_full = collectives.all_gather(maps[l0], mesh, "tw", dim=-2)
    cmaps, cargs = pipeline.build_pyramid(top_full, local.levels - l0,
                                          cfg.lam)
    k = torch.argmax(cmaps[-1], dim=-1)             # first max wins ties
    k = pipeline.backtrack_from(k, cargs, dim=-1)   # level l0, full width
    w_l0 = local.grid_w >> l0
    tw = axis_index(mesh, "tw")
    k = k[..., tw * w_l0:(tw + 1) * w_l0]
    k = pipeline.backtrack_from(k, args, dim=-1)
    score = torch.gather(maps[0], -1, k[..., None])[..., 0]
    return k.to(torch.int32), score


# ---------------------------------------------------------------------------
# Strategy entry point
# ---------------------------------------------------------------------------


def match_batch_tiled2d(lefts_p, rights_p, cfg: Config, height: int,
                        width: int, mesh: DeviceMesh, route: str = "fused",
                        merge_level: Optional[int] = None) -> Outputs:
    """Batched pipeline over a ("data", "th", "tw") mesh.

    Args:
      lefts_p/rights_p: (B, Hp, Wp) pairs padded with `pad_batch(...,
        strategy="wtiled", merge_level=...)`, the full batch on every
        rank.
    Returns the (B, height, width) outputs.
    """
    n_th, n_tw = axis_size(mesh, "th"), axis_size(mesh, "tw")
    glob, local, l0 = tiled2d_geometry(cfg, height, width, n_th, n_tw,
                                       merge_level)
    p = cfg.patch_size
    halo_q = halo_patches(cfg)
    halo_px = halo_q * p
    mc = 1 if cfg.descriptor == "grad_hist" else 0
    mr = 1 if (cfg.descriptor == "grad_hist" and n_th > 1) else 0
    hl, wl = local.padded_height, local.padded_width
    n_q = -(-local.disparities // p)    # LR-halo patch columns (padded D)
    if halo_px + mc > wl:
        raise ValueError(
            f"W-tile width {wl} px cannot carry a {halo_px + mc} px halo "
            f"(max_disparity={cfg.max_disparity}); use fewer W-tiles")
    if cfg.lr_check and n_q + 1 > local.grid_w:
        raise ValueError(
            f"W-tile width {local.grid_w} patches cannot carry the LR halo "
            f"of {n_q + 1} patch columns; use fewer W-tiles")
    spec = input_spec("wtiled")
    tw = axis_index(mesh, "tw")
    row0 = axis_index(mesh, "th") * hl
    col0 = tw * wl - halo_px

    def exchange(x):    # (..., Hl, Wl) -> (..., Hl + 2mr, Wl + 2(halo_px + mc))
        if mr:
            x = _extend(x, mesh, "th", mr, dim=-2)
        return _extend(x, mesh, "tw", halo_px + mc, dim=-1)

    def match(src_slab, tgt_slab, reverse):
        feats = [_features_slab(x, cfg, row0, col0, glob.padded_height,
                                glob.padded_width, mr)
                 for x in (src_slab, tgt_slab)]
        desc_src = descriptors.patch_descriptors(
            feats[0][..., halo_px: halo_px + wl, :], cfg)
        desc_tgt = descriptors.sliding_descriptors(
            feats[1], cfg, col0=col0, width_global=glob.padded_width)
        return _match_tile(desc_src, desc_tgt, cfg, local, l0, halo_q,
                           route, reverse, mesh)

    def mirror(x):
        return _mirror(x, mesh, "tw", dim=-1)

    # Exchange once per image: the global flip commutes with the halo
    # exchange (a mirrored tile's halos are its mirrored neighbours'
    # edges, zeros past the image on both sides), so 'flip' mirrors the
    # extended slabs and the patch maps alike.
    lp, rp = (collectives.shard(x, mesh, spec) for x in (lefts_p, rights_p))
    disp_fwd, score, disp_r = pipeline.lr_directions(
        exchange(lp), exchange(rp), cfg, match, flip=mirror)
    lr_valid = None
    if disp_r is not None:
        # dR[x - dL] reaches across the tile's left edge: the neighbour's
        # trailing n_q + 1 patch columns, the sentinel at the first tile.
        halo = _from_prev(disp_r, mesh, "tw", n_q + 1, dim=-1)
        if tw == 0:
            halo.fill_(_SENTINEL)
        lr_valid = pipeline.lr_consistency_patch_padded(
            disp_fwd, torch.cat([halo, disp_r], -1), cfg.tau,
            local.disparities, p, col0_patches=tw * local.grid_w)
    out = pipeline.pixel_outputs(disp_fwd, score, cfg, disp_r, lr_valid)
    return finish(out, mesh, spec, cfg, height, width)
