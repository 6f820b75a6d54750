"""End-to-end DeepMatching stereo pipeline in torch (single device).

Counterpart of the JAX package's `models/pipeline.py`.  Every function
takes leading batch dimensions where JAX used `vmap`; `torch.gather`
takes the place of the TPU's one-hot selects.  Routes ('fused', 'exact',
'torch') are described in the package docstring; on a CUDA tensor the
'fused' and 'exact' routes run only the hand-written kernels, on a CPU
tensor the kernels' plain versions.  Which kernels a route runs is
decided by the config and geometry, as in the JAX package:

  'fused': K1 (image -> disparity) where `fused_cuda.supported` holds;
           else, for patch descriptors, K4 (image -> D-major volume),
           K5 (fast) and `match_dmajor` — the large-D route (KITTI);
           else the 'exact' route;
  'exact': descriptors in torch, K2 (cost volume), then K3 where
           `pyramid_cuda.supported` holds, else K5 (exact) and
           `match_dmajor`.

lr_mode='direct' matches right->left on shared descriptors with +d
targets (K2 with reverse=True), so 'fused' takes the 'exact' route there,
as in JAX.  The post-filter runs on the cropped outputs
(`apply_postfilter`).  Centred descriptors take the descriptor route
(K2 -> K3) on 'fused', as in JAX.

Config.dtype='bfloat16' (the JAX package's bf16 mode; outputs stay
float32) runs on every route and option, with the JAX package's two
semantics:
  * the descriptor routes ('torch', 'exact', centred descriptors,
    lr_mode='direct'): descriptors built, normalised and centred in
    float32, then rounded to bfloat16 (`match_from_descriptors`); each
    bin's products summed in float32 and rounded once; then a bfloat16
    pyramid that rounds every op (K2 bf16 -> K3 bf16, or K5 bf16 in exact
    mode at large D);
  * the fused routes (K1, K1b, K4 -> K5): the float32 cost rounded once
    (ops/fused_cuda.py), then the bfloat16 pyramid.
`check_supported` refuses only a dtype that the JAX package does not know.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import Config, Geometry

from ..ops import costvol as costvol_ops
from ..ops import costvol_cuda, fused_cuda, pyramid_cuda
from ..ops import pool as pool_ops
from ..ops import postfilter as postfilter_ops
from ..ops._dispatch import check_route, map_dtype
from ..ops.pyramid_cuda import descend as backtrack_from
from ..utils.logging import span
from . import descriptors

_SENTINEL = torch.iinfo(torch.int32).min // 2


def check_supported(cfg: Config, route: str) -> None:
    """Raise for a route the port does not know (ValueError) and for a
    dtype it does not run (NotImplementedError: float32 and bfloat16 run
    on every route)."""
    check_route(route)
    map_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# Pyramid + backtracking on the D-minor volume (the 'torch' route)
# ---------------------------------------------------------------------------


def build_pyramid(cost0: torch.Tensor, levels: int, lam: float
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Bottom-up aggregation on (..., H0, W0, D); returns (maps, args)."""
    maps = [cost0]
    args = []
    cur = cost0
    for _ in range(levels):
        sub, arg = pool_ops.pool3_subsample(cur)
        cur = pool_ops.aggregate_children(sub, lam)
        maps.append(cur)
        args.append(arg)
    return maps, args


def backtrack(maps: List[torch.Tensor], args: List[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense top-down argmax propagation -> (disp int32, score f32)."""
    k = torch.argmax(maps[len(args)], dim=-1)       # first max wins ties
    k = backtrack_from(k, args, dim=-1)
    score = torch.gather(maps[0], -1, k[..., None])[..., 0]
    return k.to(torch.int32), score.float()


def match_dmajor(cost_dm: torch.Tensor, levels: int, lam: float,
                 fast: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid + backtracking on a D-major (..., D0, H0, W0) volume too
    large for K3's tile: K5 aggregates level by level in device memory,
    then a first-max argmax over the top map, the descent and the score
    gather from the level-0 volume run in torch (`match_dmajor_xla`).
    fast=True defers the power (the fused large-D route)."""
    with span("pipeline.aggregate"):
        top, args = pyramid_cuda.aggregate_dmajor(cost_dm, levels, lam, fast)
    with span("pipeline.walk"):
        return pyramid_cuda.backtrack_top(cost_dm, top, args)


# ---------------------------------------------------------------------------
# Single direction on a padded grayscale pair
# ---------------------------------------------------------------------------


def match_from_descriptors(desc_src: torch.Tensor, desc_tgt: torch.Tensor,
                           cfg: Config, geom: Geometry, route: str,
                           reverse: bool = False, origin_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost volume + pyramid + backtracking on prepared descriptors; in
    bfloat16 the descriptors are rounded first (JAX's
    `match_from_descriptors`), and the volume and the pyramid are bf16."""
    if check_route(route) == "fused":
        route = "exact"     # descriptor-level callers cannot use K1
    dt = map_dtype(cfg.dtype)
    desc_src, desc_tgt = desc_src.to(dt), desc_tgt.to(dt)
    if route == "exact":
        cost_dm = costvol_cuda.cost_volume_dmajor(
            desc_src, desc_tgt, geom.disparities, cfg.patch_size,
            cfg.max_disparity, reverse=reverse, origin_offset=origin_offset)
        if pyramid_cuda.supported(geom.disparities, geom.levels):
            return pyramid_cuda.pyramid_backtrack(cost_dm, geom.levels,
                                                  cfg.lam)
        return match_dmajor(cost_dm, geom.levels, cfg.lam)
    cost0 = costvol_ops.cost_volume(
        desc_src, desc_tgt, geom.disparities, cfg.patch_size,
        cfg.max_disparity, reverse=reverse, origin_offset=origin_offset)
    maps, args = build_pyramid(cost0, geom.levels, cfg.lam)
    return backtrack(maps, args)


def one_direction(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                  geom: Geometry, route: str = "exact"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Hp, Wp) padded pairs -> (disp_patch, score), (..., H0, W0).

    'fused' runs K1 where `fused_cuda.supported` says it covers the
    config, else K4 -> K5 where `fused_cuda.cost_supported` does, else
    the 'exact' route — decided by the config.
    """
    if check_route(route) == "fused":
        if fused_cuda.supported(cfg, geom):
            return fused_cuda.match_rows(left, right, cfg, geom)
        if fused_cuda.cost_supported(cfg, geom):
            with span("pipeline.cost"):
                cost_dm = fused_cuda.cost_volume_rows(left, right, cfg, geom)
            return match_dmajor(cost_dm, geom.levels, cfg.lam, fast=True)
    desc_src = descriptors.left_descriptors(left, cfg)
    desc_tgt = descriptors.right_sliding_descriptors(right, cfg)
    return match_from_descriptors(desc_src, desc_tgt, cfg, geom, route)


# ---------------------------------------------------------------------------
# Both directions + consistency + densification (C11-C12)
# ---------------------------------------------------------------------------


def densify(patchwise: torch.Tensor, patch_size: int) -> torch.Tensor:
    return patchwise.repeat_interleave(patch_size, -2).repeat_interleave(
        patch_size, -1)


def lr_consistency_patch(disp_l: torch.Tensor, disp_r: torch.Tensor,
                         tau: float, num_disparities: int, patch_size: int
                         ) -> torch.Tensor:
    """Pixel-level LR validity from (..., H0, W0) patch disparity maps;
    returns (..., H0*p, W0*p) bool."""
    n_q = (num_disparities + patch_size - 1) // patch_size
    pad = torch.full((*disp_r.shape[:-1], n_q + 1), _SENTINEL,
                     dtype=disp_r.dtype, device=disp_r.device)
    return lr_consistency_patch_padded(
        disp_l, torch.cat([pad, disp_r], dim=-1), tau, num_disparities,
        patch_size)


def lr_consistency_patch_padded(disp_l: torch.Tensor, padded: torch.Tensor,
                                tau: float, num_disparities: int,
                                patch_size: int, col0_patches: int = 0
                                ) -> torch.Tensor:
    """`lr_consistency_patch` on a pre-padded (..., H0, n_q + 1 + W0) right
    map whose first n_q + 1 columns lie left of the checked range: the
    sentinel fill unsharded, the left W-neighbour's trailing columns in a
    W-tile (parallel/wtiled.py).  `col0_patches` is the global patch
    column of disp_l's first column, for the in-range test x >= dL.

    With dL = p*q + r, pixel column x = p*J + c reads dR's patch column
    J - q when c >= r, else J - q - 1: two gathers on patch maps.
    """
    p = patch_size
    n_q = (num_disparities + p - 1) // p
    *lead, h0, w0 = disp_l.shape
    dl = disp_l.to(torch.int64)
    q_l = torch.div(dl, p, rounding_mode="floor")
    r_l = dl - q_l * p
    jj = torch.arange(w0, device=disp_l.device)
    d_r_a = torch.gather(padded, -1, n_q + 1 + jj - q_l)
    d_r_b = torch.gather(padded, -1, n_q + jj - q_l)
    ok_a = (disp_l - d_r_a).abs() <= tau
    ok_b = (disp_l - d_r_b).abs() <= tau
    c = torch.arange(p, device=disp_l.device)
    xs = (col0_patches + jj[:, None]) * p + c       # (W0, p)
    valid = torch.where(c >= r_l[..., None], ok_a[..., None], ok_b[..., None])
    valid &= dl[..., None] <= xs
    return valid.reshape(*lead, h0, w0 * p).repeat_interleave(p, -2)


MatchFn = Callable[[torch.Tensor, torch.Tensor, bool],
                   Tuple[torch.Tensor, torch.Tensor]]


def lr_directions(left: torch.Tensor, right: torch.Tensor, cfg: Config,
                  match: MatchFn,
                  flip: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """The matching directions `cfg` asks for, each through
    `match(srcs, tgts, reverse) -> (disp_patch, score)`.

      flip:   L->R and the R->L pass on the flipped padded pair as one
              batch (a new leading dim of 2), so a kernel launches once;
      direct: L->R, then R->L with +d targets (reverse=True), no flip;
      no LR:  L->R only.

    `flip` is the horizontal flip of an image or a patch map (default:
    the local one; a W-sharded caller passes the global one).
    Returns (disp_fwd, score, disp_r_patch), the last None without LR.
    """
    if cfg.lr_check and cfg.lr_mode == "flip":
        flip = flip or (lambda x: x.flip(-1))
        with span("pipeline.flip"):
            srcs = torch.stack([left, flip(right)])
            tgts = torch.stack([right, flip(left)])
        with span("pipeline.match"):
            disp, score = match(srcs, tgts, False)
        # densify(x).flip(-1) == densify(x.flip(-1)) on patch-aligned widths.
        with span("pipeline.flip"):
            disp_r = flip(disp[1])
        return disp[0], score[0], disp_r
    with span("pipeline.match"):
        disp_fwd, score = match(left, right, False)
    if not cfg.lr_check:
        return disp_fwd, score, None
    with span("pipeline.match"):
        disp_rev, _ = match(right, left, True)
    return disp_fwd, score, disp_rev


def pixel_outputs(disp_fwd: torch.Tensor, score: torch.Tensor, cfg: Config,
                  disp_r_patch: Optional[torch.Tensor] = None,
                  lr_valid: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """(..., H0, W0) patch decisions -> the five (..., Hp, Wp) outputs;
    `lr_valid` is the LR check's pixel validity when disp_r_patch is
    given."""
    disp_px = densify(disp_fwd, cfg.patch_size)
    score_px = densify(score, cfg.patch_size)
    valid = torch.ones(disp_px.shape, dtype=torch.bool, device=disp_px.device)
    disp_r_px = torch.zeros_like(disp_px)
    if disp_r_patch is not None:
        disp_r_px = densify(disp_r_patch, cfg.patch_size)
        valid &= lr_valid
    if cfg.min_score > 0.0:
        valid &= score_px >= cfg.min_score
    out = torch.where(valid, disp_px.to(torch.float32),
                      torch.full((), cfg.invalid_value, dtype=torch.float32,
                                 device=disp_px.device))
    return {
        "disparity": out,
        "disparity_raw": disp_px,
        "valid": valid,
        "score": score_px,
        "disparity_right": disp_r_px,
    }


def match_padded_core(left_p: torch.Tensor, right_p: torch.Tensor,
                      cfg: Config, geom: Geometry, route: str = "fused"
                      ) -> Dict[str, torch.Tensor]:
    """(..., Hp, Wp) padded pairs -> PADDED (..., Hp, Wp) outputs.

    lr_mode='flip' and no LR run `one_direction`; 'direct' builds each
    image's patch and sliding descriptors once and runs
    `match_from_descriptors` both ways ('fused' becomes 'exact' there).
    """
    check_supported(cfg, route)
    if cfg.lr_check and cfg.lr_mode == "direct":
        def match(srcs, tgts, reverse):
            return match_from_descriptors(
                descriptors.left_descriptors(srcs, cfg),
                descriptors.right_sliding_descriptors(tgts, cfg), cfg, geom,
                route, reverse=reverse)
    else:
        def match(srcs, tgts, reverse):
            return one_direction(srcs, tgts, cfg, geom, route)
    with span("pipeline.step"):
        disp_fwd, score, disp_r_patch = lr_directions(left_p, right_p, cfg,
                                                      match)
        lr_valid = None
        if disp_r_patch is not None:
            with span("pipeline.lr_check"):
                lr_valid = lr_consistency_patch(
                    disp_fwd, disp_r_patch, cfg.tau, geom.disparities,
                    cfg.patch_size)
        with span("pipeline.outputs"):
            return pixel_outputs(disp_fwd, score, cfg, disp_r_patch,
                                 lr_valid)


def crop(outputs: Dict[str, torch.Tensor], height: int, width: int
         ) -> Dict[str, torch.Tensor]:
    """Crop padded (..., Hp, Wp) outputs back to the true image size."""
    return {k: v[..., :height, :width] for k, v in outputs.items()}


def apply_postfilter(out: Dict[str, torch.Tensor], cfg: Config
                     ) -> Dict[str, torch.Tensor]:
    """C13 on cropped outputs (leading batch dims allowed): the configured
    median and fill on "disparity"; the other keys stay raw."""
    if not (cfg.median_filter or cfg.fill_invalid):
        return out
    return {**out, "disparity": postfilter_ops.postfilter(
        out["disparity"], cfg.median_filter, cfg.fill_invalid)}


def match_padded(left_p: torch.Tensor, right_p: torch.Tensor, cfg: Config,
                 height: int, width: int, route: str = "fused"
                 ) -> Dict[str, torch.Tensor]:
    """Padded f32 pairs -> cropped, post-filtered outputs."""
    geom = cfg.geometry(height, width)
    return apply_postfilter(
        crop(match_padded_core(left_p, right_p, cfg, geom, route), height,
             width), cfg)
