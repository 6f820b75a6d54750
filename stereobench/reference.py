"""The plain reference: a frozen NumPy copy of the port's oracle.

The benchmark decides `correct` by comparing what the program's timed
path produced with this module's answer on the same inputs.  It is a copy,
kept in the benchmark's folder so that no later change to the program can
move it: `Config` and `Geometry` (the padding and pyramid arithmetic) and
the loop-based NumPy pipeline (descriptors, correlation volume,
aggregation pyramid, backtracking, LR check, post-filter).  It imports
numpy alone; `tests/test_stereobench_frozen.py` holds it equal to the
program's `oracle.match_stereo`.

Everything is float32; every argmax and max-pool tie goes to the smallest
disparity.  [DM] = Revaud et al., "DeepMatching: Hierarchical Deformable
Dense Matching", IJCV 2016 (arXiv:1506.07656).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


def _log2_floor(x: int) -> int:
    return max(0, int(math.floor(math.log2(x))) if x > 0 else 0)


@dataclasses.dataclass(frozen=True)
class Config:
    """Static configuration of the DeepMatching stereo pipeline.

    Attributes:
      max_disparity: exclusive upper bound of the disparity search range D.
        Disparities d with 0 <= d < max_disparity are searched.
      patch_size: side of the atomic (level-0) square patch in pixels.
        DeepMatching canonical value: 4 [DM §3.1].
      levels: number of bottom-up aggregation levels L.  ``None`` selects
        the deepest pyramid such that the top level still has at least
        ``min_top_disparities`` disparity bins and a >= 2x2 spatial grid.
      lam: power-rectification exponent applied after every aggregation,
        x -> x**lam [DM §3.2]; canonical value 1.4.
      tau: left-right consistency threshold in pixels (SURVEY.md §3.5).
      pool_window: max-pool window along the disparity axis per level
        (canonical 3 -> +-1 px deformation tolerance per level [DM §3.2]).
      subsample: disparity/target subsample factor per level (canonical 2).
      descriptor: 'patch' (L2-normalised raw intensity patch) or
        'grad_hist' (8-orientation gradient-histogram, dense-SIFT-like
        [DM §3.1]).  Both are exposed because the reference's exact variant
        is unverifiable (SURVEY.md §2 row C2, §7 hard part 6).
      center_descriptors: subtract the patch mean before normalising
        (ZNCC-style) in 'patch' mode.
      lr_check: run the right-to-left pass and invalidate inconsistent
        pixels (SURVEY.md C12).
      lr_mode: how the right-to-left pass is computed — 'flip' (match
        the horizontally flipped pair, the oracle's definition) or
        'direct' (match right->left with +d target columns; identical
        up to f32 reduction order, and the only form that shards over
        W-tiles, SURVEY.md §5.7).
      min_score: matches whose level-0 correlation falls below this are
        invalidated (0 disables).
      invalid_value: value written into invalidated pixels of the final
        float disparity map.
      dtype: compute dtype of the cost volume / pyramid ('float32' or
        'bfloat16'; f32 is the bit-comparability default, SURVEY.md §7
        hard part 5).  NOTE: on the flagship fused path bf16 is both
        SLOWER than f32 (the kernel is VMEM-resident and VPU-bound, so
        bf16 halves no binding resource while adding casts — measured
        in bench.py's bf16 row) and less accurate; its value is
        HBM-bound paths only (two-kernel, large-D volumes).
      min_top_disparities: used by automatic level selection.
      fused_dot_precision: MXU precision scheme of the fused kernel's
        selection/compaction matmuls (ops/fused_pallas.py).  'split2'
        (default) runs each matmul as 2 native-speed bf16 passes over a
        hi+residual split (~2^-16 relative accuracy; measured ~1e-5
        disparity-decision disagreement vs exact on near-ties, inside
        bench.py's 0.5% parity gate and ~10% faster end-to-end);
        'split3' adds a third residual pass (~2^-24); 'highest' restores
        Mosaic's exact 6-pass f32 matmuls.  Only the fused impl is
        affected — the two-kernel 'pallas' path is always exact.
      median_filter: odd window size of the post-filter median over the
        final disparity map (C13, SURVEY.md §2.1; 0 disables).  Invalid
        pixels are excluded from each window; the lower median is taken,
        so integer disparities stay integral.
      fill_invalid: fill invalidated pixels with the smaller of the
        nearest valid disparities left/right on the scanline (classic
        occlusion background-fill; C13).
    """

    max_disparity: int = 64
    patch_size: int = 4
    levels: Optional[int] = None
    lam: float = 1.4
    tau: float = 1.0
    pool_window: int = 3
    subsample: int = 2
    descriptor: str = "patch"
    center_descriptors: bool = False
    lr_check: bool = True
    lr_mode: str = "flip"
    min_score: float = 0.0
    invalid_value: float = float("nan")
    dtype: str = "float32"
    fused_dot_precision: str = "split2"
    min_top_disparities: int = 4
    median_filter: int = 0
    fill_invalid: bool = False

    def __post_init__(self) -> None:
        if self.max_disparity < 1:
            raise ValueError("max_disparity must be >= 1")
        if self.patch_size < 1:
            raise ValueError("patch_size must be >= 1")
        if self.subsample != 2:
            raise ValueError("only the canonical subsample factor 2 is supported")
        if self.pool_window != 3:
            raise ValueError("only the canonical 3-wide disparity pool is supported")
        if self.descriptor not in ("patch", "grad_hist"):
            raise ValueError(f"unknown descriptor mode: {self.descriptor!r}")
        if self.lr_mode not in ("flip", "direct"):
            raise ValueError(f"unknown lr_mode: {self.lr_mode!r}")
        if self.fused_dot_precision not in ("split2", "split3", "highest"):
            raise ValueError(
                f"unknown fused_dot_precision: {self.fused_dot_precision!r}")
        if self.levels is not None and self.levels < 1:
            raise ValueError("levels must be >= 1")
        if self.median_filter and (self.median_filter < 0
                                   or self.median_filter % 2 == 0):
            raise ValueError("median_filter must be 0 or an odd window size")

    # ---- derived static geometry -------------------------------------

    def num_levels(self, height: int, width: int) -> int:
        """Resolved pyramid depth L for an image of the given size."""
        if self.levels is not None:
            return self.levels
        p = self.patch_size
        # Deepest L with top-level disparity bins >= min_top_disparities
        # and top-level grid >= 2x2.
        d_cap = _log2_floor(max(1, self.padded_disparities_for(1) // self.min_top_disparities))
        g0 = min(height, width) // p
        g_cap = _log2_floor(max(1, g0 // 2))
        return max(1, min(d_cap, g_cap))

    def padded_disparities_for(self, levels: int) -> int:
        """D0: max_disparity rounded up to a multiple of 2**levels."""
        m = self.subsample ** levels
        return ((self.max_disparity + m - 1) // m) * m

    def padded_image_size(self, height: int, width: int, levels: int) -> tuple:
        """(Hp, Wp): image size padded so the level-0 grid divides 2**L.

        Width is additionally padded to a LANE-ALIGNED patch grid
        (W0 = Wp/p a multiple of 128, the TPU vector register lane
        count) when that costs <= 25% extra columns: ragged lane tiles
        tax every Mosaic vector op on (., W0) planes — measured 2.5x
        on the KITTI large-D cost kernel (W0 320 -> 384 made the
        kernel faster despite 20% more pixels; PROFILE_LARGE r5).
        Padding columns are zeros, which score exactly 0 (the oracle's
        out-of-range rule), so results on the true image region are
        unchanged; the NumPy oracle pads identically, keeping parity
        bitwise by construction.
        """
        m = self.patch_size * (self.subsample ** levels)
        hp = ((height + m - 1) // m) * m
        wp = ((width + m - 1) // m) * m
        lane_m = self.patch_size * 128
        lane_m = (lane_m * m) // math.gcd(lane_m, m)
        wa = ((wp + lane_m - 1) // lane_m) * lane_m
        if wa <= wp * 5 // 4:
            wp = wa
        return hp, wp

    def geometry(self, height: int, width: int) -> "Geometry":
        lvl = self.num_levels(height, width)
        hp, wp = self.padded_image_size(height, width, lvl)
        d0 = self.padded_disparities_for(lvl)
        return Geometry(
            height=height,
            width=width,
            levels=lvl,
            padded_height=hp,
            padded_width=wp,
            grid_h=hp // self.patch_size,
            grid_w=wp // self.patch_size,
            disparities=d0,
        )


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Resolved static shapes of one pipeline instantiation."""

    height: int
    width: int
    levels: int
    padded_height: int
    padded_width: int
    grid_h: int
    grid_w: int
    disparities: int

    def level_shape(self, level: int) -> tuple:
        s = 2 ** level
        return (self.grid_h // s, self.grid_w // s, self.disparities // s)


_EPS = 1e-8


# ---------------------------------------------------------------------------
# Preprocessing & descriptors (C1-C3)
# ---------------------------------------------------------------------------


def to_grayscale_f32(image: np.ndarray) -> np.ndarray:
    """uint8 or float image, (H, W) or (H, W, 3) -> float32 (H, W) in [0, 1]."""
    img = np.asarray(image)
    if img.ndim == 3:
        # Explicit left-to-right f32 sum (not `@`): BLAS sgemv's rounding
        # order is platform-dependent; this order is reproduced bit-
        # exactly by the native C++ prologue (native/src/dmstereo_io.cpp,
        # built with -ffp-contract=off).
        rgb = img[..., :3].astype(np.float32)
        img = (np.float32(0.299) * rgb[..., 0]
               + np.float32(0.587) * rgb[..., 1]
               + np.float32(0.114) * rgb[..., 2])
    img = img.astype(np.float32)
    if img.max(initial=0.0) > 1.5:  # assume 8-bit range
        img = img / np.float32(255.0)
    return img


def pad_image(img: np.ndarray, geom: Geometry) -> np.ndarray:
    """Zero-pad bottom/right so the level-0 grid divides 2**levels."""
    out = np.zeros((geom.padded_height, geom.padded_width), dtype=np.float32)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def _grad_hist_pixels(img: np.ndarray, bins: int = 8) -> np.ndarray:
    """Per-pixel magnitude-weighted hard-assigned orientation histogram.

    Returns (H, W, bins) float32.  A dense-SIFT-like pixel descriptor in
    the spirit of [DM §3.1], defined with EXACT float ops only:
    comparison-based octant binning (8 half-open [-pi, pi) octants, the
    same sectors arctan2-based binning yields) and an L1 gradient
    magnitude.  No arctan2/sqrt means every backend and every sharding
    of the jnp path (models/descriptors.py:hist_from_gradients)
    reproduces this bit-for-bit regardless of XLA fusion/FMA/veclib
    choices — measured on CPU XLA, sqrt/arctan2 results change by ULPs
    with fusion context, which flips bins and breaks the bit-equality
    mandate (SURVEY.md §5.2, BASELINE.json:5).
    """
    if bins != 8:
        raise ValueError("grad_hist is defined for 8 orientation bins")
    gy, gx = np.gradient(img.astype(np.float32))
    ax, ay = np.abs(gx), np.abs(gy)
    mag = ax + ay
    # Octants of atan2(gy, gx) in [-pi, pi), bin k covering
    # [-pi + k*pi/4, -pi + (k+1)*pi/4), via exact comparisons.
    idx_up = np.where(gx > 0, np.where(ay >= ax, 5, 4),
                      np.where(ay > ax, 6, 7))
    idx_dn = np.where(gx >= 0, np.where(ay > ax, 2, 3),
                      np.where(ay >= ax, 1, 0))
    bin_idx = np.where(gy >= 0, idx_up, idx_dn).astype(np.int32)
    out = np.zeros(img.shape + (bins,), dtype=np.float32)
    np.put_along_axis(out, bin_idx[..., None], mag[..., None], axis=-1)
    return out


def _pixel_features(img: np.ndarray, cfg: Config) -> np.ndarray:
    """(H, W) image -> (H, W, F) per-pixel feature map."""
    if cfg.descriptor == "patch":
        return img[..., None]  # F = 1: raw intensity
    return _grad_hist_pixels(img)  # F = 8


def _normalize(desc: np.ndarray) -> np.ndarray:
    norm = np.sqrt(np.sum(desc * desc, axis=-1, keepdims=True))
    return desc / np.maximum(norm, np.float32(_EPS))


def left_descriptors(img: np.ndarray, cfg: Config) -> np.ndarray:
    """Non-overlapping patch descriptors at stride `patch_size` (C2+C3).

    Returns (H0, W0, C) L2-normalised, C = patch_size**2 * F.
    """
    p = cfg.patch_size
    feat = _pixel_features(img, cfg)
    h, w, f = feat.shape
    h0, w0 = h // p, w // p
    blocks = feat[: h0 * p, : w0 * p].reshape(h0, p, w0, p, f)
    desc = blocks.transpose(0, 2, 1, 3, 4).reshape(h0, w0, p * p * f)
    if cfg.center_descriptors:
        desc = desc - desc.mean(axis=-1, keepdims=True)
    return _normalize(desc.astype(np.float32))


def right_sliding_descriptors(img: np.ndarray, cfg: Config) -> np.ndarray:
    """Patch descriptors of the right image at EVERY column offset (C2).

    Returns (H0, Wp, C): entry [i, x0] describes the patch whose top-left
    corner is (patch_size*i, x0).  Windows that overrun the right edge
    (x0 > Wp - patch_size) are zero, so they correlate to zero.
    """
    p = cfg.patch_size
    feat = _pixel_features(img, cfg)
    h, w, f = feat.shape
    h0 = h // p
    c = p * p * f
    desc = np.zeros((h0, w, c), dtype=np.float32)
    rows = feat[: h0 * p].reshape(h0, p, w, f)
    for x0 in range(w - p + 1):
        block = rows[:, :, x0 : x0 + p, :]  # (H0, p, p, F)
        desc[:, x0, :] = block.reshape(h0, c)
    if cfg.center_descriptors:
        desc = desc - desc.mean(axis=-1, keepdims=True)
    return _normalize(desc)


# ---------------------------------------------------------------------------
# Level-0 correlation cost volume (C4) — HOT LOOP #1 (SURVEY.md §3.2)
# ---------------------------------------------------------------------------


def cost_volume(desc_src: np.ndarray, desc_tgt: np.ndarray,
                disparities: int, patch_size: int,
                max_disparity: Optional[int] = None,
                reverse: bool = False) -> np.ndarray:
    """C0[i, j, d] = max(0, <src[i, j], tgt[i, patch_size*j -+ d]>).

    Forward (reverse=False): src = left patches, tgt = right sliding
    descriptors, target column p*j - d.  Reverse: src = right patches,
    tgt = LEFT sliding descriptors, target column p*j + d — the direct
    right-to-left pass used by lr_mode='direct' (SURVEY.md §3.5).

    Out-of-range targets score 0, as do the padding bins
    d >= max_disparity (D0 is max_disparity rounded up to a multiple of
    2**levels; the user-requested range must stay the effective search
    range).  This is the reference's hot loop (BASELINE.json:5
    "per-patch correlation kernel, NumPy/loop code"); kept as an
    explicit Python loop over d.
    Returns (H0, W0, D0) float32, values in [0, 1].
    """
    h0, w0, _ = desc_src.shape
    wt = desc_tgt.shape[1]
    if max_disparity is None:
        max_disparity = disparities
    cost = np.zeros((h0, w0, disparities), dtype=np.float32)
    xs = np.arange(w0) * patch_size  # source patch top-left columns
    for d in range(min(disparities, max_disparity)):
        x0 = xs + d if reverse else xs - d
        valid = (x0 >= 0) & (x0 < wt)
        tgt = desc_tgt[:, np.clip(x0, 0, wt - 1), :]  # (H0, W0, C)
        corr = np.einsum("ijc,ijc->ij", desc_src, tgt)
        cost[:, :, d] = np.where(valid[None, :], np.maximum(corr, 0.0), 0.0)
    return cost


# ---------------------------------------------------------------------------
# Aggregation pyramid, bottom-up (C5-C8) — [DM §3.2]
# ---------------------------------------------------------------------------


def pool3_subsample(maps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """3-wide max-pool along the disparity axis, then x2 subsample (C5).

    Pool window at d is {d-1, d, d+1} clipped to range; the pad value -1
    is below every valid correlation (>= 0), so the argmax offset always
    points in range.  Ties pick the SMALLEST resulting disparity.

    Returns (sub, arg):
      sub (H, W, D//2): pooled map sampled at even d,
      arg (H, W, D//2): offset in {-1, 0, +1} of the pool winner,
        i.e. level-(l) disparity = 2*k + arg[..., k].
    """
    h, w, d = maps.shape
    pad = np.full((h, w, 1), -1.0, dtype=maps.dtype)
    lo = np.concatenate([pad, maps[:, :, :-1]], axis=2)   # offset -1
    hi = np.concatenate([maps[:, :, 1:], pad], axis=2)    # offset +1
    stack = np.stack([lo, maps, hi], axis=-1)             # order => smallest d wins
    arg = np.argmax(stack, axis=-1).astype(np.int32) - 1  # first max
    pooled = np.max(stack, axis=-1)
    return pooled[:, :, ::2], arg[:, :, ::2]


def aggregate_children(sub: np.ndarray, lam: float) -> np.ndarray:
    """Quadtree 4-child merge + power rectification (C6+C7).

    Parent (I, J) averages its children (2I+u, 2J+v), u,v in {0,1} — the
    shifted-average of [DM §3.2 eq. 1] expressed in disparity space, where
    the per-child target shift cancels for rectified pairs (each child of
    a fronto-parallel parent shares the parent's disparity), then applies
    x -> x**lam [DM §3.2].
    """
    h, w, k = sub.shape
    quad = sub.reshape(h // 2, 2, w // 2, 2, k)
    # Fixed summation order — bit-identical to the device pipeline
    # (ops/pool.py:aggregate_children) and across shardings.
    merged = ((quad[:, 0, :, 0] + quad[:, 0, :, 1])
              + (quad[:, 1, :, 0] + quad[:, 1, :, 1])) * np.float32(0.25)
    return np.power(merged, np.float32(lam), dtype=np.float32)


def build_pyramid(cost0: np.ndarray, levels: int, lam: float
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Bottom-up pass (C8): returns (maps, args).

    maps[l]  — correlation map at level l, l = 0..levels  (level 0 = cost0)
    args[l]  — pool argmax offsets recorded while building level l+1;
               needed by the dense backtracking pass (SURVEY.md §3.4).
    """
    maps = [cost0]
    args = []
    cur = cost0
    for _ in range(levels):
        sub, arg = pool3_subsample(cur)
        cur = aggregate_children(sub, lam)
        maps.append(cur)
        args.append(arg)
    return maps, args


# ---------------------------------------------------------------------------
# Top-down backtracking (C9-C10) — dense reformulation (SURVEY.md §3.4)
# ---------------------------------------------------------------------------


def backtrack(maps: List[np.ndarray], args: List[np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense argmax propagation, top level -> atomic patches.

    The reference's recursive descent [DM §3.3] is reformulated densely:
    every top-level cell seeds its best disparity bin (argmax, ties ->
    smallest index), and each level hands each child cell the pool-argmax
    refinement recorded during the bottom-up pass.  With the quadtree
    children structure each child has exactly one parent, so "best score
    per atomic patch" dedup is trivial.  Mathematically the same retrieval
    as the recursion (SURVEY.md §3.4).

    Returns (disp_patch int32 (H0, W0) — pixel disparities per atomic
    patch — and score float32 (H0, W0) — the level-0 correlation at the
    chosen disparity).
    """
    levels = len(args)
    top = maps[levels]
    k = np.argmax(top, axis=-1).astype(np.int32)  # first max = smallest d
    for lvl in range(levels - 1, -1, -1):
        # Child cell (2I+u, 2J+v) inherits parent bin k; its level-lvl
        # disparity is 2k + arg[child, k] (arg is indexed by the
        # subsampled bin k, see pool3_subsample).
        kr = np.repeat(np.repeat(k, 2, axis=0), 2, axis=1)
        off = np.take_along_axis(args[lvl], kr[:, :, None], axis=2)[:, :, 0]
        k = 2 * kr + off
    score = np.take_along_axis(maps[0], k[:, :, None], axis=2)[:, :, 0]
    return k, score


# ---------------------------------------------------------------------------
# Disparity extraction + LR consistency (C11-C12)
# ---------------------------------------------------------------------------


def densify(disp_patch: np.ndarray, patch_size: int, height: int,
            width: int) -> np.ndarray:
    """Patch-level disparities -> per-pixel map (nearest), cropped (C11)."""
    dense = np.repeat(np.repeat(disp_patch, patch_size, axis=0),
                      patch_size, axis=1)
    return dense[:height, :width]


def lr_consistency(disp_l: np.ndarray, disp_r: np.ndarray, tau: float
                   ) -> np.ndarray:
    """valid[y, x] = |dL[y,x] - dR[y, x - dL[y,x]]| <= tau (SURVEY.md §3.5)."""
    h, w = disp_l.shape
    xs = np.arange(w)[None, :]
    xr = xs - disp_l
    in_range = (xr >= 0) & (xr < w)
    xr_safe = np.clip(xr, 0, w - 1)
    d_r = np.take_along_axis(disp_r, xr_safe, axis=1)
    return in_range & (np.abs(disp_l - d_r) <= tau)


# ---------------------------------------------------------------------------
# Post-filtering (C13) — presence in the reference unverified [K-low];
# included for parity safety (SURVEY.md §2 row C13), off by default.
# Semantics match ops/postfilter.py bit-for-bit.
# ---------------------------------------------------------------------------


def median_valid(disp: np.ndarray, k: int, keep_invalid_center: bool
                 ) -> np.ndarray:
    """Lower-median of the valid values in each edge-clamped k*k window."""
    h, w = disp.shape
    r = k // 2
    rows = np.clip(np.arange(h)[:, None] + np.arange(-r, r + 1)[None, :],
                   0, h - 1)
    cols = np.clip(np.arange(w)[:, None] + np.arange(-r, r + 1)[None, :],
                   0, w - 1)
    win = disp[rows][:, :, cols].transpose(0, 2, 1, 3).reshape(h, w, k * k)
    finite = np.isfinite(win)
    n = finite.sum(axis=-1)
    vals = np.sort(np.where(finite, win, np.inf), axis=-1)
    idx = np.maximum(n - 1, 0) // 2
    med = np.take_along_axis(vals, idx[..., None], axis=-1)[..., 0]
    out = np.where(n > 0, med, disp)
    if keep_invalid_center:
        out = np.where(np.isfinite(disp), out, disp)
    return out.astype(np.float32)


def fill_background(disp: np.ndarray) -> np.ndarray:
    """Fill invalid pixels with min(nearest valid left, right) per row."""
    h, w = disp.shape
    valid = np.isfinite(disp)
    iota = np.broadcast_to(np.arange(w, dtype=np.int32), (h, w))
    left_idx = np.maximum.accumulate(np.where(valid, iota, -1), axis=1)
    right_idx = (w - 1 - np.maximum.accumulate(
        np.where(valid, w - 1 - iota, -1)[:, ::-1], axis=1))[:, ::-1]
    safe = np.where(valid, disp, np.inf)
    left_val = np.where(left_idx >= 0,
                        np.take_along_axis(safe, np.maximum(left_idx, 0),
                                           axis=1), np.inf)
    right_val = np.where(right_idx <= w - 1,
                         np.take_along_axis(safe,
                                            np.minimum(right_idx, w - 1),
                                            axis=1), np.inf)
    fill = np.minimum(left_val, right_val)
    filled = np.where(valid, disp, fill)
    return np.where(np.isfinite(filled), filled, disp).astype(np.float32)


def postfilter(disp: np.ndarray, median: int, fill: bool) -> np.ndarray:
    out = disp
    if median:
        out = median_valid(out, median, keep_invalid_center=not fill)
    if fill:
        out = fill_background(out)
    return out


# ---------------------------------------------------------------------------
# End-to-end pipeline (C15)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OracleResult:
    disparity: np.ndarray        # float32 (H, W); invalid = cfg.invalid_value
    disparity_raw: np.ndarray    # int32 (H, W) pre-filter L->R disparities
    valid: np.ndarray            # bool (H, W)
    score: np.ndarray            # float32 (H, W) level-0 correlation
    disparity_right: Optional[np.ndarray]  # int32 (H, W) R->L pass (if run)


def _one_direction(src: np.ndarray, tgt: np.ndarray, cfg: Config,
                   geom: Geometry, reverse: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Full single-direction pipeline on padded grayscale images.

    Forward: src = left image, tgt = right image.  Reverse: src = right
    image, tgt = left image, disparity searched at +d target columns.
    """
    desc_src = left_descriptors(src, cfg)
    desc_tgt = right_sliding_descriptors(tgt, cfg)
    cost0 = cost_volume(desc_src, desc_tgt, geom.disparities,
                        cfg.patch_size, cfg.max_disparity, reverse=reverse)
    maps, args = build_pyramid(cost0, geom.levels, cfg.lam)
    return backtrack(maps, args)


def match_stereo(left: np.ndarray, right: np.ndarray,
                 cfg: Config = Config()) -> OracleResult:
    """Dense disparity for a rectified pair — the golden end-to-end path.

    Mirrors the reference's only entry point (SURVEY.md §3.1): both
    matching directions are run when cfg.lr_check is set, the right
    disparity being obtained by matching the horizontally flipped pair
    with swapped roles (d_R(x) = d'_L(W-1-x), SURVEY.md §3.5 note).
    """
    gl = to_grayscale_f32(left)
    gr = to_grayscale_f32(right)
    if gl.shape != gr.shape:
        raise ValueError("left/right shapes differ")
    h, w = gl.shape
    geom = cfg.geometry(h, w)
    pl_, pr = pad_image(gl, geom), pad_image(gr, geom)

    disp_patch, score_patch = _one_direction(pl_, pr, cfg, geom)
    disp = densify(disp_patch, cfg.patch_size, h, w).astype(np.int32)
    score = densify(score_patch, cfg.patch_size, h, w)

    disp_r_px = None
    valid = np.ones((h, w), dtype=bool)
    if cfg.lr_check:
        if cfg.lr_mode == "flip":
            # d_R(x) = d'_L(W-1-x) of the horizontally flipped pair.
            fl = np.ascontiguousarray(pl_[:, ::-1])
            fr = np.ascontiguousarray(pr[:, ::-1])
            disp_r_patch, _ = _one_direction(fr, fl, cfg, geom)
            disp_r_full = densify(
                disp_r_patch, cfg.patch_size,
                geom.padded_height, geom.padded_width)[:, ::-1]
        else:  # 'direct': match right->left without flipping
            disp_r_patch, _ = _one_direction(pr, pl_, cfg, geom,
                                             reverse=True)
            disp_r_full = densify(disp_r_patch, cfg.patch_size,
                                  geom.padded_height, geom.padded_width)
        disp_r_px = disp_r_full[:h, :w].astype(np.int32)
        valid &= lr_consistency(disp, disp_r_px, cfg.tau)
    if cfg.min_score > 0.0:
        valid &= score >= cfg.min_score

    out = disp.astype(np.float32)
    out[~valid] = np.float32(cfg.invalid_value)
    if cfg.median_filter or cfg.fill_invalid:
        out = postfilter(out, cfg.median_filter, cfg.fill_invalid)
    return OracleResult(
        disparity=out,
        disparity_raw=disp,
        valid=valid,
        score=score,
        disparity_right=disp_r_px,
    )
