"""Pipeline configuration (the port's copy of the JAX package's
`config.py`: the same fields, defaults and `geometry()` rule), and
`carry_over`, which moves a configuration across from the JAX package.

The reference (`Yuki-Kumon/deepmatching_stereo_matching`; mount empty at
survey time, see SURVEY.md §0) hard-codes its DeepMatching constants in its
main script (SURVEY.md §5.6 / C15).  This framework centralises every
canonical knob (patch size, pyramid depth, disparity range, pool window,
subsample factor, rectification exponent lambda, LR threshold tau
[DM §3 / SURVEY.md §5.6]) in one frozen, hashable dataclass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


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


def carry_over(obj) -> Config:
    """The port's `Config` with the fields of `obj`, any dataclass instance
    with exactly `Config`'s fields (such as the JAX package's `Config`).

    The system has no learned weights: the state the two packages share
    is the configuration (and the padded images, plain numpy), so this is
    the port's weight converter.  Raises ValueError on a missing or an
    unknown field.
    """
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"expected a dataclass instance, got {type(obj)!r}")
    fields = dataclasses.asdict(obj)
    want = {f.name for f in dataclasses.fields(Config)}
    missing, unknown = want - fields.keys(), fields.keys() - want
    if missing or unknown:
        raise ValueError(f"cannot carry {type(obj).__name__} over to Config: "
                         f"missing fields {sorted(missing)}, unknown fields "
                         f"{sorted(unknown)}")
    return Config(**fields)
