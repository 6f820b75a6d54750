"""Synthetic rectified stereo pairs with exact integer ground truth.

The reference validates visually on Middlebury cones/teddy pairs
(BASELINE.json:7); those images are not available in this offline
environment, so tests and benchmarks use synthetic pairs with *known*
integer disparity (SURVEY.md §4.3): a random right-image texture is warped
into the left image by a piecewise-constant disparity field, which the
pipeline must recover exactly away from occlusions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def block_disparity_field(height: int, width: int, max_disparity: int,
                          rng: np.random.Generator, block: int = 32,
                          align: int = 4) -> np.ndarray:
    """Piecewise-constant random integer disparity field (H, W).

    Values are multiples of `align` (default: the patch size) so every
    atomic 4x4 patch sees a single, patch-aligned shift — making exact
    recovery possible and tie-free in expectation.
    """
    bh = (height + block - 1) // block
    bw = (width + block - 1) // block
    n_vals = max(1, (max_disparity - 1) // align)
    vals = rng.integers(0, n_vals + 1, size=(bh, bw)) * align
    vals = np.minimum(vals, max_disparity - 1)
    field = np.repeat(np.repeat(vals, block, axis=0), block, axis=1)
    return field[:height, :width].astype(np.int32)


def constant_disparity_field(height: int, width: int,
                             disparity: int) -> np.ndarray:
    return np.full((height, width), disparity, dtype=np.int32)


def make_pair(height: int, width: int, disparity_field: np.ndarray,
              seed: int = 0, smooth: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build (left, right, gt_disparity) from a texture + disparity field.

    right is random texture; left[y, x] = right[y, x - d(y, x)].
    Pixels whose source column falls outside the right image keep random
    texture and are marked invalid (gt = -1).
    """
    rng = np.random.default_rng(seed)
    right = rng.uniform(0.0, 1.0, size=(height, width)).astype(np.float32)
    if smooth > 0:
        k = np.ones(smooth, dtype=np.float32) / smooth
        right = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, right)
        right = np.apply_along_axis(
            lambda c: np.convolve(c, k, mode="same"), 0, right)
    xs = np.arange(width)[None, :]
    src = xs - disparity_field
    valid = (src >= 0) & (src < width)
    src_safe = np.clip(src, 0, width - 1)
    left = np.take_along_axis(right, src_safe, axis=1)
    fill = rng.uniform(0.0, 1.0, size=left.shape).astype(np.float32)
    left = np.where(valid, left, fill).astype(np.float32)
    gt = np.where(valid, disparity_field, -1).astype(np.int32)
    return left, right, gt


def make_block_pair(height: int = 128, width: int = 192,
                    max_disparity: int = 32, seed: int = 0,
                    block: int = 32, align: int = 4
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convenience: random texture + block disparity field in one call."""
    rng = np.random.default_rng(seed + 1)
    field = block_disparity_field(height, width, max_disparity, rng,
                                  block=block, align=align)
    return make_pair(height, width, field, seed=seed)


# ---------------------------------------------------------------------------
# Adversarial scenes (VERDICT r3 item 7): the regimes LR-checking and
# post-filtering exist for — occlusions, textureless surfaces, and
# photometric asymmetry between the two eyes.  Block pairs are
# "friendly" (every patch has a unique, exact match); these are not.
# ---------------------------------------------------------------------------


def object_disparity_field(height: int, width: int, max_disparity: int,
                           rng: np.random.Generator, n_objects: int = 6,
                           align: int = 4) -> np.ndarray:
    """Near background plane + random high-disparity foreground boxes.

    Large disparity STEPS at object boundaries are what creates real
    occlusion bands (width = the step size) — unlike
    `block_disparity_field`, whose aligned blocks rarely jump far.
    """
    bg = align * rng.integers(0, max(1, max_disparity // (4 * align)) + 1)
    field = np.full((height, width), bg, dtype=np.int32)
    lo = max(align, (max_disparity // 2) // align * align)
    for _ in range(n_objects):
        h = int(rng.integers(height // 6, height // 2))
        w = int(rng.integers(width // 6, width // 2))
        y = int(rng.integers(0, max(1, height - h)))
        x = int(rng.integers(0, max(1, width - w)))
        n_vals = max(1, (max_disparity - 1 - lo) // align)
        d = lo + align * int(rng.integers(0, n_vals + 1))
        field[y:y + h, x:x + w] = min(d, max_disparity - 1)
    return field


def occlusion_mask(disparity_field: np.ndarray) -> np.ndarray:
    """Left-image pixels whose right-image source is hidden by a closer
    surface: x is occluded when another left pixel with HIGHER disparity
    maps to the same right column (src = x - d collides and loses)."""
    h, w = disparity_field.shape
    xs = np.arange(w)[None, :]
    src = xs - disparity_field
    occ = np.zeros((h, w), dtype=bool)
    for y in range(h):
        best = np.full(w, -1, dtype=np.int64)
        s = src[y]
        d = disparity_field[y]
        ok = (s >= 0) & (s < w)
        np.maximum.at(best, s[ok], d[ok])
        occ[y, ok] = d[ok] < best[s[ok]]
    return occ


def adversarial_pair(height: int, width: int, max_disparity: int,
                     seed: int = 0, n_objects: int = 6,
                     textureless_frac: float = 0.1, gain: float = 1.15,
                     bias: float = 0.05, noise: float = 0.02,
                     smooth: int = 2
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """(left, right, gt, occluded): a hostile scene with exact truth.

    * occluded foreground boundaries (`object_disparity_field` steps;
      `occluded` marks left pixels with no unique right counterpart —
      exactly the pixels the LR consistency check exists to reject);
    * textureless rectangles carved into the right texture (constant
      intensity -> every disparity correlates equally; smallest-d tie
      rules and LR rejection govern what survives);
    * photometric asymmetry: the left eye sees gain/bias/noise-distorted
      intensities (patch L2 normalisation cancels gain but NOT bias or
      noise).

    gt is -1 on pixels with no in-image source; `occluded` is reported
    separately so metrics can require occluded pixels to be REJECTED.
    """
    rng = np.random.default_rng(seed)
    field = object_disparity_field(height, width, max_disparity, rng,
                                   n_objects)
    right = rng.uniform(0.0, 1.0, size=(height, width)).astype(np.float32)
    if smooth > 0:
        k = np.ones(smooth, dtype=np.float32) / smooth
        right = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, right)
        right = np.apply_along_axis(
            lambda c: np.convolve(c, k, mode="same"), 0, right)
    # Textureless rectangles (constant patches in the RIGHT image, so
    # the warp carries them into the left too).
    area = 0.0
    target = textureless_frac * height * width
    while area < target:
        h = int(rng.integers(height // 8, height // 3))
        w = int(rng.integers(width // 8, width // 3))
        y = int(rng.integers(0, max(1, height - h)))
        x = int(rng.integers(0, max(1, width - w)))
        right[y:y + h, x:x + w] = float(rng.uniform(0.2, 0.8))
        area += h * w

    xs = np.arange(width)[None, :]
    src = xs - field
    valid = (src >= 0) & (src < width)
    left = np.take_along_axis(right, np.clip(src, 0, width - 1), axis=1)
    fill = rng.uniform(0.0, 1.0, size=left.shape).astype(np.float32)
    left = np.where(valid, left, fill).astype(np.float32)
    # Photometric asymmetry on the left eye only.
    left = np.clip(gain * left + bias
                   + noise * rng.standard_normal(left.shape), 0.0, 1.0
                   ).astype(np.float32)
    gt = np.where(valid, field, -1).astype(np.int32)
    return left, right, gt, occlusion_mask(field)
