"""Synthetic rectified pairs: a frozen copy of the program's generator.

`block_disparity_field` and `make_pair` are copies of the port's
`data/synthetic.py`; `recipe_pair` is the recipe both public
deployments' bench rows use (the port's `bench.make_pairs`, `block=32`,
and `tools/bench_large.kitti_pair`, `block=48`): a piecewise-constant
field drawn from `default_rng(seed)` warps a random texture of the same
seed.  `to_rgb8` turns a pair into the `uint8` (H, W, 3) arrays that a
PNG decoder hands a user.  numpy only; `tests/test_stereobench_frozen.py`
holds the pairs byte for byte to the program's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def block_disparity_field(height: int, width: int, max_disparity: int,
                          rng: np.random.Generator, block: int = 32,
                          align: int = 4) -> np.ndarray:
    """Piecewise-constant random integer disparity field (H, W), values
    multiples of `align` (the patch size)."""
    bh = (height + block - 1) // block
    bw = (width + block - 1) // block
    n_vals = max(1, (max_disparity - 1) // align)
    vals = rng.integers(0, n_vals + 1, size=(bh, bw)) * align
    vals = np.minimum(vals, max_disparity - 1)
    field = np.repeat(np.repeat(vals, block, axis=0), block, axis=1)
    return field[:height, :width].astype(np.int32)


def make_pair(height: int, width: int, disparity_field: np.ndarray,
              seed: int = 0, smooth: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, gt): right is random texture, left[y, x] =
    right[y, x - d(y, x)]; pixels with no source keep random texture and
    gt = -1."""
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


def recipe_pair(seed: int, height: int, width: int, max_disparity: int,
                block: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The bench recipe's pair of one seed: (left, right, gt), float32
    planes in [0, 1]."""
    rng = np.random.default_rng(seed)
    field = block_disparity_field(height, width, max_disparity, rng,
                                  block=block)
    return make_pair(height, width, field, seed=seed)


def to_rgb8(plane: np.ndarray) -> np.ndarray:
    """A [0, 1] float plane as a decoded 8-bit colour image: (H, W, 3)
    uint8, the plane rounded to 8 bits in every channel."""
    gray = np.rint(np.clip(plane, 0.0, 1.0) * 255.0).astype(np.uint8)
    return np.repeat(gray[:, :, None], 3, axis=2)
