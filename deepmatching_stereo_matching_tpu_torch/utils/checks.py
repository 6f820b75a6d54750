"""Host-side input validation (copy of the JAX package's
`utils/checks.py:validate_images`, whose module imports JAX for its
checkify sanitizer)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def validate_images(left: np.ndarray, right: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Raise ValueError with a precise message on malformed inputs."""
    left = np.asarray(left)
    right = np.asarray(right)
    for name, img in (("left", left), ("right", right)):
        if img.ndim not in (2, 3):
            raise ValueError(
                f"{name} image must be (H, W) or (H, W, C), got shape "
                f"{img.shape}")
        if img.ndim == 3 and img.shape[2] not in (3, 4):
            raise ValueError(
                f"{name} image has {img.shape[2]} channels; expected "
                f"grayscale, RGB, or RGBA")
        if img.size == 0:
            raise ValueError(f"{name} image is empty: shape {img.shape}")
        if np.issubdtype(img.dtype, np.floating) \
                and not np.isfinite(img).all():
            raise ValueError(f"{name} image contains NaN/inf values")
    if left.shape != right.shape:
        raise ValueError(
            f"left/right shapes differ: {left.shape} vs {right.shape}")
    return left, right
