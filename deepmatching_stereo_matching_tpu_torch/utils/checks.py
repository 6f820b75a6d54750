"""Input validation and runtime invariant guards.

Counterpart of the JAX package's `utils/checks.py`:

  * `validate_images` — host-side input validation (shape, dtype,
    finiteness) with precise error messages, used by the API boundary.
  * `checked_match_padded` — the pipeline with its core invariants
    checked on the device: finite inputs and scores, disparity bins
    inside [0, D), validity consistent with the NaN sentinel.  JAX wraps
    its `jnp` path in checkify, which cannot see inside Pallas kernels;
    here the invariants are plain tensor reductions on the outputs, so
    the kernel routes ('fused', 'exact') are checked as well as 'torch'.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config


class InvariantError(RuntimeError):
    """One or more pipeline invariants failed; the message names each."""


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


def checked_match_padded(left_p: torch.Tensor, right_p: torch.Tensor,
                         cfg: Config, height: int, width: int,
                         route: str = "fused") -> Dict[str, torch.Tensor]:
    """`pipeline.match_padded` with its invariants checked on the device.

    The four checks are reduced to one boolean tensor on the device and
    read back with a single synchronisation; raises `InvariantError`
    naming every invariant that failed.  The post-filter runs after the
    checks (`fill_invalid` rewrites the NaN sentinel), so the checked path
    is the normal pipeline plus checks.
    """
    from ..models import pipeline

    geom = cfg.geometry(height, width)
    checks = [(torch.isfinite(left_p).all() & torch.isfinite(right_p).all(),
               "non-finite values in padded input images")]
    out = pipeline.match_padded_core(left_p, right_p, cfg, geom, route)
    raw = out["disparity_raw"]
    checks += [
        (torch.isfinite(out["score"]).all(), "non-finite correlation scores"),
        (((raw >= 0) & (raw < geom.disparities)).all(),
         "disparity bin out of range [0, D)"),
    ]
    if np.isnan(cfg.invalid_value):
        checks.append(((torch.isnan(out["disparity"]) == ~out["valid"]).all(),
                       "NaN sentinel inconsistent with validity mask"))
    ok = torch.stack([c for c, _ in checks]).cpu()
    failed = [msg for (_, msg), good in zip(checks, ok.tolist()) if not good]
    if failed:
        raise InvariantError("; ".join(failed))
    return pipeline.apply_postfilter(pipeline.crop(out, height, width), cfg)
