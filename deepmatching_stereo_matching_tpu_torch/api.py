"""Public API: dense stereo matching on a torch device.

Counterpart of the JAX package's `api.py`.  Host work is image
normalisation and padding on the way in (the oracle's own functions) and
the copy back on the way out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .config import Config
from .oracle import reference as _oracle

from .models import pipeline
from .ops._dispatch import route as current_route
from .utils import checks
from .utils.logging import span


@dataclasses.dataclass
class MatchResult:
    """Host-side result of one stereo match (same fields as the oracle)."""

    disparity: np.ndarray        # float32 (H, W); invalid = cfg.invalid_value
    disparity_raw: np.ndarray    # int32 (H, W) unfiltered L->R disparities
    valid: np.ndarray            # bool (H, W)
    score: np.ndarray            # float32 (H, W) level-0 correlation
    disparity_right: Optional[np.ndarray]  # int32 (H, W), None w/o lr_check


def preprocess(image: np.ndarray, cfg: Config, height: int, width: int
               ) -> np.ndarray:
    """Grayscale-normalise and zero-pad one image to pipeline geometry."""
    gray = _oracle.to_grayscale_f32(image)
    geom = cfg.geometry(height, width)
    return _oracle.pad_image(gray, geom)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA device on a host without one raises
    instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def match_stereo(left, right, cfg: Config = Config(),
                 impl: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda",
                 debug_checks: bool = False) -> MatchResult:
    """Dense disparity for a rectified pair, computed on `device`.

    Accepts uint8/float, grayscale or RGB arrays of equal shape.  `impl`
    overrides the current route ('fused' | 'exact' | 'torch',
    ops/_dispatch.py) for this call.  `debug_checks` checks the
    pipeline's invariants on the device (finite inputs and scores,
    in-range disparity bins, NaN iff invalid; utils/checks.py) on the
    same route, and raises `checks.InvariantError` if one fails.
    """
    with span("api.match_stereo"):
        dev = resolve_device(device)
        left, right = checks.validate_images(left, right)
        h, w = left.shape[:2]
        planes = []
        for image in (left, right):
            with span("api.preprocess"):
                plane = preprocess(image, cfg, h, w)
            with span("api.copy_in"):
                planes.append(torch.from_numpy(plane).to(dev))
        lp, rp = planes
        route = impl or current_route()
        with span("api.match"):
            if debug_checks:
                out = checks.checked_match_padded(lp, rp, cfg, h, w, route)
            else:
                out = pipeline.match_padded(lp, rp, cfg, h, w, route)
        with span("api.wait"):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        with span("api.copy_out"):
            host = {k: v.cpu().numpy() for k, v in out.items()}
        return MatchResult(
            disparity=host["disparity"],
            disparity_raw=host["disparity_raw"].astype(np.int32),
            valid=host["valid"],
            score=host["score"],
            disparity_right=(host["disparity_right"].astype(np.int32)
                             if cfg.lr_check else None),
        )
