"""Quality and throughput metrics (SURVEY.md §6, C16).

The baseline's metrics (BASELINE.json:2) are the bad-pixel rate at
delta <= 1 px on ground-truth disparity, and cost-volume megapixels per
second per chip.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np


def bad_pixel_rate(pred: np.ndarray, gt: np.ndarray, delta: float = 1.0,
                   gt_invalid: float = -1.0,
                   count_invalid: bool = True) -> float:
    """Fraction of GT-valid pixels with |pred - gt| > delta.

    With count_invalid=True (standard Middlebury "all" protocol), invalid
    predictions (NaN sentinel) over valid GT count as bad.  With
    count_invalid=False, only pixels where BOTH prediction and GT are
    valid are scored — measures accuracy of what the filter kept.
    """
    gt = np.asarray(gt, dtype=np.float32)
    pred = np.asarray(pred, dtype=np.float32)
    # Invalid GT is either the sentinel value or non-finite (the NaN /
    # inf conventions of KITTI png16 and Middlebury PFM readers).
    mask = (gt != gt_invalid) & np.isfinite(gt)
    if not count_invalid:
        mask &= np.isfinite(pred)
    if not mask.any():
        return 0.0
    err = np.abs(pred - gt)
    bad = (~np.isfinite(pred)) | (err > delta)
    return float(np.mean(bad[mask]))


def coverage(pred: np.ndarray) -> float:
    """Fraction of pixels with a finite (non-invalidated) prediction."""
    return float(np.mean(np.isfinite(np.asarray(pred, dtype=np.float32))))


def end_point_error(pred: np.ndarray, gt: np.ndarray,
                    gt_invalid: float = -1.0) -> float:
    """Mean |pred - gt| over pixels where both are valid."""
    gt = np.asarray(gt, dtype=np.float32)
    pred = np.asarray(pred, dtype=np.float32)
    mask = (gt != gt_invalid) & np.isfinite(gt) & np.isfinite(pred)
    if not mask.any():
        return float("inf")
    return float(np.mean(np.abs(pred - gt)[mask]))


def measure_mpix_per_s(fn: Callable[[], object], pixels: int,
                       warmup: int = 1, iters: int = 3,
                       min_time_s: float = 0.0) -> Dict[str, float]:
    """Throughput of `fn` in input megapixels per second.

    `fn` must block until completion (synchronise inside).
    `pixels` is H*W of ONE image of the pair, per the baseline's metric
    definition (BASELINE.json:2 "cost-volume Mpx/s").
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if sum(times) > min_time_s and len(times) >= iters:
            break
    best = min(times)
    return {
        "mpix_per_s": pixels / best / 1e6,
        "seconds": best,
        "pixels": float(pixels),
    }
