"""Disparity post-filtering (C13): median + occlusion fill, in torch.

Counterpart of the JAX package's `ops/postfilter.py` and bit-for-bit the
oracle's (`oracle/reference.py:postfilter`); leading batch dimensions are
allowed.  These are selections and comparisons only, so every backend
gives the same bits.

  * median: k*k window with edge-clamped borders; invalid (non-finite)
    pixels are excluded; the LOWER median of the n valid values (sorted
    index (n-1)//2).  A pixel with an all-invalid window, or an invalid
    centre when fill is off, stays invalid.
  * fill: each remaining invalid pixel takes min(nearest valid left,
    nearest valid right) on its row.

Runs on the final cropped map, after the sharded strategies have
gathered it: a k*k window crosses tile boundaries.
"""

from __future__ import annotations

import torch


def _window_stack(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, k*k) edge-clamped k*k neighbourhoods."""
    *lead, h, w = x.shape
    r = k // 2
    offs = torch.arange(-r, r + 1, device=x.device)
    rows = (torch.arange(h, device=x.device)[:, None] + offs).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device)[:, None] + offs).clamp(0, w - 1)
    g = x[..., rows, :]                                 # (..., H, k, W)
    g = g[..., cols]                                    # (..., H, k, W, k)
    return g.transpose(-3, -2).reshape(*lead, h, w, k * k)


def median_valid(disp: torch.Tensor, k: int, keep_invalid_center: bool
                 ) -> torch.Tensor:
    """Lower median of the valid values in each k*k window."""
    win = _window_stack(disp, k)
    finite = win.isfinite()
    n = finite.sum(-1)
    inf = torch.full((), float("inf"), dtype=disp.dtype, device=disp.device)
    vals = torch.where(finite, win, inf).sort(-1).values
    idx = ((n - 1).clamp_min(0) // 2)[..., None]
    med = vals.gather(-1, idx)[..., 0]
    out = torch.where(n > 0, med, disp)
    if keep_invalid_center:
        out = torch.where(disp.isfinite(), out, disp)
    return out


def fill_background(disp: torch.Tensor) -> torch.Tensor:
    """Fill invalid pixels with min(nearest valid left, right) per row."""
    w = disp.shape[-1]
    valid = disp.isfinite()
    iota = torch.arange(w, device=disp.device).expand_as(disp)
    none = torch.full((), -1, dtype=iota.dtype, device=disp.device)
    left_idx = torch.where(valid, iota, none).cummax(-1).values
    right_idx = w - 1 - torch.where(valid, w - 1 - iota, none).flip(
        -1).cummax(-1).values.flip(-1)
    inf = torch.full((), float("inf"), dtype=disp.dtype, device=disp.device)
    safe = torch.where(valid, disp, inf)
    left_val = torch.where(left_idx >= 0,
                           safe.gather(-1, left_idx.clamp_min(0)), inf)
    right_val = torch.where(right_idx <= w - 1,
                            safe.gather(-1, right_idx.clamp_max(w - 1)), inf)
    filled = torch.where(valid, disp, torch.minimum(left_val, right_val))
    return torch.where(filled.isfinite(), filled, disp)


def postfilter(disp: torch.Tensor, median: int, fill: bool) -> torch.Tensor:
    """The configured post-filter chain on (..., H, W) float maps."""
    out = disp
    if median:
        out = median_valid(out, median, keep_invalid_center=not fill)
    if fill:
        out = fill_background(out)
    return out
