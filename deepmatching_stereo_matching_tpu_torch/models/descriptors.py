"""Patch descriptors (C2+C3) in torch.

Counterpart of the JAX package's `models/descriptors.py`, patch mode
only: raw-intensity patches, L2-normalised with the norm clamped at 1e-8,
element order (row, column, feature) as in the oracle.  Leading batch
dimensions are allowed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepmatching_stereo_matching_tpu.config import Config

_EPS = 1e-8


def check_supported(cfg: Config) -> None:
    if cfg.descriptor != "patch":
        raise NotImplementedError(
            f"descriptor={cfg.descriptor!r} is not ported yet: grad_hist "
            "comes with the magbin form of the fused kernel (ROADMAP queue "
            "1, item 9)")
    if cfg.center_descriptors:
        raise NotImplementedError("center_descriptors is not ported yet")


def pixel_features(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., H, W) image -> (..., H, W, F) per-pixel features (F = 1)."""
    check_supported(cfg)
    return img[..., None]


def _normalize(desc: torch.Tensor) -> torch.Tensor:
    norm = (desc * desc).sum(-1, keepdim=True).sqrt()
    return desc / norm.clamp_min(_EPS)


def patch_descriptors(feat: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, W', F) features -> (..., H0, W0, C) patch descriptors."""
    check_supported(cfg)
    p = cfg.patch_size
    *lead, h, w, f = feat.shape
    h0, w0 = h // p, w // p
    blocks = feat[..., : h0 * p, : w0 * p, :].reshape(*lead, h0, p, w0, p, f)
    desc = blocks.transpose(-4, -3).reshape(*lead, h0, w0, p * p * f)
    return _normalize(desc)


def sliding_descriptors(feat: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, W', F) features -> (..., H0, W', C) descriptors at every
    column.

    Entry [i, x] describes the patch with top-left pixel (p*i, x);
    windows overrunning the right edge (x > W' - p) are all-zero.
    """
    check_supported(cfg)
    p = cfg.patch_size
    *lead, h, w, f = feat.shape
    h0 = h // p
    rows = feat[..., : h0 * p, :, :].reshape(*lead, h0, p, w, f)
    # windows[..., i, x0, dr, dc, f] = rows[..., i, dr, x0 + dc, f]
    shifted = [F.pad(rows[..., dc:, :], (0, 0, 0, dc)) for dc in range(p)]
    windows = torch.stack(shifted, dim=-2)        # (..., H0, p, W', p, F)
    desc = windows.transpose(-4, -3).reshape(*lead, h0, w, p * p * f)
    ok = torch.arange(w, device=feat.device) <= w - p
    desc = torch.where(ok[:, None], desc, torch.zeros((), dtype=desc.dtype,
                                                      device=desc.device))
    return _normalize(desc)


def left_descriptors(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, Wp) -> (..., H0, W0, C): non-overlapping patches."""
    return patch_descriptors(pixel_features(img, cfg), cfg)


def right_sliding_descriptors(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, Wp) -> (..., H0, Wp, C): patches at every column offset;
    windows overrunning the right edge are all-zero."""
    return sliding_descriptors(pixel_features(img, cfg), cfg)
