"""Patch and grad_hist descriptors (C2+C3) in torch.

Counterpart of the JAX package's `models/descriptors.py`: raw-intensity
'patch' descriptors and the dense-SIFT-like 'grad_hist' descriptors,
L2-normalised with the norm clamped at 1e-8, element order (row, column,
feature) as in the oracle, centred on the patch mean first where
`cfg.center_descriptors` asks for it.  Leading batch dimensions are
allowed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops import planes_cuda
from ..ops._dispatch import run_kernel

_EPS = 1e-8
_BINS = 8


def _gradient_1d(img: torch.Tensor, dim: int) -> torch.Tensor:
    """np.gradient along `dim`: central differences, one-sided at the
    edges; bitwise equal to NumPy's (x * 0.5 == x / 2.0 in f32)."""
    n = img.shape[dim]
    first = img.narrow(dim, 1, 1) - img.narrow(dim, 0, 1)
    interior = (img.narrow(dim, 2, n - 2) - img.narrow(dim, 0, n - 2)) * 0.5
    last = img.narrow(dim, n - 1, 1) - img.narrow(dim, n - 2, 1)
    return torch.cat([first, interior, last], dim)


def magbin_from_gradients(gx: torch.Tensor, gy: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) -> (L1 magnitude, int64 octant index), elementwise.

    The one definition of the binning: exact comparisons only, no atan2
    and no sqrt, as `oracle/reference.py:_grad_hist_pixels`.  Both the
    one-hot form (`hist_from_gradients`) and the fused kernel's magbin
    planes (`grad_hist_magbin`) derive from it.
    """
    ax, ay = gx.abs(), gy.abs()
    mag = ax + ay
    idx_up = torch.where(gx > 0, torch.where(ay >= ax, 5, 4),
                         torch.where(ay > ax, 6, 7))
    idx_dn = torch.where(gx >= 0, torch.where(ay > ax, 2, 3),
                         torch.where(ay >= ax, 1, 0))
    return mag, torch.where(gy >= 0, idx_up, idx_dn)


def hist_from_gradients(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """(gx, gy) -> magnitude-weighted orientation histogram (..., 8)."""
    mag, idx = magbin_from_gradients(gx, gy)
    return F.one_hot(idx, _BINS).to(mag.dtype) * mag[..., None]


def _gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _gradient_1d(img, -1), _gradient_1d(img, -2)


def grad_hist_pixels(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) image -> (..., H, W, 8) per-pixel histogram."""
    return hist_from_gradients(*_gradients(img))


def grad_hist_magbin_torch(img: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `grad_hist_magbin`, in torch operations."""
    mag, idx = magbin_from_gradients(*_gradients(img))
    return mag, idx.to(mag.dtype)


def grad_hist_magbin(img: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) image -> (magnitude, bin) planes, both f32 (bins 0..7).

    The one-hot histogram has one nonzero bin per pixel, so it factors
    losslessly into these two planes, and the descriptor dot becomes
    mag_L * mag_R * [bin_L == bin_R]: the fused kernel's magbin form.
    A CUDA tensor takes the planes kernel (`planes_cuda.magbin_planes`,
    one launch), a CPU one the plain version; both give the same bits.
    """
    if run_kernel(img):
        return planes_cuda.magbin_planes(img)
    return grad_hist_magbin_torch(img)


def pixel_features(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., H, W) image -> (..., H, W, F) per-pixel features (F = 1 for
    patch, 8 for grad_hist)."""
    if cfg.descriptor == "patch":
        return img[..., None]
    return grad_hist_pixels(img)


_PAIRWISE_BLOCK = 128


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in NumPy's pairwise order (`np.sum` of a
    float32 row), with keepdim: bitwise the oracle's sums.

    Below 8 elements they add in order; up to 128, eight accumulators (one
    per position in each block of eight) combine as ((r0 + r1) + (r2 +
    r3)) + ((r4 + r5) + (r6 + r7)), then the tail adds in order; above
    128 the row splits at n2 = n // 2 - (n // 2) % 8 and the halves' sums
    add.  Only elementwise adds of slices, which round the same way on the
    CPU and on the card.
    """
    n = x.shape[-1]
    if n < 8:
        acc = x[..., :1]
        for k in range(1, n):
            acc = acc + x[..., k:k + 1]
        return acc
    if n <= _PAIRWISE_BLOCK:
        n8 = n - n % 8
        blocks = x[..., :n8].unflatten(-1, (n8 // 8, 8))
        r = blocks[..., 0, :]
        for b in range(1, n8 // 8):
            r = r + blocks[..., b, :]
        while r.shape[-1] > 1:                     # 8 -> 4 -> 2 -> 1
            r = r[..., 0::2] + r[..., 1::2]
        for k in range(n8, n):
            r = r + x[..., k:k + 1]
        return r
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(x[..., :n2]) + pairwise_sum(x[..., n2:])


def _normalize(desc: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Subtract the patch mean (`center_descriptors`), then L2-normalise;
    both sums in the oracle's order (`pairwise_sum`), so that a flat
    window centres to exact zeros as it does there."""
    if cfg.center_descriptors:
        desc = desc - pairwise_sum(desc) / desc.shape[-1]
    norm = pairwise_sum(desc * desc).sqrt()
    return desc / norm.clamp_min(_EPS)


def patch_descriptors(feat: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, W', F) features -> (..., H0, W0, C) patch descriptors."""
    p = cfg.patch_size
    *lead, h, w, f = feat.shape
    h0, w0 = h // p, w // p
    blocks = feat[..., : h0 * p, : w0 * p, :].reshape(*lead, h0, p, w0, p, f)
    desc = blocks.transpose(-4, -3).reshape(*lead, h0, w0, p * p * f)
    return _normalize(desc, cfg)


def sliding_descriptors(feat: torch.Tensor, cfg: Config, col0: int = 0,
                        width_global: Optional[int] = None) -> torch.Tensor:
    """(..., Hp, W', F) features -> (..., H0, W', C) descriptors at every
    column.

    Entry [i, x] describes the patch with top-left pixel (p*i, col0 + x)
    in global coordinates; windows whose global start lies outside
    [0, width_global - p] are all-zero.  With col0 = 0 and width_global =
    W' (the defaults) that is the unsharded rule: windows overrunning the
    right edge are zero.  A W-tile passes its halo-extended slab with
    col0 = tile start - halo (parallel/wtiled.py), so that out-of-image
    halo columns correlate to 0, as out-of-range targets do unsharded.
    """
    p = cfg.patch_size
    *lead, h, w, f = feat.shape
    if width_global is None:
        width_global = w
    h0 = h // p
    rows = feat[..., : h0 * p, :, :].reshape(*lead, h0, p, w, f)
    # windows[..., i, x0, dr, dc, f] = rows[..., i, dr, x0 + dc, f]
    shifted = [F.pad(rows[..., dc:, :], (0, 0, 0, dc)) for dc in range(p)]
    windows = torch.stack(shifted, dim=-2)        # (..., H0, p, W', p, F)
    desc = windows.transpose(-4, -3).reshape(*lead, h0, w, p * p * f)
    xg = col0 + torch.arange(w, device=feat.device)
    ok = (xg >= 0) & (xg <= width_global - p)
    desc = torch.where(ok[:, None], desc, torch.zeros((), dtype=desc.dtype,
                                                      device=desc.device))
    return _normalize(desc, cfg)


def left_descriptors(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, Wp) -> (..., H0, W0, C): non-overlapping patches."""
    return patch_descriptors(pixel_features(img, cfg), cfg)


def right_sliding_descriptors(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., Hp, Wp) -> (..., H0, Wp, C): patches at every column offset;
    windows overrunning the right edge are all-zero."""
    return sliding_descriptors(pixel_features(img, cfg), cfg)
