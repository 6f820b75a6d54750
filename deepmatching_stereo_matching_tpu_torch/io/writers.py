"""Disparity writers/readers (C14, SURVEY.md §2.1).

The reference saves colormapped disparity images with matplotlib/cv2
([K-high], SURVEY.md §1 L6).  This module writes the standard stereo
interchange formats on the host:

  * 16-bit PNG, KITTI convention (disparity * 256, 0 = invalid),
  * PFM, Middlebury convention (float32, +inf/nan = invalid),
  * colormapped 8-bit PNG for visual inspection (turbo-like ramp,
    matplotlib-free), plus a validity-mask PNG.
"""

from __future__ import annotations

import struct

import numpy as np


def _to_png(path: str, arr: np.ndarray) -> None:
    """Write uint8 (H,W) / (H,W,3) or uint16 (H,W) as PNG.

    Prefers the native C++ encoder (zlib deflate; PIL-decodable, CRCs
    verified in tests/test_native.py), falling back to PIL.
    """
    from .. import native

    if native.available():
        native.write_png(path, arr)
        return
    from PIL import Image

    Image.fromarray(arr).save(path)


def write_disparity_png16(path: str, disparity: np.ndarray) -> None:
    """KITTI-style 16-bit PNG: value = round(d * 256); 0 marks invalid."""
    d = np.asarray(disparity, dtype=np.float32)
    valid = np.isfinite(d) & (d >= 0)
    enc = np.where(valid, np.round(d * 256.0), 0.0)
    _to_png(path, np.clip(enc, 0, 65535).astype(np.uint16))


def read_disparity_png16(path: str) -> np.ndarray:
    """Read a KITTI-style 16-bit disparity PNG -> float32 (nan=invalid).

    Decodes through the native C++ PNG reader when available (PIL-free
    dataset evaluation, VERDICT r3 item 6), else PIL.
    """
    from .. import native

    enc = None
    if native.available():
        try:
            arr, _maxval = native.read_png(path)
            enc = np.asarray(arr, dtype=np.float32)
        except IOError:
            pass  # palette/interlaced PNG: fall through to PIL
    if enc is None:
        from PIL import Image

        with Image.open(path) as im:
            enc = np.asarray(im, dtype=np.float32)
    out = enc / 256.0
    out[enc == 0] = np.nan
    return out


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    """Middlebury PFM (grayscale float32, bottom-up row order)."""
    d = np.asarray(data, dtype=np.float32)
    if d.ndim != 2:
        raise ValueError("write_pfm expects a (H, W) array")
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{d.shape[1]} {d.shape[0]}\n".encode())
        # negative scale = little-endian, per the PFM spec
        f.write(f"{-abs(scale)}\n".encode())
        f.write(d[::-1].astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a grayscale PFM -> float32 (H, W), top-down row order."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"Pf":
            raise ValueError(f"{path} is not a grayscale PFM")
        w, h = (int(t) for t in f.readline().split())
        scale = float(f.readline())
        fmt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(), dtype=fmt, count=w * h)
    return data.reshape(h, w)[::-1].astype(np.float32)


# Compact turbo-like colormap: anchor RGB points, linearly interpolated.
_RAMP = np.array([
    [48, 18, 59], [70, 107, 227], [40, 178, 251], [27, 229, 181],
    [123, 253, 86], [219, 226, 24], [252, 156, 4], [225, 62, 2],
    [122, 4, 3],
], dtype=np.float32)


def colorize(disparity: np.ndarray, vmax: float = 0.0,
             invalid_color=(0, 0, 0)) -> np.ndarray:
    """Disparity -> uint8 RGB (H, W, 3); invalid pixels get invalid_color."""
    d = np.asarray(disparity, dtype=np.float32)
    valid = np.isfinite(d)
    if vmax <= 0:
        vmax = float(np.nanmax(d)) if valid.any() else 1.0
        vmax = max(vmax, 1e-6)
    t = np.clip(np.where(valid, d, 0.0) / vmax, 0.0, 1.0)
    x = t * (len(_RAMP) - 1)
    i0 = np.clip(np.floor(x).astype(np.int32), 0, len(_RAMP) - 2)
    frac = (x - i0)[..., None]
    rgb = _RAMP[i0] * (1.0 - frac) + _RAMP[i0 + 1] * frac
    rgb = np.where(valid[..., None], rgb,
                   np.asarray(invalid_color, dtype=np.float32))
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def write_disparity_color(path: str, disparity: np.ndarray,
                          vmax: float = 0.0) -> None:
    """Colormapped 8-bit PNG of a disparity map (black = invalid)."""
    _to_png(path, colorize(disparity, vmax))


def write_valid_mask(path: str, valid: np.ndarray) -> None:
    """8-bit PNG of the validity mask (255 = valid)."""
    _to_png(path, (np.asarray(valid, dtype=bool) * 255).astype(np.uint8))
