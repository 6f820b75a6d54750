"""Image loading (C1, SURVEY.md §2.1): rectified pair -> numpy arrays.

The reference loads with cv2/PIL on the host ([K-high], SURVEY.md §1
L0); here PIL is used with a numpy-only PGM/PPM fallback so the loader
works in minimal environments.  Device upload happens later via
`jax.device_put` in the api / parallel layers — the host/device boundary
of SURVEY.md §3.1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load an image file as a numpy array (u8/u16 HxW or HxWx3).

    PNM and PNG files decode through the native C++ codec when it is
    available (deepmatching_stereo_matching_tpu_torch/native — PNM
    bit-identical to the Python reader, PNG parity-tested against PIL
    in tests/test_native.py), making the Middlebury/KITTI dataset
    formats PIL-free; everything else goes through PIL.
    """
    lower = path.lower()
    if lower.endswith((".pgm", ".ppm", ".pnm", ".png")):
        from .. import native

        if native.available():
            try:
                arr, _maxval = native.read_image(path)
                return arr
            except IOError:
                pass  # e.g. palette/interlaced PNG: fall through to PIL
    try:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode not in ("L", "RGB", "I;16"):
                im = im.convert("RGB")
            return np.asarray(im)
    except ImportError:
        return _load_pnm(path)


def _load_pnm(path: str) -> np.ndarray:
    """Minimal binary PGM (P5) / PPM (P6) reader."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P5", b"P6"):
            raise ValueError(f"unsupported image format in {path}")
        vals = []
        while len(vals) < 3:
            line = f.readline()
            if line.startswith(b"#"):
                continue
            vals.extend(int(t) for t in line.split())
        w, h, maxval = vals[:3]
        channels = 3 if magic == b"P6" else 1
        # 16-bit PNM samples are big-endian on disk.
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        data = np.frombuffer(f.read(), dtype=dtype, count=w * h * channels)
        data = data.astype(np.uint16 if maxval > 255 else np.uint8,
                           copy=False)
    img = data.reshape((h, w, channels) if channels == 3 else (h, w))
    return img


def load_pair(left_path: str, right_path: str
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a rectified pair; validates equal shapes."""
    left = load_image(left_path)
    right = load_image(right_path)
    if left.shape != right.shape:
        raise ValueError(
            f"left/right shapes differ: {left.shape} vs {right.shape}")
    return left, right
