"""Grayscale, normalise and zero-pad a batch of raw uint8 images on the
card (csrc/prep.cu), and its plain version.

The stream's input preparation (`parallel/sharded.pad_batch` with a
device): `oracle.to_grayscale_f32` and `oracle.pad_image` on every image,
bitwise, from the raw pixels a decoder hands the user.  It replaces no TPU
kernel (the JAX package does this on the host); it moves the stream's
padding off the host and copies the uint8 pixels in, not float32 planes.
Two launches a call, with no read-back: a pass that decides which images
are lit (largest grayscale value above 1.5, so divided by 255), then the
write.  What bounds it: see the note at the top of csrc/prep.cu.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._dispatch import run_kernel

# BT.601 weights, as float32 (oracle.to_grayscale_f32's np.float32).
WEIGHTS = (0.299, 0.587, 0.114)
CHANNELS = (3, 4)          # of a colour image; channels 0-2 are read
LAUNCHES = 2               # a call on the card: the lit pass, the write
MAX_SLICES = 128           # csrc/prep.cu: kPadThreads, a flag a thread
SLICE_PIXELS = 2048        # a lit-pass block's share of an image, at least
MAX_GRID = 65535           # gridDim.y and .z: padded rows, images


def check_raw(images: torch.Tensor, hp: int, wp: int) -> Tuple[int, int, int]:
    """(H, W, C) of a (B, H, W) or (B, H, W, 3|4) uint8 batch padded to
    (hp, wp); C is 1 for (B, H, W).  Raises on anything else."""
    if images.dtype != torch.uint8:
        raise TypeError(f"gray_pad takes uint8 images, not {images.dtype}")
    if images.ndim == 3:
        _, h, w = images.shape
        c = 1
    elif images.ndim == 4 and images.shape[-1] in CHANNELS:
        _, h, w, c = images.shape
    else:
        raise ValueError(f"gray_pad takes (B, H, W) or (B, H, W, 3|4) "
                         f"images, not {tuple(images.shape)}")
    if hp < h or wp < w:
        raise ValueError(f"padded extents ({hp}, {wp}) below the images' "
                         f"({h}, {w})")
    return h, w, c


def gray_pad_torch(images: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Plain version: (B, H, W[, C]) uint8 -> (B, hp, wp) float32."""
    h, w, _ = check_raw(images, hp, wp)
    if images.ndim == 4:
        rgb = images[..., :3].to(torch.float32)
        wr, wg, wb = (torch.tensor(v, dtype=torch.float32) for v in WEIGHTS)
        g = wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]
    else:
        g = images.to(torch.float32)
    lit = (g > 1.5).flatten(1).any(1)
    g = torch.where(lit[:, None, None],
                    g / torch.tensor(255.0, dtype=torch.float32), g)
    out = torch.zeros((images.shape[0], hp, wp), dtype=torch.float32,
                      device=images.device)
    out[:, :h, :w] = g
    return out


def slices(npix: int) -> int:
    """Blocks of the lit pass an image: one per SLICE_PIXELS, 1 to
    MAX_SLICES."""
    return max(1, min(MAX_SLICES, -(-npix // SLICE_PIXELS)))


def gray_pad(images: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 3|4) uint8 -> (B, hp, wp) float32 grayscale
    in [0, 1] (or undivided where an image's largest value is at most
    1.5), zero-padded: the kernel for a CUDA tensor, the plain version
    for a CPU one."""
    h, w, c = check_raw(images, hp, wp)
    if not run_kernel(images):
        return gray_pad_torch(images, hp, wp)
    n = images.shape[0]
    if n > MAX_GRID or hp > MAX_GRID:
        raise ValueError(f"gray_pad kernel: {n} images of {hp} padded rows; "
                         f"at most {MAX_GRID} of each")
    src = images.contiguous()
    out = torch.empty((n, hp, wp), dtype=torch.float32, device=src.device)
    if n:
        nb = slices(h * w)
        flags = torch.empty(n * nb, dtype=torch.int32, device=src.device)
        _build.launch("PREP", "dm_gray_pad", src.device, src.data_ptr(),
                      flags.data_ptr(), out.data_ptr(), n, h, w, c, hp, wp, nb,
                      count=LAUNCHES)
    return out
