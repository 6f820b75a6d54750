"""grad_hist's (magnitude, bin) planes on the card (csrc/planes.cu):
PLANES, one launch an image stack.

The planes K1b and K4b take (`descriptors.grad_hist_magbin`): np.gradient
along W and H, the L1 magnitude and the exact-comparison octant as a
float, bitwise the plain version `descriptors.grad_hist_magbin_torch`,
which runs for CPU tensors.  It replaces no TPU kernel: the JAX package
builds the planes in XLA (`models/descriptors.py`,
`magbin_from_gradients`).  What bounds it: the note at the top of
csrc/planes.cu, and `work.magbin_planes`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from ._dispatch import run_kernel

KERNEL = "magbin_planes_kernel"     # its symbol, in no other kernel's name


def magbin_planes(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) float32 CUDA images -> (magnitude, bin) planes, both
    float32 (..., H, W), in one launch.  A CPU tensor raises: its planes
    are the plain version's (`descriptors.grad_hist_magbin` dispatches)."""
    if not run_kernel(img):
        raise ValueError("the planes kernel takes a CUDA tensor; the plain "
                         "version is descriptors.grad_hist_magbin_torch")
    if img.dtype != torch.float32:
        raise TypeError(f"the planes kernel takes float32 images, not "
                        f"{img.dtype}")
    if img.ndim < 2 or min(img.shape[-2:]) < 2:
        raise ValueError(f"the planes kernel takes (..., H, W) images with "
                         f"H, W >= 2, not {tuple(img.shape)}")
    *lead, h, w = img.shape
    src = img.contiguous()
    mag = torch.empty_like(src)
    bins = torch.empty_like(src)
    n = math.prod(lead)
    if n:
        _build.launch("PLANES", "dm_magbin_planes", src.device,
                      src.data_ptr(), mag.data_ptr(), bins.data_ptr(), n, h, w)
    return mag, bins
