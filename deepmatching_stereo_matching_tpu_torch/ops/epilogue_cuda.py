"""A step's epilogue on the card (csrc/epilogue.cu): the LR check,
densify and the five pixel outputs, EPI, one launch a step.

`pipeline.lr_outputs` launches it for CUDA tensors; for CPU tensors it
runs the plain chain, `pipeline.lr_consistency_patch` then
`pipeline.pixel_outputs`, which the kernel is bitwise.  It replaces no
TPU kernel: the JAX package runs the check and densify in XLA.  What
bounds it: the note at the top of csrc/epilogue.cu, and `work.epilogue`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import _build
from ._dispatch import run_kernel

KERNEL = "lr_outputs_kernel"     # its symbol, in no other kernel's name


def lr_outputs(disp_fwd: torch.Tensor, score: torch.Tensor,
               disp_r: Optional[torch.Tensor], tau: float, patch_size: int,
               min_score: float, invalid_value: float
               ) -> Dict[str, torch.Tensor]:
    """(..., H0, W0) CUDA patch maps (disp_fwd and disp_r int32, score
    float32; disp_r None without the LR check) -> the five (..., H0 p,
    W0 p) outputs of `pipeline.pixel_outputs`, in one launch.  The
    sentinel's width, which the plain chain takes from the number of
    disparities, is no input: every column left of the map reads it.
    A CPU tensor raises: `pipeline.lr_outputs` dispatches."""
    maps = (disp_fwd, score) + (() if disp_r is None else (disp_r,))
    if not run_kernel(*maps):
        raise ValueError("the epilogue kernel takes CUDA tensors; the plain "
                         "chain is pipeline.lr_consistency_patch and "
                         "pipeline.pixel_outputs")
    for name, t, dtype in (("disp_fwd", disp_fwd, torch.int32),
                           ("score", score, torch.float32),
                           ("disp_r", disp_r, torch.int32)):
        if t is not None and t.dtype != dtype:
            raise TypeError(f"the epilogue kernel takes {name} as {dtype}, "
                            f"not {t.dtype}")
    if disp_fwd.ndim < 2 or any(t.shape != disp_fwd.shape for t in maps):
        raise ValueError(f"the epilogue kernel takes (..., H0, W0) patch "
                         f"maps of one shape, not "
                         f"{[tuple(t.shape) for t in maps]}")
    if patch_size < 1:
        raise ValueError(f"patch_size must be >= 1, not {patch_size}")
    p = patch_size
    *lead, h0, w0 = disp_fwd.shape
    disp_fwd, score = disp_fwd.contiguous(), score.contiguous()
    disp_r = None if disp_r is None else disp_r.contiguous()
    shape = (*lead, h0 * p, w0 * p)
    dev = disp_fwd.device
    out = {"disparity": torch.empty(shape, dtype=torch.float32, device=dev),
           "disparity_raw": torch.empty(shape, dtype=torch.int32, device=dev),
           "valid": torch.empty(shape, dtype=torch.bool, device=dev),
           "score": torch.empty(shape, dtype=torch.float32, device=dev),
           "disparity_right": torch.empty(shape, dtype=torch.int32,
                                          device=dev)}
    n = math.prod(lead)
    if n and h0 and w0:
        _build.launch(
            "EPI", "dm_lr_outputs", dev, disp_fwd.data_ptr(),
            score.data_ptr(), None if disp_r is None else disp_r.data_ptr(),
            *(out[k].data_ptr() for k in ("disparity", "disparity_raw",
                                          "valid", "score",
                                          "disparity_right")),
            n, h0, w0, p, tau, int(min_score > 0.0), min_score,
            invalid_value)
    return out
