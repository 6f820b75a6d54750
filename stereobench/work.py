"""The yardstick of the kernels' roofline: a frozen copy of the step's
work model and of the card's peaks.

A copy of the port's `work.py` as far as `step_fused` needs it (the
probe model is left out), kept here so that no later change to the
program can move the yardstick.  Pure functions of the reference's
`Config` and `Geometry`: bytes count each input read once and each output
written once; operations count the correlation (2 C a bin below
max_disparity), per cell of each level above 0 the 3-pool (2), the
4-child mean (4) and the power (1), and the walk down.
`tests/test_stereobench_frozen.py` holds `bound(step_fused(...))` to the
program's at both deployments' geometries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .reference import Config, Geometry

# The card's peaks, from the NVIDIA H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32 = 67e12               # float32 outside the tensor cores, FMA = 2
# The five padded maps `pipeline.match_padded_core` writes, bytes a pixel.
STEP_OUTPUT_BYTES = {"disparity": 4, "disparity_raw": 4, "valid": 1,
                     "score": 4, "disparity_right": 4}


@dataclasses.dataclass(frozen=True)
class Work:
    """Itemised work of one call: byte terms and operation terms."""

    bytes: Dict[str, float]
    ops: Dict[str, float]
    peak: float = PEAK_F32

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    @property
    def total_ops(self) -> float:
        return sum(self.ops.values())


def bound(work: Work) -> Tuple[float, str]:
    """(seconds, 'bytes' | 'operations'): the least time the card could
    take, the larger of the bytes over the memory rate and the
    operations over the peak."""
    t_bytes = work.total_bytes / HBM_BYTES_PER_S
    t_ops = work.total_ops / work.peak
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def descriptor_width(cfg: Config) -> int:
    return cfg.patch_size ** 2 * (8 if cfg.descriptor == "grad_hist" else 1)


def _bins(cfg: Config, geom: Geometry, n: int) -> int:
    return min(cfg.max_disparity, geom.disparities) * geom.grid_h \
        * geom.grid_w * n


def correlation_ops(cfg: Config, geom: Geometry, n: int) -> Dict[str, int]:
    return {"corr": 2 * descriptor_width(cfg) * _bins(cfg, geom, n)}


def magbin_ops(cfg: Config, geom: Geometry, n: int) -> Dict[str, int]:
    terms = cfg.patch_size ** 2 * _bins(cfg, geom, n)
    return {"corr": 2 * terms, "bin_eq": terms}


def aggregation_ops(geom: Geometry, n: int) -> Dict[str, int]:
    cells = sum(n * (geom.disparities >> lvl) * (geom.grid_h >> lvl)
                * (geom.grid_w >> lvl) for lvl in range(1, geom.levels + 1))
    return {"pool": 2 * cells, "mean": 4 * cells, "pow": cells}


def walk_ops(geom: Geometry, n: int) -> Dict[str, int]:
    top = geom.levels
    return {"argmax": n * (geom.grid_h >> top) * (geom.grid_w >> top)
            * ((geom.disparities >> top) - 1),
            "walk": sum(2 * n * (geom.grid_h >> lvl) * (geom.grid_w >> lvl)
                        for lvl in range(top))}


def _planes(geom: Geometry, n: int) -> int:
    return 2 * n * geom.padded_height * geom.padded_width * 4


def k1_ops(cfg: Config, geom: Geometry, n: int) -> Dict[str, int]:
    """K1's operations on n instances (one direction of one pair each)."""
    corr = (magbin_ops(cfg, geom, n) if cfg.descriptor == "grad_hist"
            else correlation_ops(cfg, geom, n))
    return {**corr, **aggregation_ops(geom, n), **walk_ops(geom, n)}


def step_fused(cfg: Config, geom: Geometry, batch: int) -> Work:
    """The step's function (`match_padded_core`, LR flip): two padded
    float32 planes a pair in, the five padded maps a pair out, the
    operations of both directions."""
    px = batch * geom.padded_height * geom.padded_width
    return Work({"imgs": _planes(geom, batch),
                 **{k: px * b for k, b in STEP_OUTPUT_BYTES.items()}},
                k1_ops(cfg, geom, 2 * batch))
