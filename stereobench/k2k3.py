"""K2 and K3, the port's exact route on descriptors (the cost-volume
kernel on torch-built descriptors, then the pyramid and the walk in one
kernel), as the benchmark reads them: their work, frozen here as
`work.py` freezes the step's, and their device time in a traced window.

`k2` and `k3` are copies of the port's `work.k2` and `work.k3`.  K2: the
(H0, W0, C) source and (H0, Wp, C) target descriptors of an instance read
once and the D-major (D0, H0, W0) volume written once, all in the
configuration's dtype; the correlation's 2 C operations a bin below
max_disparity.  K3: the volume read once and the (H0, W0) int32 disparity
and float32 score maps written once; per cell of each level above 0 the
3-pool (2), the 4-child mean (4) and the power (1), then the walk down.
`tests/test_torch_zncc.py` holds both equal to the program's.  The
kernels are found in the trace by their symbols, `costvol_kernel` and
`pyramid_kernel`, which no other kernel's name contains, through
`k4k5.seconds_per_step`.
"""

from __future__ import annotations

from .k4k5 import ELEMENT_BYTES, _volume
from .reference import Config, Geometry
from .work import Work, aggregation_ops, correlation_ops, descriptor_width, \
    walk_ops

K2 = "costvol_kernel"
K3 = "pyramid_kernel"
MAP_BYTES = 8      # a cell's disparity (int32) and score (float32)


def k2(cfg: Config, geom: Geometry, n: int) -> Work:
    """K2 on n instances (one direction of one pair each)."""
    e, c = ELEMENT_BYTES[cfg.dtype], descriptor_width(cfg)
    return Work({"src": n * geom.grid_h * geom.grid_w * c * e,
                 "tgt": n * geom.grid_h * geom.padded_width * c * e,
                 "vol": _volume(cfg, geom, n)},
                correlation_ops(cfg, geom, n))


def k3(cfg: Config, geom: Geometry, n: int) -> Work:
    """K3 on n instances: the volume in, the two maps out."""
    return Work({"vol": _volume(cfg, geom, n),
                 "out": n * geom.grid_h * geom.grid_w * MAP_BYTES},
                {**aggregation_ops(geom, n), **walk_ops(geom, n)})
