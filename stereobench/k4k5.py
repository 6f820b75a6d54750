"""K4 and K5, the port's large-D route on patch planes (the cost-volume
kernel, then the level aggregation), as the benchmark reads them: their
work, frozen here as `work.py` freezes the step's, and their device time
in a traced window.

`k4` and `k5` are copies of the port's `work.k4` and `work.k5`.  K4:
the two float32 padded planes of an instance read once and the D-major
volume written once; the correlation's 2 C operations a bin below
max_disparity.  K5: the volume read once, the top map (D0, H0, W0 >> L)
and every level's int8 pool offsets written once; per cell of each level
above 0 the 3-pool (2), the 4-child mean (4) and the power (1).  K5's
second pass past five levels reads the level-5 map the first wrote: that
read is the function's work no more than the map is, and is left out.
`tests/test_torch_middlebury14.py` holds both equal to the program's.
The kernels are found in the trace by their symbols: `costrows_kernel`,
which K4b's `costrows_magbin_kernel` does not contain, and
`aggregate_kernel`, both passes of a step.
"""

from __future__ import annotations

from typing import Optional

from . import tracing
from .reference import Config, Geometry
from .work import Work, aggregation_ops, correlation_ops

K4 = "costrows_kernel"
K5 = "aggregate_kernel"
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def _volume(cfg: Config, geom: Geometry, n: int) -> int:
    return (n * geom.disparities * geom.grid_h * geom.grid_w
            * ELEMENT_BYTES[cfg.dtype])


def k4(cfg: Config, geom: Geometry, n: int) -> Work:
    """K4 on n instances (one direction of one pair each)."""
    return Work({"imgs": 2 * n * geom.padded_height * geom.padded_width * 4,
                 "vol": _volume(cfg, geom, n)},
                correlation_ops(cfg, geom, n))


def k5(cfg: Config, geom: Geometry, n: int) -> Work:
    """K5 (fast or exact, every pass) on n instances."""
    top = geom.levels
    offsets = sum(n * (geom.disparities >> (lvl + 1)) * (geom.grid_h >> lvl)
                  * (geom.grid_w >> lvl) for lvl in range(top))
    return Work({"vol": _volume(cfg, geom, n),
                 "top": n * (geom.disparities >> top) * (geom.grid_h >> top)
                 * (geom.grid_w >> top) * ELEMENT_BYTES[cfg.dtype],
                 "offsets": offsets}, aggregation_ops(geom, n))


def instances(rec) -> int:
    """Instances a step of the record's cell runs: both directions of
    every pair with the LR check, else one."""
    return 2 * rec.batch if rec.cfg.lr_check else rec.batch


def seconds_per_step(trace: tracing.Trace, kernel: str) -> Optional[float]:
    """The device seconds of operations named after `kernel` in the
    window per `step` span opened in it; None without either."""
    steps = len(trace.spans.get("step", []))
    ops = tracing.clipped([(s, e) for name, s, e in trace.device_ops
                           if kernel in name], 0.0, trace.window_s)
    if not steps or not ops:
        return None
    return sum(e - s for s, e in ops) / steps
