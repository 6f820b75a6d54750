"""K4b, the port's cost-volume kernel on grad_hist (magnitude, bin) planes,
as the benchmark reads it: its work, frozen here as `work.py` freezes the
step's, and its device time in a traced window.

`k4b` is a copy of the port's `work.k4b`: bytes count the four float32
padded planes of an instance (magnitudes and bins) read once and the
D-major volume written once; operations count a bin's p^2 multiply-adds
(2 each) and p^2 bin compares (1 each) over the bins below max_disparity.
The bins count 4 bytes a pixel, the float32 planes the kernel is given:
uint8 bins would lower the bound at the KITTI D=256 step's 64 instances
from 0.9015 to 0.8339 ms (float32 volume), so the roofline share credits
the kernel for bytes a byte-wide bin plane would not need.
`tests/test_torch_cost_magbin.py` holds it equal to the program's.  The
kernel is found in the trace by its symbol, `costrows_magbin_kernel`,
which no other kernel's name contains.
"""

from __future__ import annotations

from typing import Optional

from . import tracing
from .reference import Config, Geometry
from .work import Work, magbin_ops

KERNEL = "costrows_magbin_kernel"
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def k4b(cfg: Config, geom: Geometry, n: int) -> Work:
    """K4b on n instances (one direction of one pair each)."""
    planes = 2 * n * geom.padded_height * geom.padded_width * 4
    volume = (n * geom.disparities * geom.grid_h * geom.grid_w
              * ELEMENT_BYTES[cfg.dtype])
    return Work({"imgs": planes, "bins": planes, "vol": volume},
                magbin_ops(cfg, geom, n))


def seconds_per_step(trace: tracing.Trace) -> Optional[float]:
    """K4b's device seconds in the window per `step` span opened in it;
    None without either."""
    steps = len(trace.spans.get("step", []))
    ops = tracing.clipped([(s, e) for name, s, e in trace.device_ops
                           if KERNEL in name], 0.0, trace.window_s)
    if not steps or not ops:
        return None
    return sum(e - s for s, e in ops) / steps
