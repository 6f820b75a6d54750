"""kernels.step_roofline: the step's kernels' share of their roofline, in
percent: the least time the card could take for the step's function (the
frozen work model's `bound(step_fused(...))`: bytes over 3.35 TB/s or
operations over 67 TFLOP/s, the larger) over `kernels.busy_ms.step`.  It
reads the same work whatever kernels implement it."""

from stereobench import tracing, work


def read(rec):
    busy = tracing.device_seconds_per(rec.trace, "step")
    if busy is None:
        return None
    least, _ = work.bound(work.step_fused(rec.cfg, rec.geom, rec.batch))
    return 100.0 * least / busy
