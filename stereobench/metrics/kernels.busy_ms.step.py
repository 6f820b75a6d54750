"""kernels.busy_ms.step: the device time of one step, the sum of the
profiler's device operations in the traced window over the steps issued
in it, in milliseconds.  None where the trace holds no device operation
(no card)."""

from stereobench import tracing


def read(rec):
    busy = tracing.device_seconds_per(rec.trace, "step")
    return None if busy is None else busy * 1e3
