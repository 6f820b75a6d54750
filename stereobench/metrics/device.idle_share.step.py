"""device.idle_share.step: the share of the traced window in which no
device operation ran, 1 - (union of the device operations' intervals) /
window.  The profiler's own host overhead lengthens the window where the
host bounds the work, so this reads high.  None without device
operations (no card)."""

from stereobench import tracing


def read(rec):
    return tracing.idle_share(rec.trace)
