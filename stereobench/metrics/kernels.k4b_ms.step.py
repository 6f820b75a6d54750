"""kernels.k4b_ms.step: K4b's device time a step, in milliseconds: the
profiler's device operations named after its kernel
(`k4b.KERNEL`) in the traced window, over the steps issued in it.  None
where the trace holds none (no card, or a program that does not run
K4b)."""

from stereobench import k4b


def read(rec):
    sec = k4b.seconds_per_step(rec.trace)
    return None if sec is None else sec * 1e3
