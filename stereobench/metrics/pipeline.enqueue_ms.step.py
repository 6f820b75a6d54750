"""pipeline.enqueue_ms.step: the median host time from a call of
`pipeline.match_padded_core` to its return (the kernels are asynchronous,
so this is the host's issue of one step), from the spans around the
harness's calls, in milliseconds."""

from statistics import median


def read(rec):
    secs = rec.trace.span_seconds("step")
    return median(secs) * 1e3 if secs else None
