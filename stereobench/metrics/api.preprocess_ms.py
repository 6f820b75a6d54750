"""api.preprocess_ms: the median host time of one `api.preprocess` call
(grayscale and padding of one image), from its wrapper spans, in
milliseconds."""

from statistics import median


def read(rec):
    secs = rec.trace.span_seconds("preprocess")
    return median(secs) * 1e3 if secs else None
