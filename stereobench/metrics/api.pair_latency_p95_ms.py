"""api.pair_latency_p95_ms: the nearest-rank 95th percentile of a pair's
latency, from its due time on the open-loop schedule to the return of
`api.match_stereo`'s host outputs, over the pairs due after the profiler's
window had closed (its host cost would lengthen the others), in
milliseconds.  None where no pair came after it."""


def read(rec):
    return rec.values.get("pair_latency_p95_ms")
