"""device.idle_share.online: the share of the requests' in-flight time in
which no device operation ran: 1 - (device time inside the
`api.match_stereo` calls) / (the summed time of those calls).  Not the
window, which at an open-loop rate is mostly the gap between pairs.  None
without device operations (no card)."""

from stereobench import tracing


def read(rec):
    calls = rec.trace.spans.get("match_stereo", [])
    if not rec.trace.device_ops or not calls:
        return None
    inflight = sum(e - s for s, e in calls)
    return 1.0 - tracing.busy_seconds(rec.trace, within=calls) / inflight
