"""online: `api.match_stereo` on one `uint8` colour pair at a time, open
loop at `rate_hz`, pairs cycled from a pool of `pool_pairs`.  Each pair is
timed from its due time to the return of its host outputs; a pair that
fails counts as missing and as late.  Measures `pairs_on_time_pct`, the
share of the pairs due in the window answered within `deadline_ms` (a rig's
frame interval: its answer is there before the next frame), and
`pair_latency_p95_ms` over the pairs due once the profiler had stopped (all
of them in an untraced run), which `metrics/api.pair_latency_p95_ms.py`
reads."""

import dataclasses
import math
import sys
import time
from typing import Dict, Optional

from stereobench import drive, synthetic


def run(ctx: drive.Context) -> drive.Outcome:
    t = ctx.traffic
    api = ctx.port.api
    rate, n_pool = t["rate_hz"], t["pool_pairs"]
    deadline = t["deadline_ms"] * 1e-3
    pool = [(synthetic.to_rgb8(left), synthetic.to_rgb8(right))
            for left, right in ctx.pairs(n_pool)]

    def serve(k):
        left, right = pool[k % n_pool]
        return api.match_stereo(left, right, ctx.cfg, impl=ctx.route,
                                device=ctx.device)

    drive.warm_up(ctx, serve, 3)

    n_due = int(rate * ctx.seconds)
    keep = set(int(k) for k in ctx.rng().choice(n_due, t["check_pairs"],
                                                replace=False))
    answers: Dict[int, Optional[dict]] = {}
    latency, late = [], []
    failed = 0
    tracer = ctx.tracer
    tracer.prime(lambda: serve(0))
    tracer.wrap(api, "preprocess", "preprocess")
    tracer.wrap(api.pipeline, "match_padded", "step")
    tracer.start()
    t0 = time.perf_counter() + 0.005
    for k in range(n_due):
        due = t0 + k / rate
        drive.wait_until(due)
        begin = time.perf_counter()
        late.append(begin - due)
        try:
            with tracer.span("match_stereo"):
                res = serve(k)
        except Exception as e:  # a failed pair counts as missing
            failed += 1
            latency.append(math.inf)
            if k in keep:
                answers[k] = None
            print(f"pair {k} failed: {e!r}"[:300], file=sys.stderr,
                  flush=True)
            continue
        latency.append(time.perf_counter() - due)
        if k in keep:
            answers[k] = dataclasses.asdict(res)
        tracer.tick()
    t1 = time.perf_counter()
    tracer.stop()
    tracer.restore()

    samples = [pool[k % n_pool] + (answers.get(k),) for k in sorted(keep)]
    p95 = drive.p95(latency)
    on_time = 100.0 * sum(x <= deadline for x in latency) / n_due
    closed = tracer.closed_at
    unprofiled = [x for k, x in enumerate(latency)
                  if closed is None or t0 + k / rate >= closed]
    values = {"pairs_on_time_pct": on_time}
    if unprofiled:
        values["pair_latency_p95_ms"] = drive.p95(unprofiled) * 1e3
    late.sort()
    return drive.Outcome(
        values=values,
        attempted=n_due, failed=failed, window_start=t0, samples=samples,
        notes=[f"online {n_due} pairs due at {rate} Hz over {t1 - t0!r} s; "
               f"latency p50 {sorted(latency)[n_due // 2] * 1e3!r} ms, p95 "
               f"{p95 * 1e3!r} ms, max {max(latency) * 1e3!r} ms, on time "
               f"{on_time!r}% within {t['deadline_ms']!r} ms; generator "
               f"late p50 {late[n_due // 2] * 1e3!r} ms, max "
               f"{late[-1] * 1e3!r} ms"])
