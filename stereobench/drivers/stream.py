"""stream: `parallel.run_stream` (`strategy`, `batch` pairs a batch) on a
one-rank world, fed `uint8` colour pairs from a pool of `pool_pairs`
until the deadline, in whole batches.  Measures `stream_mpx_per_s`: real
pixels of the pairs it completed, over the wall time of the call."""

import io
import json
import time
from typing import Any, Dict

from stereobench import drive, synthetic


def run(ctx: drive.Context) -> drive.Outcome:
    import torch.distributed as dist

    t = ctx.traffic
    batch, n_pool = t["batch"], t["pool_pairs"]
    runner, sharded = ctx.port.runner, ctx.port.sharded
    pool = [(synthetic.to_rgb8(left), synthetic.to_rgb8(right))
            for left, right in ctx.pairs(n_pool)]

    backend = "nccl" if ctx.device.type == "cuda" else "gloo"
    ctx.port.launch.init(backend, 0, 1,
                         f"tcp://localhost:{drive.free_port()}")
    try:
        mesh = ctx.port.mesh.make_mesh(1, 1)

        def stream(pairs, **kw):
            return runner.run_stream(pairs, ctx.cfg, ctx.height, ctx.width,
                                     mesh, t["strategy"], batch, ctx.route,
                                     **kw)

        drive.warm_up(ctx, lambda k: stream(
            pool[(k * batch) % n_pool:][:batch], on_result=lambda i, o: None),
            1)

        tracer = ctx.tracer
        tracer.prime(lambda: stream(pool[:batch],
                                    on_result=lambda i, o: None))
        groups = max(1, n_pool // batch)
        kept: Dict[int, Any] = {}  # pool group -> its last batch's outputs
        fed = [0]

        def on_result(index, out):
            kept[index % groups] = (index, out)

        def feed(deadline):
            k = 0
            while True:
                if k % batch == 0:
                    tracer.tick()
                    if time.perf_counter() >= deadline:
                        break
                yield pool[k % n_pool]
                k += 1
                fed[0] = k

        log_text = io.StringIO()
        logger = ctx.port.JsonlLogger(stream=log_text)
        tracer.wrap(sharded, "pad_batch", "pad_batch")
        tracer.wrap(sharded, "match_batch_sharded", "match")
        tracer.start()
        t0 = time.perf_counter()
        with tracer.span("run_stream"):
            report = stream(feed(t0 + ctx.seconds), on_result=on_result,
                            logger=logger)
        t1 = time.perf_counter()
        tracer.stop()
        tracer.restore()
    finally:
        dist.destroy_process_group()

    samples = []
    for entry, slot in drive.positions(ctx.rng(), batch, t["check_pairs"],
                                       kept):
        if entry is None:                    # no batch completed
            samples.append(pool[slot % n_pool] + (None,))
            continue
        index, out = entry
        left, right = pool[(index * batch + slot) % n_pool]
        samples.append((left, right, {key: v[slot] for key, v in out.items()}))
    logs = [json.loads(line) for line in log_text.getvalue().splitlines()]
    return drive.Outcome(
        values={"stream_mpx_per_s": drive.mpx(report.pairs_completed, ctx,
                                              t1 - t0)},
        attempted=fed[0], failed=fed[0] - report.pairs_completed,
        window_start=t0, samples=samples, logs=logs, batch=batch,
        notes=[f"stream {report.pairs_completed} pairs in "
               f"{report.batches_completed} batches, {report.retries} "
               f"retries, {t1 - t0!r} s"])
