"""step: `pipeline.match_padded_core` issued back to back on padded
batches already on the card, cycled over `pool_batches` distinct batches
of `batch` pairs; the window ends at a synchronize.  Measures
`step_mpx_per_s`: real pixels of every pair of every step issued, over
the window's host-clock seconds."""

import time
from typing import Any, Dict

import numpy as np

from stereobench import drive, reference


def run(ctx: drive.Context) -> drive.Outcome:
    import torch

    t = ctx.traffic
    batch, n_pool = t["batch"], t["pool_batches"]
    pipeline = ctx.port.pipeline
    geom = ctx.cfg.geometry(ctx.height, ctx.width)
    raw = ctx.pairs(batch * n_pool)

    rgeom = ctx.ref_cfg.geometry(ctx.height, ctx.width)

    def planes(side):
        return [torch.from_numpy(np.stack([
            reference.pad_image(reference.to_grayscale_f32(p[side]), rgeom)
            for p in raw[b * batch:(b + 1) * batch]])).to(ctx.device)
            for b in range(n_pool)]

    lefts, rights = planes(0), planes(1)

    def warm(b):
        pipeline.match_padded_core(lefts[b % n_pool], rights[b % n_pool],
                                   ctx.cfg, geom, ctx.route)

    drive.warm_up(ctx, warm, n_pool)

    tracer, traced = ctx.tracer, ctx.tracer.on
    tracer.prime(lambda: pipeline.match_padded_core(lefts[0], rights[0],
                                                    ctx.cfg, geom, ctx.route))
    kept: Dict[int, Any] = {}      # pool batch -> its last step's outputs
    steps = 0
    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    mark, marks = t0 + 1.0, [0]
    while True:
        b = steps % n_pool
        if traced:
            with tracer.span("step"):
                out = pipeline.match_padded_core(lefts[b], rights[b],
                                                 ctx.cfg, geom, ctx.route)
            tracer.tick()
        else:
            out = pipeline.match_padded_core(lefts[b], rights[b], ctx.cfg,
                                             geom, ctx.route)
        kept[b] = (b, out)
        steps += 1
        now = time.perf_counter()
        if now >= mark:
            marks.append(steps)
            mark += 1.0
        if now >= deadline:
            break
    ctx.sync()
    t1 = time.perf_counter()
    tracer.stop()

    samples = []
    for (b, out), slot in drive.positions(ctx.rng(), batch,
                                          t["check_pairs"], kept):
        left, right = raw[b * batch + slot]
        samples.append((left, right, drive.host_outputs(out, slot, ctx)))
    return drive.Outcome(
        values={"step_mpx_per_s": drive.mpx(steps * batch, ctx, t1 - t0)},
        attempted=steps * batch, failed=0, window_start=t0,
        samples=samples, batch=batch,
        notes=[f"steps {steps} of {batch} pairs in {t1 - t0!r} s; steps a "
               f"second {[b - a for a, b in zip(marks, marks[1:])]}"])
