"""kernels.k4b_roofline.step: K4b's share of its roofline, in percent:
the least time the card could take for a step's K4b work (`k4b.k4b` on
both directions of every pair: bytes over 3.35 TB/s or operations over
67 TFLOP/s, the larger) over its device time a step
(`kernels.k4b_ms.step`).  None where that reads nothing."""

from stereobench import k4b, work


def read(rec):
    sec = k4b.seconds_per_step(rec.trace)
    if sec is None:
        return None
    n = 2 * rec.batch if rec.cfg.lr_check else rec.batch
    least, _ = work.bound(k4b.k4b(rec.cfg, rec.geom, n))
    return 100.0 * least / sec
