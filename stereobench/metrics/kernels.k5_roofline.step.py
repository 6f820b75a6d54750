"""kernels.k5_roofline.step: K5's share of its roofline, in percent: the
least time the card could take for a step's K5 work (`k4k5.k5` on both
directions of every pair, all levels) over K5's device time a step
(operations named `k4k5.K5`, every pass, over the steps issued in the
window).  None where the trace holds none (no card, or a program that
does not run K5)."""

from stereobench import k4k5, work


def read(rec):
    sec = k4k5.seconds_per_step(rec.trace, k4k5.K5)
    if sec is None:
        return None
    least, _ = work.bound(k4k5.k5(rec.cfg, rec.geom, k4k5.instances(rec)))
    return 100.0 * least / sec
