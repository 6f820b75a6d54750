"""kernels.k4_roofline.step: K4's share of its roofline, in percent: the
least time the card could take for a step's K4 work (`k4k5.k4` on both
directions of every pair: bytes over 3.35 TB/s or operations over 67
TFLOP/s, the larger) over K4's device time a step (operations named
`k4k5.K4` over the steps issued in the window).  None where the trace
holds none (no card, or a program that does not run K4)."""

from stereobench import k4k5, work


def read(rec):
    sec = k4k5.seconds_per_step(rec.trace, k4k5.K4)
    if sec is None:
        return None
    least, _ = work.bound(k4k5.k4(rec.cfg, rec.geom, k4k5.instances(rec)))
    return 100.0 * least / sec
