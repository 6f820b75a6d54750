"""kernels.k2_roofline.step: K2's share of its roofline, in percent: the
least time the card could take for a step's K2 work (`k2k3.k2` on both
directions of every pair: bytes over 3.35 TB/s or operations over 67
TFLOP/s, the larger) over K2's device time a step (operations named
`k2k3.K2` over the steps issued in the window).  None where the trace
holds none (no card, or a program that does not run K2)."""

from stereobench import k2k3, k4k5, work


def read(rec):
    sec = k4k5.seconds_per_step(rec.trace, k2k3.K2)
    if sec is None:
        return None
    least, _ = work.bound(k2k3.k2(rec.cfg, rec.geom, k4k5.instances(rec)))
    return 100.0 * least / sec
