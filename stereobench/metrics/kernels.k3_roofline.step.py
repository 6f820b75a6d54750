"""kernels.k3_roofline.step: K3's share of its roofline, in percent: the
least time the card could take for a step's K3 work (`k2k3.k3` on both
directions of every pair: bytes over 3.35 TB/s or operations over 67
TFLOP/s, the larger) over K3's device time a step (operations named
`k2k3.K3` over the steps issued in the window).  None where the trace
holds none (no card, or a program that does not run K3)."""

from stereobench import k2k3, k4k5, work


def read(rec):
    sec = k4k5.seconds_per_step(rec.trace, k2k3.K3)
    if sec is None:
        return None
    least, _ = work.bound(k2k3.k3(rec.cfg, rec.geom, k4k5.instances(rec)))
    return 100.0 * least / sec
