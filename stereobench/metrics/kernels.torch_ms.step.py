"""kernels.torch_ms.step: the device time of PyTorch's own kernels a step,
in milliseconds: the profiler's device operations whose name holds
`at::native` (torch's elementwise, reduction, copy and concatenation
kernels; not the port's hand-written kernels, not memcpy or memset) in
the traced window, over the steps issued in it.  On the exact route that
is the descriptor chain, the flips and the stacks.  None where the trace
holds none (no card)."""

from stereobench import tracing

MARK = "at::native"


def read(rec):
    trace = rec.trace
    steps = len(trace.spans.get("step", []))
    ops = tracing.clipped([(s, e) for name, s, e in trace.device_ops
                           if MARK in name], 0.0, trace.window_s)
    if not steps or not ops:
        return None
    return sum(e - s for s, e in ops) / steps * 1e3
