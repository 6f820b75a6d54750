"""kernels.epilogue_ms.step: the device time of the step's epilogue
kernel (the LR check, densify and the five outputs) a step, in
milliseconds: the profiler's device operations whose name holds its
symbol, `lr_outputs_kernel`, which no other kernel's name contains, in
the traced window, over the steps issued in it.  None where the trace
holds none (no card, or a program that runs the epilogue as torch
operations)."""

from stereobench import tracing

KERNEL = "lr_outputs_kernel"


def read(rec):
    trace = rec.trace
    steps = len(trace.spans.get("step", []))
    ops = tracing.clipped([(s, e) for name, s, e in trace.device_ops
                           if KERNEL in name], 0.0, trace.window_s)
    if not steps or not ops:
        return None
    return sum(e - s for s, e in ops) / steps * 1e3
