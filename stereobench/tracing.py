"""Spans and device operations of a traced run, and what they add up to.

In a `--trace 1` run the harness opens `torch.profiler` over the first
`trace_seconds` of the window (the whole window where the traffic gives
none) and records spans from its own files only: calls into a layer are
wrapped in `record_function("stereobench.<span>")`, either around the
harness's own call or by replacing a module attribute of the program for
the traced run alone.  Nothing inside the program changes.  Spans and the
profiler's device operations share one clock, so each idle gap of the
device is labelled by the span that was open on the host at the time.

The readers under `metrics/` take a `Trace`: spans and device operations
in seconds from the start of the traced window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "stereobench."
_START, _END = PREFIX + "window_start", PREFIX + "window_end"

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    """What the traced window recorded, in seconds from its start."""

    window_s: float
    spans: Dict[str, List[Interval]]
    device_ops: List[Tuple[str, float, float]]   # (name, start, end)

    def span_seconds(self, name: str) -> List[float]:
        return [e - s for s, e in self.spans.get(name, [])]


def merged(intervals: List[Interval]) -> List[Interval]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: List[Interval]) -> float:
    """Seconds covered by the union of intervals."""
    return sum(e - s for s, e in merged(intervals))


def clipped(intervals: List[Interval], lo: float, hi: float
            ) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_seconds(trace: Trace, within: Optional[List[Interval]] = None
                 ) -> float:
    """Seconds in which a device operation ran, inside the window or
    inside the union of `within`."""
    ops = [(s, e) for _, s, e in trace.device_ops]
    if within is None:
        return covered(clipped(ops, 0.0, trace.window_s))
    return sum(covered(clipped(ops, s, e)) for s, e in merged(within))


def device_seconds_per(trace: Trace, span: str) -> Optional[float]:
    """Seconds of device operations in the window per `span` opened in
    it; None without either."""
    n = len(trace.spans.get(span, []))
    ops = clipped([(s, e) for _, s, e in trace.device_ops], 0.0,
                  trace.window_s)
    if not n or not ops:
        return None
    return sum(e - s for s, e in ops) / n


def idle_share(trace: Trace) -> Optional[float]:
    """1 - (union of the device operations) / window; None without
    device operations."""
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 1.0 - busy_seconds(trace) / trace.window_s


def idle_gaps(trace: Trace) -> List[Tuple[str, float]]:
    """Every stretch of the window in which no device operation ran, as
    (label, seconds): the innermost span open at its middle, or 'none'."""
    busy = merged(clipped([(s, e) for _, s, e in trace.device_ops], 0.0,
                          trace.window_s))
    edges = [0.0] + [x for iv in busy for x in iv] + [trace.window_s]
    spans = [(s, e, name) for name, ivs in trace.spans.items()
             for s, e in ivs]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        open_ = [(ss, -ee, name) for ss, ee, name in spans
                 if ss <= mid <= ee]            # innermost: opened last
        gaps.append((max(open_)[2] if open_ else "none", e - s))
    return gaps


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took the most time, and idle time
    summed by the host span that was open, ten at most each."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, s, e in trace.device_ops:
        inside = min(e, trace.window_s) - max(s, 0.0)
        if inside > 0:
            by_op[name] += inside
    by_gap: Dict[str, float] = defaultdict(float)
    for label, sec in idle_gaps(trace):
        by_gap[label] += sec
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


class Tracer:
    """The profiler over the head of the window, and the span wrappers.

    Disabled (`--trace 0`), every method is a no-op and `span` is a null
    context; the step driver, whose calls are shortest, does not even
    enter that on its untraced path."""

    def __init__(self, enabled: bool, cuda: bool,
                 seconds: Optional[float] = None):
        self.on = enabled
        self._cuda = cuda
        self._cap = seconds
        self._prof = None
        self._done = None
        self._t0 = 0.0
        self._patched: List[Tuple[object, str, object]] = []
        self.trace: Optional[Trace] = None
        # perf_counter once the profiler has stopped: work due from then
        # on ran without it.  None while it has not run.
        self.closed_at: Optional[float] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)

    def wrap(self, module, attr: str, name: str) -> None:
        """Replace `module.attr` with a wrapper that opens span `name`
        around each call, until `restore`."""
        if not self.on:
            return
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        self._patched.append((module, attr, fn))
        setattr(module, attr, wrapped)

    def restore(self) -> None:
        while self._patched:
            module, attr, fn = self._patched.pop()
            setattr(module, attr, fn)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def prime(self, unit: Callable[[], object]) -> None:
        """Set-up: profile one unit of work and drop it.  The profiler's
        first session in a process starts its tracing library, which takes
        seconds; the window's session then starts in milliseconds."""
        if not self.on:
            return
        with self._profile():
            unit()
            if self._cuda:
                import torch
                torch.cuda.synchronize()

    def start(self) -> None:
        if not self.on:
            return
        self._prof = self._profile()
        self._prof.start()
        self._mark(_START)
        self._t0 = time.perf_counter()

    def tick(self) -> None:
        """Between two units of work: close the traced window once it has
        lasted `seconds`."""
        if (self._prof is not None and self._cap is not None
                and time.perf_counter() - self._t0 >= self._cap):
            self.stop()

    def stop(self) -> None:
        """Close the traced window (after the device has finished what
        was issued in it) and read the trace."""
        if self._prof is None:
            return
        if self._cuda:
            import torch
            torch.cuda.synchronize()
        self._mark(_END)
        prof, self._prof = self._prof, None
        prof.stop()
        self._done = prof
        self.closed_at = time.perf_counter()

    def read(self) -> Optional[Trace]:
        """The traced window (None untraced), read once the run is over."""
        if self.trace is None and self._done is not None:
            self.trace = _read(self._done)
            self._done = None
        return self.trace

    def _mark(self, name: str) -> None:
        import torch
        with torch.profiler.record_function(name):
            pass


def _read(prof) -> Trace:
    """Spans and device operations from the profiler's raw events."""
    from torch.autograd import DeviceType
    t0 = t1 = None
    spans: Dict[str, List[Interval]] = defaultdict(list)
    raw_ops = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            if name == _START:
                t0 = start
            elif name == _END:
                t1 = start
            elif name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((start, end))
        elif not name.startswith(PREFIX):     # not the GPU side of a span
            raw_ops.append((name, start, end))
    if t0 is None or t1 is None:
        raise RuntimeError("the trace lost the window's markers")
    sec: Callable[[int], float] = lambda ns: (ns - t0) * 1e-9  # noqa: E731
    return Trace(window_s=sec(t1),
                 spans={k: [(sec(s), sec(e)) for s, e in v]
                        for k, v in spans.items()},
                 device_ops=[(n, sec(s), sec(e)) for n, s, e in raw_ops])
