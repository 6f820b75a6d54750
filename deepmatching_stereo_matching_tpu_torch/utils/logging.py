"""Structured JSONL run metrics (SURVEY.md §5.5) and profiler spans.

The reference observes its runs with prints and saved images ([K-high]);
this framework emits machine-readable JSONL records instead: one line
per event with a wall-clock timestamp, consumed by the bench harness and
the streaming runner (parallel/runner.py).

`span` marks a stage of the program on the profiler's clock: under any
`torch.profiler` session (`cli.py --profile`, `profile_steps.py`, the
benchmark's traced runs) it opens a profiler op named `dm.<name>`, whose
host range encloses the device work the stage launches.  An op, not a
`record_function` user annotation: under CUDA activity an annotation also
gets a device-side range over its kernels, which a reader that sums the
trace's device events would count as device work of its own; an op gets
none, and the profiler charges the kernels launched inside it to it
(`FunctionEvent.device_time_total`).  With no profiler active it costs
one check.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import IO, Optional

import torch

PREFIX = "dm."
_OFF = contextlib.nullcontext()
# The profiler's op range (RecordScope.FUNCTION), as torch's compiled
# graphs mark themselves; `record_function` opens a USER_SCOPE annotation.
_op_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records stage `name` as the profiler op `dm.<name>`
    while a profiler is active; its parent is the span that encloses it
    on this thread.  Otherwise the one shared null context, after a check
    that costs well under a microsecond."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _op_range(PREFIX + name)


class JsonlLogger:
    """Append JSON records (one per line) to a file and/or stream."""

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO] = None, echo: bool = False):
        self._f = open(path, "a") if path else None
        self._stream = stream if stream is not None else (
            sys.stderr if echo else None)

    def log(self, event: str, **fields) -> dict:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec)
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
