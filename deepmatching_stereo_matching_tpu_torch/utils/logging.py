"""Structured JSONL run metrics (SURVEY.md §5.5).

The reference observes its runs with prints and saved images ([K-high]);
this framework emits machine-readable JSONL records instead: one line
per event with a wall-clock timestamp, consumed by the bench harness and
the streaming runner (parallel/runner.py).
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


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
