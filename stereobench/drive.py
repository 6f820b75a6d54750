"""What every traffic driver shares: its context, its outcome, the
warm-up, and the drawing of the check's sample.

A traffic file (`traffic/<mix>.json`) names its `driver` and its
parameters.  The driver is the file `drivers/<driver>.py`, found by that
name as a per-layer metric's reader is: it exposes `run(ctx: Context) ->
Outcome`, reads its parameters from `ctx.traffic`, and depends on the cell
only through them.  A later mix that needs another driver adds a file
there; nothing here or in the harness changes.

Pairs come from `--seed` through the configuration's recipe
(`synthetic.recipe_pair`); the sample that `check.py` compares is drawn
from the seed too.  Every driver warms up each shape it uses before the
window (set-up) and keeps, for the check, answers from inside the window.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import time
from typing import Any, Callable, Dict, List

import numpy as np

from . import check, synthetic

# Set-up runs the traffic for this long after each shape's first call, so
# that the window starts on clocks and caches in their steady state.
WARMUP_SECONDS = 2.0


@dataclasses.dataclass
class Context:
    """What a driver needs: the program, the cell's sizes and traffic,
    the run's seed and length, and the tracer."""

    port: Any                  # namespace of the program's modules
    device: Any                # torch.device
    cfg: Any                   # the program's Config
    ref_cfg: Any               # the reference's Config, the same fields
    height: int
    width: int
    route: str
    recipe: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    tracer: Any

    def pairs(self, n: int) -> List[tuple]:
        """n (left, right) float planes of the recipe, from the seed."""
        out = []
        for i in range(n):
            left, right, _ = synthetic.recipe_pair(
                self.seed * 4096 + i, self.height, self.width,
                self.cfg.max_disparity, self.recipe["block"])
            out.append((left, right))
        return out

    def rng(self) -> np.random.Generator:
        """The check's sampling stream (apart from the pairs')."""
        return np.random.default_rng([self.seed, 1])

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    values: Dict[str, float]           # end-to-end measurements by name
    attempted: int
    failed: int
    window_start: float                # perf_counter at the window's start
    samples: List[check.Sample]
    logs: List[dict] = dataclasses.field(default_factory=list)
    batch: int = 1
    notes: List[str] = dataclasses.field(default_factory=list)


def mpx(pairs: int, ctx: Context, seconds: float) -> float:
    """Real megapixels (H x W, not padded) of `pairs` a second."""
    return pairs * ctx.height * ctx.width * 1e-6 / seconds


def host_outputs(out: Dict[str, Any], i: int, ctx: Context
                 ) -> Dict[str, np.ndarray]:
    """Pair `i` of a batch of device outputs, cropped, on the host."""
    return {k: v[i, :ctx.height, :ctx.width].cpu().numpy()
            for k, v in out.items()}


def positions(rng: np.random.Generator, batch: int, n: int,
              kept: Dict[int, Any]):
    """n (kept entry, slot) picks of distinct slots, taken from the two
    halves of the batch in turn so that the sample reaches both, each
    from a pool group drawn from the seed (`kept` maps a group to the
    window's last answer for it; None where nothing was kept)."""
    half = batch // 2
    halves = [list(rng.permutation(half)), list(half + rng.permutation(
        batch - half))]
    slots = [halves[j % 2].pop() if halves[j % 2] else halves[1 - j % 2].pop()
             for j in range(min(n, batch))]
    groups = sorted(kept)
    picks = []
    for s in slots:
        g = int(rng.integers(max(len(groups), 1)))
        picks.append((kept[groups[g]] if groups else None, int(s)))
    return picks


def warm_up(ctx: Context, unit: Callable[[int], object], first: int
            ) -> None:
    """Set-up: `first` units (each shape the traffic uses), then units
    back to back for `WARMUP_SECONDS`."""
    k = 0
    end = time.perf_counter() + WARMUP_SECONDS
    while k < first or time.perf_counter() < end:
        unit(k)
        k += 1
    ctx.sync()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_until(due: float) -> None:
    while True:
        left = due - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 0.001 if left > 0.002 else 0)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]
