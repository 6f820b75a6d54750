"""Measure how fast the card streams the disparity loop's mul/add mix.

    python3 -m deepmatching_stereo_matching_tpu_torch.tools.vpu_probe [--out PATH]
    python3 -m deepmatching_stereo_matching_tpu_torch.tools.vpu_probe --cpu

The counterpart of the JAX package's `tools/vpu_ceiling.py` on an NVIDIA
GPU: the three probes P1-P3 (ops/probe_cuda.py, csrc/probe.cu) at the
TPU probes' shapes and operand schedules, each

    plane(d) = a[j1]*a[j2] + ... (4 products) ; total += plane   (64 planes)

repeated GRID (P1), 8 * GRID (P2) and 2 * GRID (P3) times.  Each probe's
output is first held bitwise to its plain version, then timed with
`utils/timing.steady_state` (CUDA events), counting 8 FLOPs per
plane-element as the JAX probe does.  One JSON line per probe: seconds
(median, min, max), achieved FLOP/s, the fraction of the published 67
TFLOP/s float32 peak and of 33.5 TFLOP/s (the ceiling of a mix with no
FMA, which the probe's is), the bytes read once and from L2, and the
card's name and power limit.  A fraction above 1.05 of 67 TFLOP/s means
work was merged away and exits 1.  Writes a file only with `--out`; the
TPU's `VPU_CEILING.json` is never touched.

Runs on the card; without one it exits 2 unless `--cpu` asks for the
plain versions on the CPU (one timed call each), whose times are no
device metric (the fractions are then null).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from typing import Optional

import torch

from ..ops import probe_cuda
# The card's peaks and the merged-work gate: the port's one definition.
from ..work import MERGED_WORK, PEAK_F32, PEAK_NO_FMA
from ..work import probe as probe_work


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of card 0."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


def l2_bytes(name: str) -> int:
    """Input bytes the kernel reads in all: its rows once per block copy."""
    _, _, grid, inner = probe_cuda.PROBES[name]
    return (grid // inner) * probe_work(name).bytes["read"]


def run_probe(name: str, device: torch.device, grid: int = 64,
              reps: int = 20, repeats: int = 5) -> dict:
    """Check one probe bitwise against its plain version and time it
    (`reps` calls per sample, `repeats` samples; repetitions scale with
    `grid`, the TPU probe's GRID)."""
    from ..utils import timing

    _, _, full, inner = probe_cuda.PROBES[name]
    total = full * grid // probe_cuda.GRID
    inner = math.gcd(inner, total)
    a = probe_cuda.make_input(name, device)
    kernel = probe_cuda.KERNELS[name]
    got = kernel(a, total, inner)
    want = probe_cuda.PLAIN[name](a, 1)
    if not torch.equal(got, want):
        raise RuntimeError(f"probe {name!r}: kernel output differs from its "
                           f"plain version (max |diff| "
                           f"{float((got - want).abs().max()):.3e})")
    stats = timing.steady_state(kernel, (a, total, inner), reps=reps,
                                repeats=repeats, device=device)
    flop = probe_work(name, total).total_ops
    rate = flop / stats["median"]
    on_card = device.type == "cuda"
    return {
        "probe": name, "device": str(device),
        "shape_in": list(a.shape), "repetitions": total,
        "repetitions_per_thread": inner,
        "seconds": {k: stats[k] for k in ("median", "min", "max")},
        "samples": stats["samples"], "calls_per_sample": reps,
        "elementwise_flops": flop, "achieved_flop_per_s": rate,
        "fraction_of_67_tflops": rate / PEAK_F32 if on_card else None,
        "fraction_of_33_5_tflops": rate / PEAK_NO_FMA if on_card else None,
        "bytes_read": probe_work(name).bytes["read"],
        "l2_bytes": l2_bytes(name) if on_card else None,
        "arithmetic_s_at_33_5_tflops": flop / PEAK_NO_FMA,
    }


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU (no device "
                        "metric)")
    p.add_argument("--out", help="also write the JSON lines to this file")
    args = p.parse_args(argv)
    if args.cpu:
        device, card = torch.device("cpu"), "cpu"
    elif not torch.cuda.is_available():
        print("vpu_probe: no CUDA device (torch.cuda.is_available() is "
              "False); pass --cpu to run the plain versions on the CPU",
              file=sys.stderr)
        return 2
    else:
        device, card = torch.device("cuda", 0), card_line()
    timing = {} if device.type == "cuda" else {"reps": 1, "repeats": 1}
    rows = []
    for name in ("stream", "small", "shift"):
        row = {**run_probe(name, device, **timing), "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    merged = [r["probe"] for r in rows
              if (r["fraction_of_67_tflops"] or 0) > MERGED_WORK]
    if merged:
        print(f"vpu_probe: {merged} ran above {MERGED_WORK} of the 67 "
              f"TFLOP/s peak: work was merged away", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
