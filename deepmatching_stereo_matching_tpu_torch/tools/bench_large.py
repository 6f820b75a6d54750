"""KITTI-scale large-D throughput rows on one card.

    python -m deepmatching_stereo_matching_tpu_torch.tools.bench_large \\
        [--cpu] [--out PATH]

Counterpart of the JAX package's `tools/bench_large.py`: the same rows,
(D=128, batch 8, float32), (D=256, 4, float32) and (D=256, 4, bfloat16)
at 1242x375, on pairs of seeds 0 .. batch - 1 (`block=48`), each with
the same parity pair (seed 7) against the port's copy of the NumPy
oracle: float32 decisions and validity off it by at most 0.005, bfloat16
kept-pixel bad rate at most 0.05 above its.  The route is 'fused' where
`fused_cuda.supported` or `fused_cuda.cost_supported` holds (at KITTI
that is K4 -> K5), else 'exact'.  Each step is timed with
`utils.timing.steady_state` (median and range).

Each row holds the reference's keys: `impl` names the port's route, and
`compile_s` is the first call's host wall, which here is the kernel
library's load and the first launch (there is no trace or compile step
as in XLA).  Stdout carries one JSON line, {"rows": [...]}; diagnostics
go to stderr.  A file is written only with --out (the repo's
BENCH_LARGE.json is the reference's record and is never written).  Exits
1 if a gate failed, 2 without a card and without --cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..bench import (_kept_bad, log, match_pair, oracle_host, padded_batch,
                     timed)
from ..config import Config
from ..data import synthetic
from ..models import pipeline
from ..oracle import reference as oracle
from ..ops import fused_cuda

KH, KW = 375, 1242
ROWS = ((128, 8, "float32"), (256, 4, "float32"), (256, 4, "bfloat16"))
PARITY_SEED = 7
F32_DECISION_TOL = 0.005
BF16_KEPT_BAD_TOL = 0.05
REPEATS = 5


def kitti_pair(seed: int, max_d: int, height: int = KH, width: int = KW):
    """(left, right, gt) of the KITTI-size recipe."""
    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(height, width, max_d, rng,
                                            block=48)
    return synthetic.make_pair(height, width, field, seed=seed)


def route_for(cfg: Config, height: int, width: int) -> str:
    geom = cfg.geometry(height, width)
    return ("fused" if fused_cuda.supported(cfg, geom)
            or fused_cuda.cost_supported(cfg, geom) else "exact")


def bench_row(max_d: int, batch: int, dtype: str, device: torch.device, *,
              height: int = KH, width: int = KW, repeats: int = REPEATS,
              want: Optional[oracle.OracleResult] = None):
    """One row: the batched step timed, and its parity pair against the
    oracle (`want`, computed here if None; it does not depend on dtype).
    Returns (row, failures)."""
    cfg = Config(max_disparity=max_d, dtype=dtype)
    geom = cfg.geometry(height, width)
    route = route_for(cfg, height, width)
    pairs = [kitti_pair(i, max_d, height, width) for i in range(batch)]
    ls, rs = (padded_batch([p[i] for p in pairs], cfg, height, width, device)
              for i in (0, 1))

    def step(a, b):
        return pipeline.match_padded_core(a, b, cfg, geom, route)

    t0 = time.perf_counter()
    out = step(ls, rs)
    out["disparity"][0, 0, 0].item()
    compile_s = time.perf_counter() - t0

    gl, gr, ggt = kitti_pair(PARITY_SEED, max_d, height, width)
    t0 = time.perf_counter()
    if want is None:
        want = oracle.match_stereo(gl, gr, cfg)
    got = match_pair(gl, gr, cfg, device, route)
    raw_neq = float(np.mean(got["disparity_raw"] != want.disparity_raw))
    val_neq = float(np.mean(got["valid"] != want.valid))
    bad_got, bad_ora = (_kept_bad(got["disparity"], ggt),
                        _kept_bad(want.disparity, ggt))
    log(f"parity[D={max_d},{dtype}] raw_neq={raw_neq:.2e} "
        f"val_neq={val_neq:.2e} kept_bad={bad_got:.4f} (oracle "
        f"{bad_ora:.4f} on {oracle_host()}, took "
        f"{time.perf_counter() - t0:.0f}s)")
    failures = []
    if dtype == "float32":
        if raw_neq > F32_DECISION_TOL or val_neq > F32_DECISION_TOL:
            failures.append(f"parity at D={max_d}: raw_neq {raw_neq:.4f}, "
                            f"val_neq {val_neq:.4f} beyond "
                            f"{F32_DECISION_TOL}")
    elif bad_got - bad_ora > BF16_KEPT_BAD_TOL:
        failures.append(f"bf16 quality at D={max_d}: kept bad {bad_got:.4f}"
                        f" is {bad_got - bad_ora:+.4f} off the oracle's")

    stats = timed(step, (ls, rs), device, repeats)
    t = stats["median"]
    row: Dict[str, object] = {
        "height": height, "width": width, "max_disparity": max_d,
        "batch": batch, "dtype": dtype, "impl": route,
        "kept_bad_rate": bad_got, "oracle_kept_bad": bad_ora,
        "parity_raw_neq": raw_neq, "parity_val_neq": val_neq,
        "ms_per_step": t * 1e3,
        "timing": {k: stats[k] for k in ("median", "min", "max", "samples")},
        "mpx_per_s": batch * height * width * 1e-6 / t,
        "compile_s": compile_s,
        "volume_mb_per_direction": (geom.grid_h * geom.grid_w
                                    * geom.disparities
                                    * (2 if dtype == "bfloat16" else 4)
                                    * 1e-6)}
    mpx = batch * height * width * 1e-6
    log(f"[D={max_d} x {batch}, {dtype}, {route}] median {t * 1e3:.4f} ms "
        f"[{stats['min'] * 1e3:.4f}..{stats['max'] * 1e3:.4f}] = "
        f"{row['mpx_per_s']:.1f} Mpx/s [{mpx / stats['max']:.1f}.."
        f"{mpx / stats['min']:.1f}]; first call {compile_s:.3f} s")
    log(json.dumps(row))
    return row, failures


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deepmatching_stereo_matching_tpu_torch.tools.bench_large",
        description="KITTI-scale large-D throughput rows on one GPU")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--out", default=None,
                    help="also write {\"rows\": [...]} to this file")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        log("error: no CUDA device (torch.cuda.is_available() is False); "
            "pass --cpu to run on the CPU")
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    log(f"device={device}")
    rows, failures, oracle_at = [], [], {}
    for max_d, batch, dtype in ROWS:
        if max_d not in oracle_at:
            gl, gr, _ = kitti_pair(PARITY_SEED, max_d, KH, KW)
            oracle_at[max_d] = oracle.match_stereo(
                gl, gr, Config(max_disparity=max_d))
        row, fails = bench_row(max_d, batch, dtype, device, height=KH,
                               width=KW, repeats=REPEATS,
                               want=oracle_at[max_d])
        rows.append(row)
        failures += fails
    if failures:
        for f in failures:
            log("GATE FAILURE:", f)
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
    print(json.dumps({"rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
