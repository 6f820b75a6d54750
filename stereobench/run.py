"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python -m stereobench.run --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1> [--control]

Run from the root of a checkout that holds the port
(`deepmatching_stereo_matching_tpu_torch`) and this folder, on a machine
with a CUDA card.  It makes the cell's pairs from `--seed`, warms up every
shape the cell uses (set-up), drives the program for `--seconds` with the
driver its traffic file names (`drivers/<driver>.py`), then compares a
sample of the answers from inside the window with the plain reference
(`check.py`).  With `--trace 0` the result's metrics are the cell's
end-to-end metrics; with `--trace 1` the profiler runs over the head of
the window and the metrics are the cell's per-layer metrics, read by
`metrics/<name>.py`.  `--control` runs the program in the
configuration's lower precision (its `control` fields), for the check's
control; the benchmark's own runs never pass it.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`: each compared number beside its limit); the last lines
of standard error are the same numbers.  Exit 2 without a card (or with
fewer than the cell asks for), without the port, or for an unknown cell;
1 if the run fails or loads JAX or the JAX package.  Every build and cache
stays inside the checkout: the kernel library in the port's `_build/`.
"""

import time

_T_PROCESS = time.perf_counter()

import os  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One process with few threads; NCCL's one-rank world on the loopback,
# with no shared-memory segments; any compiler cache inside the checkout.
for _k, _v in {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
               "OPENBLAS_NUM_THREADS": "1", "NCCL_SHM_DISABLE": "1",
               "NCCL_SOCKET_IFNAME": "lo",
               "TRITON_CACHE_DIR": os.path.join(ROOT, ".stereobench_cache",
                                                "triton"),
               "TORCH_EXTENSIONS_DIR": os.path.join(
                   ROOT, ".stereobench_cache", "torch_extensions")}.items():
    os.environ[_k] = _v

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m stereobench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program in the configuration's lower "
                         "precision (the check's control)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from stereobench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (KeyError, OSError) as e:
        log(f"error: {e}")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("error: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"error: the cell needs {cell.chips} cards, "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        return 2
    try:
        harness.port_modules()
    except ImportError as e:
        log(f"error: cannot import the port: {e!r}")
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, _T_PROCESS,
                              control=args.control, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"error: the run loaded {bad}")
        return 1
    lines = result.pop("_check_lines")
    bad = [k for k, m in result["metrics"].items()
           if not math.isfinite(m["value"])]
    if bad:
        log(f"error: no finite value for {bad} ({result['failed']} of "
            f"{result['attempted']} failed)")
        return 1
    for c in result["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])
    log(f"device {result['device'].get('power_limit')}")
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
