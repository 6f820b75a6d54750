"""Command-line entry point: one stereo pair through the port on the card.

Counterpart of the JAX package's `cli.py`, with the same flags and the
same metrics JSON keys, except:
  * `--impl fused|exact|torch` (default fused), the port's routes;
  * the pipeline runs on the card; `--cpu` is the only way to run off it,
    and without a card and without `--cpu` the CLI exits 2;
  * `--profile DIR` writes a torch.profiler chrome trace;
  * `--debug-checks` checks the pipeline's invariants on the device
    (utils/checks.py) on the chosen route;
  * `--dtype bfloat16` runs on every route, with the JAX package's
    semantics (models/pipeline.py);
  * `--dot-precision` is accepted and recorded in the config, and changes
    nothing: it picks the TPU kernel's selection-matmul scheme, which the
    CUDA kernels do not have;
  * `--center-descriptors` sets `Config.center_descriptors`: each patch
    descriptor centred on its mean before the L2 norm, so that matching
    is zero-mean normalised cross-correlation (ZNCC), for views that
    differ in gain and offset; it takes the 'exact' route on every
    `--impl` but 'torch';
  * `engine` in the metrics names the torch device ("cuda:0", "cpu"), or
    "oracle".
`--oracle` runs the port's copy of the NumPy oracle.  Outputs go through
io/writers.py.

Usage:
  python -m deepmatching_stereo_matching_tpu_torch.cli LEFT RIGHT [options]
  python -m deepmatching_stereo_matching_tpu_torch.cli --demo [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepmatching_stereo_matching_tpu_torch",
        description="DeepMatching dense stereo matching on an NVIDIA GPU")
    p.add_argument("left", nargs="?", help="left (reference) image path")
    p.add_argument("right", nargs="?", help="right (target) image path")
    p.add_argument("--demo", action="store_true",
                   help="run on a synthetic pair with known ground truth")
    p.add_argument("--demo-size", type=int, nargs=2, default=(375, 450),
                   metavar=("H", "W"), help="synthetic pair size")
    p.add_argument("--gt", help="ground-truth disparity (.pfm or 16-bit "
                                ".png, KITTI convention) for evaluation")
    p.add_argument("--output", "-o", help="output directory for disparity "
                                          "maps + metrics JSON")
    p.add_argument("--oracle", action="store_true",
                   help="run the NumPy golden oracle instead of the "
                        "device pipeline")
    p.add_argument("--impl", choices=("fused", "exact", "torch"),
                   default="fused", help="matching route (ops/_dispatch.py)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--debug-checks", action="store_true",
                   help="check the pipeline's invariants on the device "
                        "(utils/checks.py)")
    p.add_argument("--profile",
                   help="write a torch.profiler chrome trace to this "
                        "directory")
    p.add_argument("--max-disparity", "-D", type=int, default=64)
    p.add_argument("--patch-size", type=int, default=4)
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--lam", type=float, default=1.4,
                   help="power-rectification exponent [DM 3.2]")
    p.add_argument("--tau", type=float, default=1.0,
                   help="LR consistency threshold (px)")
    p.add_argument("--descriptor", choices=("patch", "grad_hist"),
                   default="patch")
    p.add_argument("--center-descriptors", action="store_true",
                   help="centre each patch descriptor on its mean before "
                        "normalising it (ZNCC matching)")
    p.add_argument("--no-lr-check", action="store_true")
    p.add_argument("--lr-mode", choices=("flip", "direct"), default="flip")
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--median", type=int, default=0,
                   help="median post-filter window (odd; 0=off)")
    p.add_argument("--fill", action="store_true",
                   help="background-fill invalidated pixels")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="cost-volume/pyramid compute dtype")
    p.add_argument("--dot-precision",
                   choices=("split2", "split3", "highest"),
                   default="split2",
                   help="accepted for the JAX CLI's command lines and "
                        "ignored: the CUDA kernels have no selection "
                        "matmuls")
    return p


def config_from_args(args) -> "Config":
    from .config import Config

    return Config(
        max_disparity=args.max_disparity,
        patch_size=args.patch_size,
        levels=args.levels,
        lam=args.lam,
        tau=args.tau,
        descriptor=args.descriptor,
        center_descriptors=args.center_descriptors,
        lr_check=not args.no_lr_check,
        lr_mode=args.lr_mode,
        min_score=args.min_score,
        median_filter=args.median,
        fill_invalid=args.fill,
        dtype=args.dtype,
        fused_dot_precision=args.dot_precision,
    )


def load_gt(path: str) -> np.ndarray:
    from .io import writers

    if path.endswith(".pfm"):
        gt = writers.read_pfm(path)
        gt[~np.isfinite(gt)] = -1.0
        return gt
    gt = writers.read_disparity_png16(path)
    gt[~np.isfinite(gt)] = -1.0
    return gt


def main(argv=None) -> int:
    import torch

    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False); "
              "pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    cfg = config_from_args(args)

    if args.demo:
        from .data import synthetic

        h, w = args.demo_size
        rng = np.random.default_rng(0)
        field = synthetic.block_disparity_field(
            h, w, args.max_disparity, rng, block=32,
            align=args.patch_size)
        left, right, gt = synthetic.make_pair(h, w, field, seed=0)
    elif args.left and args.right:
        from .io import images

        left, right = images.load_pair(args.left, args.right)
        gt = load_gt(args.gt) if args.gt else None
    else:
        print("error: give LEFT and RIGHT image paths, or --demo",
              file=sys.stderr)
        return 2

    run_meta = {
        "config": dataclasses.asdict(cfg),
        "shape": list(left.shape[:2]),
        "engine": "oracle" if args.oracle else str(device),
    }

    def run():
        if args.oracle:
            from .oracle import reference as oracle

            return oracle.match_stereo(left, right, cfg)
        from . import api

        run_meta["impl"] = args.impl
        return api.match_stereo(left, right, cfg, impl=args.impl,
                                device=device,
                                debug_checks=args.debug_checks)

    if not args.oracle and device.type == "cuda":
        # Build the kernels before timing: nvcc runs at first use.
        from .ops import _build

        _build.library()
    t0 = time.perf_counter()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            res = run()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        res = run()
    dt = time.perf_counter() - t0
    h, w = left.shape[:2]
    run_meta["seconds"] = round(dt, 4)
    run_meta["mpx_per_s"] = round(h * w * 1e-6 / dt, 4)

    from .utils import metrics

    run_meta["coverage"] = round(metrics.coverage(res.disparity), 4)
    if gt is not None:
        run_meta["bad_pixel_rate_all"] = round(
            metrics.bad_pixel_rate(res.disparity, gt), 4)
        run_meta["bad_pixel_rate_kept"] = round(
            metrics.bad_pixel_rate(res.disparity, gt,
                                   count_invalid=False), 4)
        run_meta["epe_kept"] = round(
            metrics.end_point_error(res.disparity, gt), 4)

    if args.output:
        from .io import writers

        os.makedirs(args.output, exist_ok=True)
        out = args.output
        writers.write_pfm(os.path.join(out, "disparity.pfm"),
                          np.nan_to_num(res.disparity, nan=np.inf,
                                        posinf=np.inf))
        writers.write_disparity_png16(
            os.path.join(out, "disparity_16bit.png"), res.disparity)
        writers.write_disparity_color(
            os.path.join(out, "disparity_color.png"), res.disparity,
            vmax=float(cfg.max_disparity))
        writers.write_valid_mask(os.path.join(out, "valid.png"), res.valid)
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(run_meta, f, indent=1)
        run_meta["output"] = out

    print(json.dumps(run_meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
