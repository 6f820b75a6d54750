"""Where the time goes in the port's batched steps, on one CUDA device.

    python -m deepmatching_stereo_matching_tpu_torch.profile_steps \
        [--cells bench,grad_hist,kitti128,kitti256] [--routes fused,exact] \
        [--steps 5] [--strategies tiled,dslab,ringd,wtiled,wtiled1]
    python deepmatching_stereo_matching_tpu_torch/profile_steps.py --k1 \
        [--root CHECKOUT]

Cells (synthetic pairs made from seeds, `lr_mode="flip"`): bench
(450x375, D=64, 32 pairs, bench.py's recipe), grad_hist (the same with
grad_hist descriptors), kitti128 and kitti256 (1242x375 at D=128 x 8
pairs and D=256 x 4 pairs, tools/bench_large.py's recipe).

For each cell and route, `--steps` calls of `match_padded_core` run once
unprofiled and once under torch.profiler; with `--strategies`, so do
`parallel.match_batch_sharded` calls of each named sharded strategy on a
world of one rank over NCCL (tiled on 'fused', the others on 'exact';
wtiled1 is wtiled with merge_level 1).  Of the profiled steps it
prints, per step:
  span: device time from a CUDA event recorded before the first step to
      one recorded after the last;
  kernels: the sum of the profiler's device rows (an aten:: row repeats
      its kernels' time and is skipped);
  idle: 1 - kernels / span, as it falls: a negative share means the two
      clocks disagree, and is printed, not clamped;
  enqueue: host time to issue the steps;
then the top device rows and the top host ops by self CPU time.  The
profiler adds host time to every op, so where the host is the bound the
profiled span is longer than the unprofiled one, which is printed beside
it.

--k1 times K1 and K1b alone at the bench shapes (CUDA events, 5 x 20
launches each, after a forced build) from the port package under --root
(default: this checkout).  Run as a file, once per checkout in one call
(parent, change, change, parent), it compares two trees on the same card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

CELLS = {  # name -> (height, width, max_disparity, descriptor, pairs, block, seed0)
    "bench": (375, 450, 64, "patch", 32, 32, 100),
    "grad_hist": (375, 450, 64, "grad_hist", 32, 32, 100),
    "kitti128": (375, 1242, 128, "patch", 8, 48, 0),
    "kitti256": (375, 1242, 256, "patch", 4, 48, 0),
}
STRATEGIES = {  # name -> (strategy, route, merge_level)
    "tiled": ("tiled", "fused", None),
    "dslab": ("dslab", "exact", None),
    "ringd": ("ringd", "exact", None),
    "wtiled": ("wtiled", "exact", None),
    "wtiled1": ("wtiled", "exact", 1),
}


def _padded_pairs(cell):
    """(cfg, geom, left, right): the cell's padded pairs on the card."""
    import torch
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.data import synthetic
    from deepmatching_stereo_matching_tpu_torch import api

    h, w, max_d, desc, n, block, seed0 = CELLS[cell]
    cfg = Config(max_disparity=max_d, descriptor=desc)
    lefts, rights = [], []
    for s in range(seed0, seed0 + n):
        field = synthetic.block_disparity_field(
            h, w, max_d, np.random.default_rng(s), block=block)
        left, right, _ = synthetic.make_pair(h, w, field, seed=s)
        lefts.append(api.preprocess(left, cfg, h, w))
        rights.append(api.preprocess(right, cfg, h, w))
    return (cfg, cfg.geometry(h, w),
            torch.from_numpy(np.stack(lefts)).cuda(),
            torch.from_numpy(np.stack(rights)).cuda())


def _strategy_steps(cfg, geom, lp, rp, names):
    """(label, step) for each named strategy on the one-rank world."""
    if not names:       # no process group to build meshes on
        return
    from deepmatching_stereo_matching_tpu_torch.parallel import (
        mesh as mesh_lib, sharded)

    meshes = {2: mesh_lib.make_mesh(1, 1), 3: mesh_lib.make_mesh2d(1, 1, 1)}
    for name in names:
        strategy, route, ml = STRATEGIES[name]
        mesh = meshes[3 if strategy == "wtiled" else 2]
        glob = sharded.strategy_geometry(cfg, geom.height, geom.width, mesh,
                                         strategy, ml)
        if (glob.padded_height, glob.padded_width, glob.disparities) != (
                geom.padded_height, geom.padded_width, geom.disparities):
            raise ValueError(f"{name} pads this cell differently: {glob}")

        def step(strategy=strategy, route=route, ml=ml, mesh=mesh):
            return sharded.match_batch_sharded(
                lp, rp, cfg, geom.height, geom.width, mesh, strategy, route,
                ml)
        yield f"{name} [{route}]", step


def profile_cells(cells, routes, steps, strategies=()):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepmatching_stereo_matching_tpu_torch.models import pipeline

    def timed(fn):
        """(device span ms, host enqueue ms) per step of `steps` calls."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps, enqueue * 1e3 / steps

    for cell in cells:
        cfg, geom, lp, rp = _padded_pairs(cell)
        todo = [(f"[{route}]",
                 lambda route=route: pipeline.match_padded_core(
                     lp, rp, cfg, geom, route)) for route in routes]
        todo += list(_strategy_steps(cfg, geom, lp, rp, strategies))
        for label, step in todo:
            for _ in range(3):
                step()
            plain_span, plain_enq = timed(step)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                span, enq = timed(step)
            rows = prof.key_averages()
            dev = sorted(((e.self_device_time_total / steps / 1e3,
                           e.count // steps, e.key) for e in rows
                          if e.self_device_time_total > 0
                          and not e.key.startswith("aten::")), reverse=True)
            host = sorted(((e.self_cpu_time_total / steps / 1e3,
                            e.count // steps, e.key) for e in rows
                           if e.self_cpu_time_total > 0), reverse=True)
            kernels = sum(ms for ms, _, _ in dev)
            print(f"\n== {cell} {label} {lp.shape[0]} pairs, per step over "
                  f"{steps} profiled steps: span {span:.4f} ms, kernels "
                  f"{kernels:.4f} ms, idle {1 - kernels / span:+.4f}, "
                  f"enqueue {enq:.4f} ms; unprofiled: span "
                  f"{plain_span:.4f} ms, enqueue {plain_enq:.4f} ms")
            for ms, count, key in dev[:10]:
                print(f"   device {ms:9.4f} ms {100 * ms / kernels:5.1f}% "
                      f"x{count:<3d} {key[:80]}")
            for ms, count, key in host[:8]:
                print(f"   host   {ms:9.4f} ms x{count:<3d} {key[:80]}")
            sys.stdout.flush()


def time_k1():
    import torch

    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.models import descriptors
    from deepmatching_stereo_matching_tpu_torch.ops import _build, fused_cuda

    _build.build(force=True)
    cfg, geom, lp, rp = _padded_pairs("bench")
    lefts, rights = torch.stack([lp, rp.flip(-1)]), torch.stack([rp, lp.flip(-1)])
    gh = Config(max_disparity=cfg.max_disparity, descriptor="grad_hist")
    (lm, lb), (rm, rb) = map(descriptors.grad_hist_magbin, (lefts, rights))
    runs = {"K1": lambda: fused_cuda.match_planes(lefts, rights, cfg, geom),
            "K1b": lambda: fused_cuda.match_planes(lm, rm, gh, geom, lb, rb)}
    for name, fn in runs.items():
        ms = _median_launch_ms(torch, fn)
        print(f"{name} {_build.SRC_DIR}: ms per 64-instance call, 5 x 20 "
              f"launches: " + " ".join(f"{x:.4f}" for x in ms)
              + f"; median {float(np.median(ms)):.4f}", flush=True)


def _median_launch_ms(torch, fn):
    """Five samples of the mean time of 20 calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / 20)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--routes", default="fused,exact")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--strategies", default="",
                    help=f"sharded strategies to profile too, of "
                         f"{','.join(STRATEGIES)}")
    ap.add_argument("--k1", action="store_true",
                    help="time K1 and K1b alone at the bench shapes")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="checkout whose port package --k1 times")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import deepmatching_stereo_matching_tpu_torch as pkg

    if not torch.cuda.is_available():
        print("profile_steps: needs a CUDA device", file=sys.stderr)
        return 2
    if not Path(pkg.__file__).resolve().is_relative_to(root):
        print(f"profile_steps: the port package came from {pkg.__file__}, "
              f"not {root}: run this file as a script", file=sys.stderr)
        return 2
    if args.k1:
        time_k1()
        return 0
    cells = args.cells.split(",")
    routes = [r for r in args.routes.split(",") if r]
    strategies = [s for s in args.strategies.split(",") if s]
    if not strategies:
        profile_cells(cells, routes, args.steps)
        return 0
    import tempfile

    import torch.distributed as dist

    from deepmatching_stereo_matching_tpu_torch.parallel import launch

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as rdzv:
        launch.init("nccl", 0, 1, str(Path(rdzv) / "rendezvous"))
        try:
            profile_cells(cells, routes, args.steps, strategies)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
