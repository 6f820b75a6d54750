#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits nonzero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds csrc/*.cu from this checkout; ptxas reports each
     kernel's registers, shared memory and spills;
  3. kernel vs plain PyTorch version on the card, at the bench shapes
     (450x375, D=64 -> padded 384x512, L=4, D0=64; 32 pairs x 2
     directions = 64 instances): cost volume (K2) atol 1e-6, pyramid (K3)
     decisions and scores equal, fused (K1) at most 0.5% of decisions
     flipped and scores within atol 2e-5 where decisions agree;
  4. main path: `api.match_stereo` on two synthetic bench pairs against
     the NumPy oracle, the 'fused' route within the bench's 0.5% decision
     gate and the 'exact' route bitwise on decisions; every kernel's
     launch count from this phase must be above 0;
  5. timing with CUDA events: the batched `match_padded_core` step
     (32 pairs, both directions) per route, and peak device memory.
Then one JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.  Needs one CUDA device; imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, MAX_D, BATCH = 375, 450, 64, 32
MAIN_PATH_SEEDS = (100, 101)
FUSED_DECISION_TOL = 0.005


class SmokeFailure(Exception):
    pass


def require(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def make_pair(seed):
    """The bench's synthetic pair recipe (seed 100 + i)."""
    from deepmatching_stereo_matching_tpu.data import synthetic

    rng = np.random.default_rng(seed)
    field = synthetic.block_disparity_field(H, W, MAX_D, rng, block=32)
    return synthetic.make_pair(H, W, field, seed=seed)


def cuda_ms(torch, fn, reps, warmup=1):
    """Per-call device time of fn() in ms: CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    require(ms > 0, f"non-positive timing sample {ms}")
    return ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deepmatching_stereo_matching_tpu.config import Config
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle
    from deepmatching_stereo_matching_tpu.utils import metrics
    from deepmatching_stereo_matching_tpu_torch import api
    from deepmatching_stereo_matching_tpu_torch.models import descriptors
    from deepmatching_stereo_matching_tpu_torch.models import pipeline
    from deepmatching_stereo_matching_tpu_torch.ops import (
        _build, costvol_cuda, fused_cuda, pyramid_cuda)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    card = f"[{card_line}]"
    print(f"device: {name}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line, flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    so = _build.build(force=True)
    print(f"build: {os.path.relpath(so, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                     or "spill" in line):
            print("  " + line.strip())
        elif "bytes stack frame" in line:
            print("  " + line.strip())
    _build.library()
    print(flush=True)

    cfg = Config(max_disparity=MAX_D)
    geom = cfg.geometry(H, W)
    require((geom.levels, geom.padded_height, geom.padded_width,
             geom.disparities) == (4, 384, 512, 64), f"geometry {geom}")
    require(fused_cuda.supported(cfg, geom), "fused kernel must cover the bench")
    pairs = [make_pair(100 + i) for i in range(BATCH)]
    lp = torch.from_numpy(np.stack([api.preprocess(l, cfg, H, W)
                                    for l, _, _ in pairs])).to(dev)
    rp = torch.from_numpy(np.stack([api.preprocess(r, cfg, H, W)
                                    for _, r, _ in pairs])).to(dev)
    lefts = torch.stack([lp, rp.flip(-1)])     # (2, 32, Hp, Wp): 64 instances
    rights = torch.stack([rp, lp.flip(-1)])

    # 3. Kernels vs their plain versions on the card.
    rows = {}
    ds = descriptors.left_descriptors(lefts, cfg)
    dt = descriptors.right_sliding_descriptors(rights, cfg)
    args2 = (geom.disparities, cfg.patch_size, cfg.max_disparity)
    vol = costvol_cuda.cost_volume_dmajor(ds, dt, *args2)
    sync()
    vol_p = costvol_cuda.cost_volume_dmajor_torch(ds, dt, *args2)
    err2 = float((vol - vol_p).abs().max())
    print(f"K2 cost volume {tuple(vol.shape)}: max |kernel - plain| = {err2:.3e}")
    require(err2 <= 1e-6, f"K2 disagrees with its plain version: {err2}")
    rows["K2"] = dict(
        err=err2,
        ms=cuda_ms(torch, lambda: costvol_cuda.cost_volume_dmajor(ds, dt, *args2), 10),
        plain=cuda_ms(torch, lambda: costvol_cuda.cost_volume_dmajor_torch(ds, dt, *args2), 3))
    del vol_p

    d3, s3 = pyramid_cuda.pyramid_backtrack(vol, geom.levels, cfg.lam)
    sync()
    d3p, s3p = pyramid_cuda.pyramid_body(vol, geom.levels, cfg.lam, fast=False)
    flip3 = float((d3 != d3p).float().mean())
    serr3 = float((s3 - s3p).abs().max())
    print(f"K3 pyramid: decision mismatch rate {flip3:.3e}, "
          f"score mismatch rate {float((s3 != s3p).float().mean()):.3e}, "
          f"max |score diff| {serr3:.3e}")
    require(flip3 == 0.0 and serr3 == 0.0, "K3 disagrees with its plain version")
    rows["K3"] = dict(
        err=serr3,
        ms=cuda_ms(torch, lambda: pyramid_cuda.pyramid_backtrack(vol, geom.levels, cfg.lam), 10),
        plain=cuda_ms(torch, lambda: pyramid_cuda.pyramid_body(vol, geom.levels, cfg.lam), 3))
    del vol, ds, dt

    d1, s1 = fused_cuda.match_rows(lefts, rights, cfg, geom)
    sync()
    d1p, s1p = fused_cuda.match_rows_torch(lefts, rights, cfg, geom)
    same = d1 == d1p
    flip1 = float((~same).float().mean())
    serr1 = float((s1 - s1p).abs()[same].max())
    print(f"K1 fused {tuple(lefts.shape)} -> {tuple(d1.shape)}: decisions "
          f"flipped {flip1:.3e}, max |score diff| where equal {serr1:.3e}")
    require(flip1 <= FUSED_DECISION_TOL and serr1 <= 2e-5,
            "K1 disagrees with its plain version")
    rows["K1"] = dict(
        err=serr1,
        ms=cuda_ms(torch, lambda: fused_cuda.match_rows(lefts, rights, cfg, geom), 10),
        plain=cuda_ms(torch, lambda: fused_cuda.match_rows_torch(lefts, rights, cfg, geom), 3))
    for k in ("K1", "K2", "K3"):
        print(f"  {k}: kernel {rows[k]['ms']:.4f} ms, plain "
              f"{rows[k]['plain']:.4f} ms per 64-instance call {card}")
    print(flush=True)

    # 4. Main path through the public API, against the oracle.
    t0 = time.perf_counter()
    want = {s: oracle.match_stereo(*make_pair(s)[:2], cfg)
            for s in MAIN_PATH_SEEDS}
    print(f"oracle on {len(want)} pairs: {time.perf_counter() - t0:.1f} s (host)")
    counters = (fused_cuda.match_rows, costvol_cuda.cost_volume_dmajor,
                pyramid_cuda.pyramid_backtrack)
    for fn in counters:
        fn.launches = 0
    results = {}
    for seed in MAIN_PATH_SEEDS:
        left, right, _ = make_pair(seed)
        for route in ("fused", "exact"):
            results[seed, route] = api.match_stereo(left, right, cfg,
                                                    impl=route, device="cuda")
    sync()
    launches = {"K1": fused_cuda.match_rows.launches,
                "K2": costvol_cuda.cost_volume_dmajor.launches,
                "K3": pyramid_cuda.pyramid_backtrack.launches}
    print(f"launch counts over the main path: {launches}")
    require(all(v > 0 for v in launches.values()),
            "a kernel of the main path was never launched")
    for (seed, route), got in results.items():
        w_ = want[seed]
        gt = make_pair(seed)[2]
        require(got.disparity.shape == (H, W), f"shape {got.disparity.shape}")
        require(np.isfinite(got.score).all(), "non-finite scores")
        require(((got.disparity_raw >= 0)
                 & (got.disparity_raw < geom.disparities)).all(),
                "disparity bin out of range")
        raw_neq = float(np.mean(got.disparity_raw != w_.disparity_raw))
        val_neq = float(np.mean(got.valid != w_.valid))
        bad_g = metrics.bad_pixel_rate(got.disparity, gt, count_invalid=False)
        bad_o = metrics.bad_pixel_rate(w_.disparity, gt, count_invalid=False)
        print(f"main path [{route}] pair {seed}: raw_neq={raw_neq:.3e} "
              f"valid_neq={val_neq:.3e} bad_gpu={bad_g:.4f} "
              f"bad_oracle={bad_o:.4f} coverage={metrics.coverage(got.disparity):.4f}")
        if route == "fused":
            require(raw_neq <= FUSED_DECISION_TOL
                    and val_neq <= FUSED_DECISION_TOL
                    and abs(bad_g - bad_o) <= FUSED_DECISION_TOL,
                    f"fused route beyond the decision gate on pair {seed}")
        else:
            require(raw_neq == 0.0 and val_neq == 0.0
                    and np.array_equal(got.disparity, w_.disparity,
                                       equal_nan=True)
                    and np.array_equal(got.disparity_right,
                                       w_.disparity_right)
                    and np.allclose(got.score, w_.score, rtol=1e-5),
                    f"exact route not bitwise on decisions on pair {seed}")
    print(flush=True)

    # 5. Timing of the batched step.
    torch.cuda.reset_peak_memory_stats()
    step_ms = {}
    for route in ("fused", "exact"):
        def step(route=route):
            return pipeline.match_padded_core(lp, rp, cfg, geom, route)
        step()
        sync()
        samples = [cuda_ms(torch, step, 1, warmup=0) for _ in range(7)]
        med = float(np.median(samples))
        step_ms[route] = med
        print(f"step [{route}] {BATCH} pairs: median {med:.4f} ms "
              f"[{min(samples):.4f}..{max(samples):.4f}] over 7 samples = "
              f"{BATCH * H * W * 1e-6 / (med * 1e-3):.1f} Mpx/s {card}")
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory over the timed steps: {peak / 2**20:.1f} MiB {card}")
    print(f"K1 alone: {rows['K1']['ms']:.4f} ms, plain K1 "
          f"{rows['K1']['plain']:.4f} ms (64 instances) {card}")
    require("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": "K1 fused image->disparity", "route": "cuda",
         "source": "deepmatching_stereo_matching_tpu_torch/csrc/fused.cu",
         "replaces": "deepmatching_stereo_matching_tpu/ops/fused_pallas.py:572",
         "launches": launches["K1"], "max_abs_err": rows["K1"]["err"],
         "ms": rows["K1"]["ms"], "plain_ms": rows["K1"]["plain"]},
        {"name": "K2 D-major cost volume", "route": "cuda",
         "source": "deepmatching_stereo_matching_tpu_torch/csrc/costvol.cu",
         "replaces": "deepmatching_stereo_matching_tpu/ops/costvol_pallas.py:86",
         "launches": launches["K2"], "max_abs_err": rows["K2"]["err"],
         "ms": rows["K2"]["ms"], "plain_ms": rows["K2"]["plain"]},
        {"name": "K3 pyramid + backtracking", "route": "cuda",
         "source": "deepmatching_stereo_matching_tpu_torch/csrc/pyramid.cu",
         "replaces": "deepmatching_stereo_matching_tpu/ops/pyramid_pallas.py:257",
         "launches": launches["K3"], "max_abs_err": rows["K3"]["err"],
         "ms": rows["K3"]["ms"], "plain_ms": rows["K3"]["plain"]},
    ]
    print(json.dumps({"kernels": kernels, "step_ms": step_ms,
                      "peak_bytes": peak, "card": card_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
