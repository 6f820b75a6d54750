"""The bench: full-pipeline Mpx/s on one card against the CPU oracle.

    python -m deepmatching_stereo_matching_tpu_torch.bench [--cpu]

Counterpart of the JAX package's root `bench.py`: the same rows in the
same order, at the same geometry (450x375, D=64, the bench pairs of
seeds 100 + i), with the same gates.  Stdout carries exactly one JSON
line,

  {"metric": "full_pipeline_throughput_per_chip", "value": Mpx/s,
   "unit": "Mpx/s", "vs_baseline": value / the oracle's Mpx/s,
   "range": [min, max] Mpx/s, "device": "<nvidia-smi name, power limit>"}

and every diagnostic goes to stderr.  The rows:

  * `oracle_mpxs`: the port's copy of the NumPy oracle, timed on pair 0
    on this host's CPU: the denominator of `vs_baseline`.  The cached
    value of the repo's ORACLE_BASELINE.json was measured on another
    host; it is printed beside it, labelled so, and never rewritten;
  * `step_mpxs`: the batched `pipeline.match_padded_core` step on the
    'fused' route (K1), batch 32, inputs padded and on the device before
    the timed window; `utils.timing.steady_state` (CUDA events, a sample
    covers >= 10 ms) reports the median and the range, which is the
    result of a host-bound step; the kept-pixel bad rate of every pair;
  * `parity_gate`: 'exact' (K2 -> K3) bitwise the oracle on 4 pairs
    (disparity_raw, valid, disparity with NaN, disparity_right; score
    rtol 1e-5); 'fused' within 0.005 of it on raw, valid and the kept
    bad rate;
  * `sharded_smoke`: a world of one rank (NCCL on the card, gloo with
    --cpu); tiled ('fused'), wtiled(1), dslab and ringd ('exact') at
    96x128, D=16, levels 2, each equal to the unsharded pipeline on
    every key (scores rtol 1e-5, atol 1e-6); then each strategy timed at
    the bench geometry, batch 8;
  * `bf16_mpxs`, `grad_hist_mpxs`: the 'fused' step in bfloat16 (K1
    bf16) and with grad_hist descriptors (K1b), timed, with the mean kept
    bad rate; bf16 also prints its kept bad rate minus the oracle's and
    its agreement with the float32 step;
  * `adversarial_row`: 240x360, D=64, seeds 0-1, 'exact': decisions and
    validity off the oracle <= 0.01 per seed, occlusion rejection >= 0.6,
    kept non-occluded bad rate <= 0.15;
  * `native_io_row`: the native prefetch loader against the Python decode
    of RGB PPMs at the bench size, serially and behind a 5 ms consumer.

Each row is a function with keyword parameters whose defaults are the
constants below, returning (row dict, list of gate failures); `main`
runs them all and exits 1 if any gate failed, 0 otherwise.  Without a
card and without --cpu it exits 2; --cpu runs the kernels' plain
versions.  A kernel that fails to build or launch raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .data import synthetic
from .models import pipeline
from .oracle import reference as oracle
from .utils import metrics, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_FILE = os.path.join(REPO, "ORACLE_BASELINE.json")

H, W, MAX_D = 375, 450, 64
BATCH = 32
PARITY_PAIRS = 4
FUSED_DECISION_TOL = 0.005
REPEATS = 5
MIN_SAMPLE_S = 0.010          # each timing sample covers at least this
SMOKE_HW, SMOKE_D, SMOKE_LEVELS = (96, 128), 16, 2
SHARDED_BATCH = 8
ADV_HW, ADV_SEEDS = (240, 360), (0, 1)
ADV_MAX_NEQ, ADV_MIN_REJECTION, ADV_MAX_KEPT_BAD = 0.01, 0.6, 0.15
Row = Tuple[Dict[str, object], List[str]]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_config(max_d: int = MAX_D, **kw) -> Config:
    return Config(max_disparity=max_d, **kw)


def make_pairs(n: int, height: int = H, width: int = W,
               max_d: int = MAX_D) -> List[Tuple[np.ndarray, ...]]:
    """The bench pairs: (left, right, gt) of seeds 100 .. 100 + n - 1."""
    pairs = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        field = synthetic.block_disparity_field(height, width, max_d, rng,
                                                block=32)
        pairs.append(synthetic.make_pair(height, width, field, seed=100 + i))
    return pairs


def oracle_host() -> str:
    """The host the oracle runs on: its name, machine, numpy version and
    whether numpy may take AVX-512 loops (SVML's float32 power, which
    rounds differently from other hosts')."""
    try:
        from numpy._core._multiarray_umath import __cpu_features__ as feats
    except ImportError:
        from numpy.core._multiarray_umath import __cpu_features__ as feats
    return (f"{platform.node()} ({platform.machine()}, numpy "
            f"{np.__version__}, AVX512F {bool(feats.get('AVX512F'))})")


def device_label(device: torch.device) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, or
    'cpu'."""
    if device.type != "cuda":
        return "cpu"
    if shutil.which("nvidia-smi") is None:
        return torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def padded_batch(images: Sequence[np.ndarray], cfg: Config, height: int,
                 width: int, device: torch.device) -> torch.Tensor:
    """Grayscale-normalised, zero-padded (B, Hp, Wp) images on `device`."""
    geom = cfg.geometry(height, width)
    return torch.from_numpy(np.stack([
        oracle.pad_image(oracle.to_grayscale_f32(x), geom)
        for x in images])).to(device)


def timed(fn, args: Sequence, device: torch.device,
          repeats: int = REPEATS) -> Dict[str, object]:
    """`timing.steady_state` of fn(*args), with `reps` chosen after a
    warm-up so that each sample covers at least MIN_SAMPLE_S."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    fn(*args)
    _sync(device)
    one = time.perf_counter() - t0
    reps = max(1, math.ceil(MIN_SAMPLE_S / max(one, 1e-9)))
    return timing.steady_state(fn, args, reps=reps, repeats=repeats,
                               device=device)


def _kept_bad(disparity, gt) -> float:
    return metrics.bad_pixel_rate(disparity, gt, count_invalid=False)


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


def match_batch(pairs, cfg: Config, device: torch.device,
                route: str = "fused") -> Dict[str, np.ndarray]:
    """The batched step's cropped outputs on the host."""
    h, w = pairs[0][0].shape[:2]
    lp, rp = (padded_batch([p[i] for p in pairs], cfg, h, w, device)
              for i in (0, 1))
    return _host(pipeline.crop(pipeline.match_padded_core(
        lp, rp, cfg, cfg.geometry(h, w), route), h, w))


def match_pair(left, right, cfg: Config, device: torch.device,
               route: str) -> Dict[str, np.ndarray]:
    """`pipeline.match_padded` on one pair; host outputs."""
    h, w = left.shape[:2]
    lp, rp = (padded_batch([x], cfg, h, w, device)[0] for x in (left, right))
    return _host(pipeline.match_padded(lp, rp, cfg, h, w, route))


def _throughput(label: str, pairs, cfg: Config, device: torch.device,
                route: str, repeats: int
                ) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """Time the batched padded step; returns its row and the first call's
    cropped host outputs."""
    n, (h, w) = len(pairs), pairs[0][0].shape[:2]
    geom = cfg.geometry(h, w)
    lp, rp = (padded_batch([p[i] for p in pairs], cfg, h, w, device)
              for i in (0, 1))

    def step(a, b):
        return pipeline.match_padded_core(a, b, cfg, geom, route)

    t0 = time.perf_counter()
    out = _host(pipeline.crop(step(lp, rp), h, w))
    first_s = time.perf_counter() - t0
    stats = timed(step, (lp, rp), device, repeats)
    mpx = n * h * w * 1e-6
    rates = [_kept_bad(out["disparity"][i], pairs[i][2]) for i in range(n)]
    row = {"route": route, "batch": n, "height": h, "width": w,
           "max_disparity": cfg.max_disparity, "dtype": cfg.dtype,
           "descriptor": cfg.descriptor,
           "mpx_per_s": mpx / stats["median"],
           "range_mpx_per_s": [mpx / stats["max"], mpx / stats["min"]],
           "timing": {k: stats[k] for k in ("median", "min", "max",
                                            "samples", "reps", "repeats")},
           "first_call_s": first_s, "kept_bad_rates": rates,
           "mean_kept_bad": float(np.mean(rates))}
    log(f"{label}: median {stats['median'] * 1e3:.4f} ms [{stats['min'] * 1e3:.4f}"
        f"..{stats['max'] * 1e3:.4f}] per step ({stats['repeats']} samples "
        f"of {stats['reps']} steps) for {n} pairs {w}x{h} = "
        f"{row['mpx_per_s']:.1f} Mpx/s [{row['range_mpx_per_s'][0]:.1f}.."
        f"{row['range_mpx_per_s'][1]:.1f}] (route {route}); first call "
        f"{first_s:.3f} s; mean kept-pixel bad rate "
        f"{row['mean_kept_bad']:.4f}")
    return row, out


# ---------------------------------------------------------------------------
# The rows, in the reference's order
# ---------------------------------------------------------------------------


def _cached_oracle(height: int, width: int, max_d: int):
    """ORACLE_BASELINE.json's Mpx/s if it holds this geometry (another
    host's measurement), else None."""
    key = {"height": height, "width": width, "max_disparity": max_d,
           "lr_check": True, "descriptor": "patch"}
    if not os.path.exists(ORACLE_FILE):
        return None
    with open(ORACLE_FILE) as f:
        data = json.load(f)
    return data["mpx_per_s"] if data.get("config") == key else None


def oracle_mpxs(pairs, *, max_d: int = MAX_D) -> Row:
    """The oracle's Mpx/s on pair 0, on this host's CPU."""
    left, right, _ = pairs[0]
    h, w = left.shape[:2]
    t0 = time.perf_counter()
    oracle.match_stereo(left, right, bench_config(max_d))
    dt = time.perf_counter() - t0
    row = {"mpx_per_s": h * w * 1e-6 / dt, "seconds_per_pair": dt,
           "host": oracle_host(),
           "cached_mpx_per_s": _cached_oracle(h, w, max_d)}
    log(f"oracle baseline (measured on this host, {row['host']}): "
        f"{row['mpx_per_s']:.4f} Mpx/s ({dt:.2f} s/pair)")
    if row["cached_mpx_per_s"] is not None:
        log(f"oracle baseline cached in ORACLE_BASELINE.json (another "
            f"host's, not used): {row['cached_mpx_per_s']:.4f} Mpx/s")
    return row, []


def step_mpxs(pairs, device: torch.device, *, max_d: int = MAX_D,
              batch: int = BATCH, repeats: int = REPEATS) -> Row:
    """The headline: the batched 'fused' step at the bench geometry."""
    row, _ = _throughput("device step", pairs[:batch], bench_config(max_d),
                         device, "fused", repeats)
    log(f"kept-pixel bad rates: {[f'{r:.4f}' for r in row['kept_bad_rates']]}")
    return row, []


def parity_check(route: str, got: Dict[str, np.ndarray], want, gt
                 ) -> Tuple[Dict[str, object], List[str]]:
    """One pair's outputs on `route` against the oracle's: 'exact' must be
    bitwise on decisions, validity, disparity (NaN-equal) and
    disparity_right, scores rtol 1e-5; any other route within
    FUSED_DECISION_TOL on raw, valid and the kept bad rate.  Returns the
    pair's numbers and what failed."""
    raw_neq = float(np.mean(got["disparity_raw"] != want.disparity_raw))
    val_neq = float(np.mean(got["valid"] != want.valid))
    bad, bad_ora = _kept_bad(got["disparity"], gt), _kept_bad(want.disparity, gt)
    rec = {"raw_neq": raw_neq, "val_neq": val_neq, "kept_bad": bad,
           "oracle_kept_bad": bad_ora}
    fails = []
    if route == "exact":
        rec["right_neq"] = float(np.mean(got["disparity_right"]
                                         != want.disparity_right))
        rec["disparity_equal"] = bool(np.array_equal(
            got["disparity"], want.disparity, equal_nan=True))
        rec["score_close"] = bool(np.allclose(got["score"], want.score,
                                              rtol=1e-5))
        for key in ("raw_neq", "val_neq", "right_neq"):
            if rec[key]:
                fails.append(f"{key} {rec[key]:.3e}")
        if not rec["disparity_equal"]:
            fails.append("disparity differs")
        if not rec["score_close"]:
            fails.append("score beyond rtol 1e-5")
    else:
        for key, v in (("raw_neq", raw_neq), ("val_neq", val_neq),
                       ("kept bad delta", bad - bad_ora)):
            if abs(v) > FUSED_DECISION_TOL:
                fails.append(f"{key} {v:+.4f} beyond {FUSED_DECISION_TOL}")
    return rec, fails


def parity_gate(pairs, want, device: torch.device, *, max_d: int = MAX_D,
                levels=None, routes: Sequence[str] = ("exact", "fused")
                ) -> Row:
    """Each route's outputs on the first len(want) pairs against the
    oracle's `want` (`parity_check`)."""
    cfg = bench_config(max_d, levels=levels)
    row: Dict[str, object] = {"pairs": len(want), "oracle_host": oracle_host()}
    failures = []
    for route in routes:
        recs = []
        for i, ((left, right, gt), w_) in enumerate(zip(pairs, want)):
            rec, fails = parity_check(
                route, match_pair(left, right, cfg, device, route), w_, gt)
            recs.append(rec)
            log(f"parity[{route}] pair {i}: raw_neq={rec['raw_neq']:.2e} "
                f"valid_neq={rec['val_neq']:.2e} bad={rec['kept_bad']:.4f} "
                f"bad_oracle={rec['oracle_kept_bad']:.4f} delta="
                f"{rec['kept_bad'] - rec['oracle_kept_bad']:+.4f}"
                + (f" right_neq={rec['right_neq']:.2e} disparity_equal="
                   f"{rec['disparity_equal']} score_close="
                   f"{rec['score_close']}" if route == "exact" else ""))
            failures += [f"parity {route} pair {i}: {f}" for f in fails]
        row[route] = recs
    log(f"parity gate ({row['oracle_host']}'s oracle): "
        + ("PASS" if not failures else f"{len(failures)} failures"))
    return row, failures


def _smoke_pair():
    h, w = SMOKE_HW
    rng = np.random.default_rng(3)
    field = synthetic.block_disparity_field(h, w, SMOKE_D, rng, block=24)
    return synthetic.make_pair(h, w, field, seed=3)[:2]


def _sharded_rows(device: torch.device, height: int, width: int,
                  max_d: int, batch: int, repeats: int) -> Row:
    from .parallel import mesh as mesh_lib
    from .parallel import sharded

    meshes = {2: mesh_lib.make_mesh(1, 1), 3: mesh_lib.make_mesh2d(1, 1, 1)}
    # (strategy, mesh rank, merge_level, route, the unsharded reference's
    # route): dslab and ringd are held to the plain 'torch' pipeline (the
    # reference's 'jnp'), the others to their own route.
    cases = (("tiled", 2, None, "fused", "fused"),
             ("wtiled", 3, 1, "exact", "exact"),
             ("dslab", 2, None, "exact", "torch"),
             ("ringd", 2, None, "exact", "torch"))
    h, w = SMOKE_HW
    cfg = Config(max_disparity=SMOKE_D, levels=SMOKE_LEVELS)
    left, right = _smoke_pair()
    row: Dict[str, object] = {"cases": {}, "timed": {}}
    failures = []
    for strategy, m, ml, route, ref_route in cases:
        mesh = meshes[m]
        lp, rp = (sharded.pad_batch([x], cfg, h, w, mesh, strategy, ml)
                  for x in (left, right))
        out = _host(sharded.match_batch_sharded(lp, rp, cfg, h, w, mesh,
                                                strategy, route, ml))
        ref = match_pair(left, right, cfg, device, ref_route)
        differ = []
        for k, b in ref.items():
            a = out[k][0]
            ok = (np.allclose(a, b, rtol=1e-5, atol=1e-6) if k == "score"
                  else np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
            if not ok:
                differ.append(k)
        row["cases"][strategy] = {"route": route, "reference": ref_route,
                                  "differ": differ}
        log(f"sharded smoke [{strategy}]: one rank, route {route} vs "
            f"unsharded {ref_route}: "
            + ("every key equal" if not differ else f"{differ} differ"))
        failures += [f"sharded smoke {strategy}: {k} != unsharded"
                     for k in differ]

    bcfg = bench_config(max_d)
    rng = np.random.default_rng(11)
    field = synthetic.block_disparity_field(height, width, max_d, rng,
                                            block=32)
    bl, br, _ = synthetic.make_pair(height, width, field, seed=11)
    for strategy, m, ml, route, _ in cases:
        mesh = meshes[m]
        lp, rp = (torch.from_numpy(sharded.pad_batch(
            [x] * batch, bcfg, height, width, mesh, strategy, ml)).to(device)
            for x in (bl, br))

        def stepf(a, b, _s=strategy, _m=mesh, _ml=ml, _r=route):
            return sharded.match_batch_sharded(a, b, bcfg, height, width, _m,
                                               _s, _r, _ml)

        st = timed(stepf, (lp, rp), device, repeats)
        mpx = batch * height * width * 1e-6
        rec = {"route": route, "batch": batch, "median_ms": st["median"] * 1e3,
               "min_ms": st["min"] * 1e3, "max_ms": st["max"] * 1e3,
               "mpx_per_s": mpx / st["median"],
               "range_mpx_per_s": [mpx / st["max"], mpx / st["min"]]}
        row["timed"][strategy] = rec
        log(f"sharded perf [{strategy}] one rank, batch {batch}: median "
            f"{rec['median_ms']:.4f} ms [{rec['min_ms']:.4f}.."
            f"{rec['max_ms']:.4f}] = {rec['mpx_per_s']:.1f} Mpx/s "
            f"[{rec['range_mpx_per_s'][0]:.1f}..{rec['range_mpx_per_s'][1]:.1f}]"
            f" (route {route})")
    return row, failures


def sharded_smoke(device: torch.device, *, height: int = H, width: int = W,
                  max_d: int = MAX_D, batch: int = SHARDED_BATCH,
                  repeats: int = REPEATS) -> Row:
    """The four strategies on a world of one rank, against the unsharded
    pipeline at 96x128, then timed at (height, width, max_d) x batch.
    The world (NCCL on a CUDA device, gloo on the CPU) is made here and
    destroyed before returning."""
    import torch.distributed as dist

    from .parallel import launch

    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        launch.init(backend, 0, 1, os.path.join(tmp, "rendezvous"))
        try:
            return _sharded_rows(device, height, width, max_d, batch,
                                 repeats)
        finally:
            dist.destroy_process_group()


def bf16_mpxs(pairs, want, device: torch.device, *, max_d: int = MAX_D,
              batch: int = BATCH, repeats: int = REPEATS, f32=None) -> Row:
    """The 'fused' step in bfloat16 (K1 bf16): time and mean kept bad rate;
    also its kept bad rate minus the oracle's `want` on the first
    len(want) pairs, and the share of decisions equal to the float32
    step's `f32` outputs (computed here if None) on pixels valid in
    both."""
    sub = pairs[:batch]
    row, out = _throughput("bf16 fused", sub, bench_config(
        max_d, dtype="bfloat16"), device, "fused", repeats)
    if f32 is None:
        f32 = match_batch(sub, bench_config(max_d), device, "fused")
    both = out["valid"] & f32["valid"]
    row["f32_agreement"] = float(np.mean(
        out["disparity_raw"][both] == f32["disparity_raw"][both]))
    row["kept_bad_minus_oracle"] = [
        _kept_bad(out["disparity"][i], sub[i][2])
        - _kept_bad(w_.disparity, sub[i][2]) for i, w_ in enumerate(want)]
    log(f"bf16 fused: kept bad minus the oracle's "
        f"{[f'{d:+.4f}' for d in row['kept_bad_minus_oracle']]}; decisions "
        f"equal to float32 on pixels valid in both {row['f32_agreement']:.5f}")
    return row, []


def grad_hist_mpxs(pairs, device: torch.device, *, max_d: int = MAX_D,
                   batch: int = BATCH, repeats: int = REPEATS) -> Row:
    """The 'fused' step with grad_hist descriptors (K1b)."""
    row, _ = _throughput("grad_hist fused", pairs[:batch], bench_config(
        max_d, descriptor="grad_hist"), device, "fused", repeats)
    return row, []


def adversarial_row(device: torch.device, *, height: int = ADV_HW[0],
                    width: int = ADV_HW[1], max_d: int = MAX_D,
                    seeds: Sequence[int] = ADV_SEEDS) -> Row:
    """Hostile scenes (`synthetic.adversarial_pair`: occlusions,
    textureless rectangles, photometric asymmetry) on 'exact' against the
    oracle.  Textureless regions are exact ties, so decisions are gated
    at ADV_MAX_NEQ per seed, not bitwise; the LR check must reject
    ADV_MIN_REJECTION of the occluded pixels, and at most ADV_MAX_KEPT_BAD
    of the kept non-occluded pixels may be bad."""
    cfg = bench_config(max_d)
    occ_tot = rej = kept = bad = 0
    row: Dict[str, object] = {"height": height, "width": width,
                              "max_disparity": max_d, "route": "exact",
                              "oracle_host": oracle_host(), "seeds": {}}
    failures = []
    for seed in seeds:
        left, right, gt, occ = synthetic.adversarial_pair(height, width,
                                                          max_d, seed=seed)
        got = match_pair(left, right, cfg, device, "exact")
        want = oracle.match_stereo(left, right, cfg)
        raw_neq = float(np.mean(got["disparity_raw"] != want.disparity_raw))
        val_neq = float(np.mean(got["valid"] != want.valid))
        row["seeds"][seed] = {"raw_neq": raw_neq, "val_neq": val_neq}
        log(f"adversarial seed {seed}: raw_neq={raw_neq:.2e} "
            f"val_neq={val_neq:.2e}")
        if raw_neq > ADV_MAX_NEQ or val_neq > ADV_MAX_NEQ:
            failures.append(f"adversarial seed {seed}: decision disagreement "
                            f"{raw_neq:.4f}/{val_neq:.4f} beyond "
                            f"{ADV_MAX_NEQ}")
        valid = got["valid"]
        occ_tot += int(occ.sum())
        rej += int((~valid[occ]).sum())
        keep = valid & ~occ & (gt >= 0)
        kept += int(keep.sum())
        bad += int((np.abs(got["disparity"][keep] - gt[keep]) > 1).sum())
    row["occ_rejection"] = rej / max(occ_tot, 1)
    row["kept_nonocc_bad"] = bad / max(kept, 1)
    log(f"adversarial scenes: occ_rejection={row['occ_rejection']:.3f} "
        f"kept-nonocc-bad={row['kept_nonocc_bad']:.4f} (against "
        f"{row['oracle_host']}'s oracle)")
    if row["occ_rejection"] < ADV_MIN_REJECTION:
        failures.append(f"adversarial occ_rejection {row['occ_rejection']:.3f}"
                        f" below {ADV_MIN_REJECTION}")
    if row["kept_nonocc_bad"] > ADV_MAX_KEPT_BAD:
        failures.append(f"adversarial kept-nonocc-bad "
                        f"{row['kept_nonocc_bad']:.4f} above "
                        f"{ADV_MAX_KEPT_BAD}")
    return row, failures


def native_io_row(pairs, *, max_d: int = MAX_D) -> Row:
    """Host input path: the native prefetch loader (decode, grayscale,
    normalise and pad on 4 worker threads) against the Python decode, on
    len(pairs) RGB PPM pairs at the pairs' size, serially and behind a
    consumer busy 5 ms a pair.  No device work."""
    from . import native
    from .io import images

    if not native.available():
        log(f"native io: unavailable ({native.build_error()})")
        return {"available": False, "error": native.build_error()}, []
    h, w = pairs[0][0].shape[:2]
    geom = bench_config(max_d).geometry(h, w)
    rng = np.random.default_rng(0)

    def py_load(lp, rp):
        return tuple(oracle.pad_image(oracle.to_grayscale_f32(
            images._load_pnm(p)), geom) for p in (lp, rp))

    def busy(seconds):
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            pass

    def native_pass(lefts, rights, consume):
        t0 = time.perf_counter()
        with native.PairLoader(lefts, rights, geom.padded_height,
                               geom.padded_width, num_threads=4) as ld:
            n = sum(1 for _ in map(consume, ld))
        return time.perf_counter() - t0, n

    def python_pass(lefts, rights, consume):
        t0 = time.perf_counter()
        for lp, rp in zip(lefts, rights):
            consume(py_load(lp, rp))
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="bench_native_io_") as tmp:
        lefts, rights = [], []
        for i in range(len(pairs)):
            for side, acc in (("l", lefts), ("r", rights)):
                p = os.path.join(tmp, f"{i}_{side}.ppm")
                native.write_pnm(p, rng.integers(0, 256, (h, w, 3),
                                                 dtype="uint8"))
                acc.append(p)
        t_py = python_pass(lefts, rights, lambda _: None)
        t_nat, n = native_pass(lefts, rights, lambda _: None)
        t_py_ov = python_pass(lefts, rights, lambda _: busy(0.005))
        t_nat_ov, _ = native_pass(lefts, rights, lambda _: busy(0.005))
    if n != len(lefts):
        return {"available": True}, [f"native io: loader gave {n} of "
                                     f"{len(lefts)} pairs"]
    compute = 0.005 * n
    row = {"available": True, "pairs": n, "python_ms": t_py * 1e3,
           "native_ms": t_nat * 1e3, "speedup": t_py / max(t_nat, 1e-9),
           "overlap_python_extra_ms": (t_py_ov - compute) * 1e3,
           "overlap_native_extra_ms": (t_nat_ov - compute) * 1e3}
    row["overlap_speedup"] = (row["overlap_python_extra_ms"]
                              / max(row["overlap_native_extra_ms"], 1e-6))
    log(f"native io: decode+pad {n} RGB pairs: python {row['python_ms']:.1f} "
        f"ms, native 4-thread prefetch {row['native_ms']:.1f} ms "
        f"({row['speedup']:.1f}x)")
    log(f"native io overlap (5 ms/pair consumer): python adds "
        f"{row['overlap_python_extra_ms']:.1f} ms over compute, native adds "
        f"{row['overlap_native_extra_ms']:.1f} ms "
        f"({row['overlap_speedup']:.1f}x less input latency)")
    return row, []


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deepmatching_stereo_matching_tpu_torch.bench",
        description="full-pipeline Mpx/s on one GPU against the CPU oracle, "
                    "with the reference's quality gates")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        log("error: no CUDA device (torch.cuda.is_available() is False); "
            "pass --cpu to run on the CPU")
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    label = device_label(device)
    log(f"device: {label}; torch {torch.__version__}")
    if device.type == "cuda":
        from .ops import _build

        t0 = time.perf_counter()
        _build.library()
        log(f"kernel library loaded in {time.perf_counter() - t0:.1f} s")

    # Sizes are read here, not bound as defaults, so that a caller may set
    # the module's constants first (the CPU tests run it small).
    pairs = make_pairs(BATCH, H, W, MAX_D)
    cfg = bench_config(MAX_D)
    t0 = time.perf_counter()
    want = [oracle.match_stereo(l, r, cfg) for l, r, _ in pairs[:PARITY_PAIRS]]
    log(f"oracle on {len(want)} parity pairs: {time.perf_counter() - t0:.1f} s")

    sizes = {"max_d": MAX_D, "batch": BATCH, "repeats": REPEATS}
    rows, failures = {}, []
    for name, run in (
            ("oracle", lambda: oracle_mpxs(pairs, max_d=MAX_D)),
            ("step", lambda: step_mpxs(pairs, device, **sizes)),
            ("parity", lambda: parity_gate(pairs, want, device, max_d=MAX_D)),
            ("sharded", lambda: sharded_smoke(
                device, height=H, width=W, max_d=MAX_D, batch=SHARDED_BATCH,
                repeats=REPEATS)),
            ("bf16", lambda: bf16_mpxs(pairs, want, device, **sizes)),
            ("grad_hist", lambda: grad_hist_mpxs(pairs, device, **sizes)),
            ("adversarial", lambda: adversarial_row(
                device, height=ADV_HW[0], width=ADV_HW[1], max_d=MAX_D,
                seeds=ADV_SEEDS)),
            ("native_io", lambda: native_io_row(pairs, max_d=MAX_D))):
        rows[name], fails = run()
        failures += fails
        log(json.dumps({"row": name, **rows[name]}))
    if failures:
        for f in failures:
            log("GATE FAILURE:", f)
        return 1
    step = rows["step"]
    v = step["mpx_per_s"]
    print(json.dumps({
        "metric": "full_pipeline_throughput_per_chip",
        "value": round(v, 3),
        "unit": "Mpx/s",
        "vs_baseline": round(v / rows["oracle"]["mpx_per_s"], 2),
        "range": [round(x, 3) for x in step["range_mpx_per_s"]],
        "device": label,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
