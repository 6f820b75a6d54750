"""The bench step and its kernels against the card's speed of light.

    python -m deepmatching_stereo_matching_tpu_torch.tools.roofline \\
        [--out PATH] [--cpu] [--ceiling PATH]

Counterpart of the JAX package's `tools/roofline.py`.  Every bound comes
from the port's work model (`deepmatching_stereo_matching_tpu_torch.work`).
At the bench geometry (450x375, D=64, batch 32, seeds 100 + i:
`bench.make_pairs` / `padded_batch`) it times the rows of the JAX tool's
ROOFLINE.json under its names:

  full_step_fused     `pipeline.match_padded_core`, 'fused' (K1), as
                      `bench.step_mpxs` runs it; model `work.step_fused`;
  fused_kernel        `fused_cuda.match_planes` on the 64 stacked
                      directions (K1); model `work.k1`;
  descriptors_xla     `left_descriptors` + `right_sliding_descriptors` on
                      them (torch ops; seconds only; the name is the JAX
                      file's);
  costvol_kernel      `costvol_cuda.cost_volume_dmajor` (K2); model
                      `work.k2`;
  pyramid_kernel      `pyramid_cuda.pyramid_backtrack` (K3) on the plain
                      version's volume; model `work.k3`;
  twokernel_path_sum  the three rows above; model `work.path_exact`;
  lr_densify_tail     full_step_fused - fused_kernel.

Each timed row is `utils.timing.steady_state` (CUDA events, a sample of
at least 10 ms, any sample <= 0 raises; `bench.timed`), REPEATS samples:
median, min, max.  A row with a model carries `per_direction_model`,
`bounding_resource`, `sol_seconds` and `sol_fraction` (sol_seconds /
seconds).  `fused_kernel.calibrated` is K1's share with its operations at
P1's measured rate (`tools.vpu_probe.run_probe('stream')` in this
process, or the `--ceiling` file that `tools.vpu_probe --out` wrote on
this card; a file from another card exits 1).

The file (`--out` only; the repo's ROOFLINE.json is never written)
holds `chip` (nvidia-smi's name and power limit), `peaks`, `geometry`,
`rows` and `headline`; stdout gets one JSON line, the headline and
`chip`; diagnostics go to stderr.  A share above MERGED_WORK exits 1:
the model then counts less work than the card did.  Runs on the card;
without one it exits 2 unless --cpu asks for the plain versions, whose
times are no device metric (every share is then null, and there is no
calibration unless --ceiling gives a file written on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Tuple

import torch

from ..bench import (bench_config, device_label, make_pairs, padded_batch,
                     timed)
from ..config import Config, Geometry
from ..models import descriptors, pipeline
from ..ops import costvol_cuda, fused_cuda, pyramid_cuda
from .. import work
from ..work import MERGED_WORK, Work, bound
from . import vpu_probe

H, W, MAX_D, BATCH = 375, 450, 64, 32      # the bench geometry (bench.py)
REPEATS = 5


class CeilingError(ValueError):
    pass


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _bench(height: int, width: int, max_d: int) -> Tuple[Config, Geometry]:
    cfg = bench_config(max_d)
    return cfg, cfg.geometry(height, width)


def _setup(device: torch.device, height: int, width: int, max_d: int,
           batch: int):
    """(cfg, geom, left planes, right planes) of the bench pairs."""
    cfg, geom = _bench(height, width, max_d)
    pairs = make_pairs(batch, height, width, max_d)
    lp, rp = (padded_batch([p[i] for p in pairs], cfg, height, width, device)
              for i in (0, 1))
    return cfg, geom, lp, rp


def _directions(lp: torch.Tensor, rp: torch.Tensor):
    """Both directions stacked, as `pipeline.lr_directions` builds them."""
    return torch.stack([lp, rp.flip(-1)]), torch.stack([rp, lp.flip(-1)])


def _timed(fn, args, device: torch.device, repeats: int) -> dict:
    stats = timed(fn, args, device, repeats)
    return {"seconds": stats["median"],
            "timing": {k: stats[k] for k in ("median", "min", "max",
                                             "samples", "reps", "repeats")}}


def _share(sol_seconds: float, seconds: float,
           device: torch.device) -> Optional[float]:
    """sol_seconds / seconds on the card; None for a time on the CPU."""
    return sol_seconds / seconds if device.type == "cuda" else None


def _modelled(row: dict, model: Work, directions: int,
              device: torch.device) -> dict:
    t, by = bound(model)
    row.update(per_direction_model=model.scaled(1 / directions).as_dict(),
               bounding_resource=by, sol_seconds=t,
               sol_fraction=_share(t, row["seconds"], device))
    return row


def full_step_fused(device: torch.device, *, height: int = H, width: int = W,
                    max_d: int = MAX_D, batch: int = BATCH,
                    repeats: int = REPEATS) -> dict:
    cfg, geom, lp, rp = _setup(device, height, width, max_d, batch)
    row = _timed(lambda a, b: pipeline.match_padded_core(a, b, cfg, geom,
                                                         "fused"),
                 (lp, rp), device, repeats)
    return _modelled(row, work.step_fused(cfg, geom, batch), 2 * batch,
                     device)


def fused_kernel(device: torch.device, *, height: int = H, width: int = W,
                 max_d: int = MAX_D, batch: int = BATCH,
                 repeats: int = REPEATS) -> dict:
    cfg, geom, lp, rp = _setup(device, height, width, max_d, batch)
    row = _timed(lambda a, b: fused_cuda.match_planes(a, b, cfg, geom),
                 _directions(lp, rp), device, repeats)
    return _modelled(row, work.k1(cfg, geom, 2 * batch), 2 * batch, device)


def _descriptors(cfg: Config, ls: torch.Tensor, rs: torch.Tensor):
    return (descriptors.left_descriptors(ls, cfg),
            descriptors.right_sliding_descriptors(rs, cfg))


def descriptors_xla(device: torch.device, *, height: int = H, width: int = W,
                    max_d: int = MAX_D, batch: int = BATCH,
                    repeats: int = REPEATS) -> dict:
    cfg, _, lp, rp = _setup(device, height, width, max_d, batch)
    return _timed(lambda a, b: _descriptors(cfg, a, b), _directions(lp, rp),
                  device, repeats)


def costvol_kernel(device: torch.device, *, height: int = H, width: int = W,
                   max_d: int = MAX_D, batch: int = BATCH,
                   repeats: int = REPEATS) -> dict:
    cfg, geom, lp, rp = _setup(device, height, width, max_d, batch)
    args = (geom.disparities, cfg.patch_size, cfg.max_disparity)
    row = _timed(lambda a, b: costvol_cuda.cost_volume_dmajor(a, b, *args),
                 _descriptors(cfg, *_directions(lp, rp)), device, repeats)
    return _modelled(row, work.k2(cfg, geom, 2 * batch), 2 * batch, device)


def pyramid_kernel(device: torch.device, *, height: int = H, width: int = W,
                   max_d: int = MAX_D, batch: int = BATCH,
                   repeats: int = REPEATS) -> dict:
    """K3 on the plain version's volume, so that the row launches K3
    alone."""
    cfg, geom, lp, rp = _setup(device, height, width, max_d, batch)
    vol = costvol_cuda.cost_volume_dmajor_torch(
        *_descriptors(cfg, *_directions(lp, rp)), geom.disparities,
        cfg.patch_size, cfg.max_disparity)
    row = _timed(lambda v: pyramid_cuda.pyramid_backtrack(v, geom.levels,
                                                          cfg.lam),
                 (vol,), device, repeats)
    return _modelled(row, work.k3(cfg, geom, 2 * batch), 2 * batch, device)


def twokernel_path_sum(desc: dict, costvol: dict, pyramid: dict,
                       device: torch.device, *, height: int = H,
                       width: int = W, max_d: int = MAX_D,
                       batch: int = BATCH) -> dict:
    row = {"seconds": desc["seconds"] + costvol["seconds"]
           + pyramid["seconds"]}
    return _modelled(row, work.path_exact(*_bench(height, width, max_d), batch),
                     2 * batch, device)


def lr_densify_tail(full: dict, fused: dict) -> dict:
    return {"seconds": max(0.0, full["seconds"] - fused["seconds"])}


def read_ceiling(path: str, card: str) -> dict:
    """P1's row of a `tools.vpu_probe --out` file written on `card`;
    raises CeilingError if the file is another card's or has no P1."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    p1 = [r for r in rows if r.get("probe") == "stream"]
    if not p1:
        raise CeilingError(f"{path} holds no P1 ('stream') row")
    if p1[0].get("card") != card:
        raise CeilingError(f"{path} was written on {p1[0].get('card')!r}, "
                           f"not on this card ({card!r})")
    return p1[0]


def calibrated(device: torch.device, fused_seconds: float, *,
               height: int = H, width: int = W, max_d: int = MAX_D,
               batch: int = BATCH, probe_row: Optional[dict] = None) -> dict:
    """K1's share with its operations at P1's measured rate: `probe_row`
    (a ceiling file's P1 row), else P1 run here."""
    if probe_row is None:
        probe_row = vpu_probe.run_probe("stream", device)
        source = "tools.vpu_probe.run_probe('stream') in this process"
    else:
        source = "--ceiling file"
    rate = probe_row["achieved_flop_per_s"]
    t, by = bound(work.k1(*_bench(height, width, max_d), 2 * batch), rate)
    return {"p1_flop_per_s": rate, "source": source, "sol_seconds": t,
            "bounding_resource": by,
            "sol_fraction": _share(t, fused_seconds, device)}


def bench_size() -> dict:
    """The bench geometry and REPEATS, as `run` takes them (read when
    called, so that a caller may cut the module's constants)."""
    return dict(height=H, width=W, max_d=MAX_D, batch=BATCH, repeats=REPEATS)


def _call(name: str, fn: Callable[[], dict]) -> dict:
    return fn()


def run(device: torch.device, card: str, *, height: int, width: int,
        max_d: int, batch: int, repeats: int,
        probe_row: Optional[dict] = None,
        wrap: Callable[[str, Callable[[], dict]], dict] = _call) -> dict:
    """Every row in order, then the calibration (on the card, or with a
    ceiling file); returns the file's contents.  Each timed row and the
    calibration run as `wrap(name, fn)`."""
    size = dict(height=height, width=width, max_d=max_d, batch=batch)
    rows = {}
    for name, fn in (("full_step_fused", full_step_fused),
                     ("fused_kernel", fused_kernel),
                     ("descriptors_xla", descriptors_xla),
                     ("costvol_kernel", costvol_kernel),
                     ("pyramid_kernel", pyramid_kernel)):
        rows[name] = wrap(name, lambda fn=fn: fn(device, **size,
                                                 repeats=repeats))
    rows["twokernel_path_sum"] = twokernel_path_sum(
        rows["descriptors_xla"], rows["costvol_kernel"],
        rows["pyramid_kernel"], device, **size)
    rows["lr_densify_tail"] = lr_densify_tail(rows["full_step_fused"],
                                              rows["fused_kernel"])
    fused = rows["fused_kernel"]
    if device.type == "cuda" or probe_row is not None:
        fused["calibrated"] = wrap("calibrated", lambda: calibrated(
            device, fused["seconds"], **size, probe_row=probe_row))
    for name, r in rows.items():
        share = r.get("sol_fraction")
        log(f"{name}: {r['seconds'] * 1e3:.4f} ms"
            + (f" [{r['timing']['min'] * 1e3:.4f}.."
               f"{r['timing']['max'] * 1e3:.4f}]" if "timing" in r else "")
            + (f", bound {r['sol_seconds'] * 1e3:.4f} ms "
               f"({r['bounding_resource']})" if "sol_seconds" in r else "")
            + (f", share {share:.4f}" if share is not None else "")
            + f" [{card}]")
    cal = fused.get("calibrated")
    if cal is not None:
        log(f"calibrated: P1 at {cal['p1_flop_per_s'] / 1e12:.3f} TFLOP/s "
            f"({cal['source']}) -> K1 bound {cal['sol_seconds'] * 1e3:.4f} "
            f"ms ({cal['bounding_resource']}), share {cal['sol_fraction']}")
    _, geom = _bench(height, width, max_d)
    headline = {
        "fused_sol_fraction": fused["sol_fraction"],
        "fused_bounding_resource": fused["bounding_resource"],
        "full_step_sol_fraction": rows["full_step_fused"]["sol_fraction"],
        "full_step_bounding_resource":
            rows["full_step_fused"]["bounding_resource"]}
    if cal is not None:
        headline.update(fused_sol_fraction_calibrated=cal["sol_fraction"],
                        calibrated_p1_tflops=cal["p1_flop_per_s"] / 1e12)
    return {"chip": card, "device": str(device), "peaks": work.PEAKS,
            "geometry": {"height": height, "width": width,
                         "max_disparity": max_d, "batch_pairs": batch,
                         "directions": 2 * batch,
                         "padded": [geom.padded_height, geom.padded_width],
                         "grid": [geom.grid_h, geom.grid_w],
                         "disparities": geom.disparities,
                         "levels": geom.levels},
            "rows": rows, "headline": headline}


def shares_over(out: dict, limit: float = MERGED_WORK) -> Dict[str, float]:
    """{row: share} of every share above `limit`, the calibration's too."""
    found = {}
    for name, r in out["rows"].items():
        for key, part in ((name, r), (f"{name}.calibrated",
                                      r.get("calibrated") or {})):
            if (part.get("sol_fraction") or 0) > limit:
                found[key] = part["sol_fraction"]
    return found


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deepmatching_stereo_matching_tpu_torch.tools.roofline",
        description="The bench step and its kernels against the card's "
                    "speed of light")
    ap.add_argument("--out", default=None, help="write the rows to this file")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no device "
                         "metric: the shares are null)")
    ap.add_argument("--ceiling", default=None,
                    help="P1's rate from this `tools.vpu_probe --out` file, "
                         "written on this card, instead of running P1")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        log("roofline: no CUDA device (torch.cuda.is_available() is False); "
            "pass --cpu to run the plain versions on the CPU")
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    card = device_label(device)
    probe_row = None
    if args.ceiling:
        try:
            probe_row = read_ceiling(args.ceiling, card)
        except (OSError, ValueError) as e:      # CeilingError, bad JSON
            log(f"roofline: {e}")
            return 1
    out = run(device, card, **bench_size(), probe_row=probe_row)
    over = shares_over(out)
    if over:
        log(f"roofline: shares above {MERGED_WORK} of the bound {over}: the "
            f"model counts less work than the card did")
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({**out["headline"], "chip": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
