"""The cross-host traffic budget of each parallel strategy, against the
compute a pair takes on the card.

    python -m deepmatching_stereo_matching_tpu_torch.tools.dcn_budget \\
        --roofline PATH [--out PATH]

Counterpart of the JAX package's `tools/dcn_budget.py`: the same nine
rows and the same per-pair byte formulas, from the port's own `Config`
and `Geometry` at the bench geometry.  For every strategy it counts the
bytes that cross the host boundary per stereo pair and sets them against
the measured compute per pair:

    efficiency = t_compute / (t_compute + t_link),
    t_compute  = seconds per pair / (hosts x cards per host),
    t_link     = cross-host bytes per pair / HOST_LINK_BYTES_PER_S,

with no overlap of compute and communication (pessimistic) and no
latency (optimistic at small messages).

The compute per pair is `full_step_fused.seconds / batch_pairs` of a file
that this port's `tools.roofline --out` wrote on an NVIDIA card.  A
missing file, or one whose `chip` names no NVIDIA card (the repo's
ROOFLINE.json, a TPU run, or a `--cpu` run), exits 1: there is no
fallback figure.  The rates are stated, not measured:

  * 8 H100s a host (NVIDIA HGX / DGX H100);
  * across hosts, 8 x 400 Gb/s NDR InfiniBand adapters a host (DGX H100),
    derated 50% as the JAX tool derates its link: 200 GB/s.

Prints the table and the card line; writes the table (Markdown) only
with --out.  The repo's DCN_BUDGET.md is never written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from ..config import Config
from .roofline import H, MAX_D, W

CARDS_PER_HOST = 8
N_HOSTS = 2
HOST_LINK_BYTES_PER_S = 8 * 400e9 / 8 * 0.5
F32 = 4
EFFICIENCY_TARGET = 0.8


class BudgetError(ValueError):
    pass


def compute_per_pair(path: str) -> Tuple[float, str]:
    """(seconds per pair, chip) of a roofline file written on an NVIDIA
    card by `tools.roofline`; raises BudgetError otherwise."""
    if not os.path.exists(path):
        raise BudgetError(f"no roofline file at {path}")
    with open(path) as f:
        r = json.load(f)
    chip = str(r.get("chip", ""))
    if "NVIDIA" not in chip:
        raise BudgetError(f"{path} was written on {chip!r}, not on an NVIDIA "
                          f"card: no compute figure of this port's")
    return (r["rows"]["full_step_fused"]["seconds"]
            / r["geometry"]["batch_pairs"]), chip


def budget(t_pair: float, *, height: int = H, width: int = W,
           max_d: int = MAX_D, levels: Optional[int] = None,
           n_hosts: int = N_HOSTS, cards_per_host: int = CARDS_PER_HOST) -> List[Dict[str, object]]:
    """The rows: per strategy, the bytes that cross the host boundary a
    pair (both LR directions) and the efficiency at `n_hosts` hosts."""
    cfg = Config(max_disparity=max_d)
    geom = cfg.geometry(height, width)
    h0, w0, d0 = geom.grid_h, geom.grid_w, geom.disparities
    hp, p = geom.padded_height, cfg.patch_size
    levels = geom.levels if levels is None else levels
    ndir = 2                            # LR flip mode: both directions
    n_cards = n_hosts * cards_per_host
    rows = []

    def row(name, axis, bytes_per_pair, note, t_comp=t_pair / n_cards):
        t_link = bytes_per_pair / HOST_LINK_BYTES_PER_S
        eff = t_comp / (t_comp + t_link)
        rows.append({"strategy": name, "axis_over_hosts": axis,
                     "cross_host_bytes_per_pair": int(bytes_per_pair),
                     "link_seconds_per_pair": t_link,
                     "efficiency_at_2_hosts": eff,
                     "meets_80pct": eff >= EFFICIENCY_TARGET, "note": note})

    # Data parallel: each host reads and keeps its own pairs.
    row("DP (data axis across hosts)", "data", 0.0,
        "inputs and outputs stay on their host")
    row("DP + full output gather", "data", 5 * height * width * F32,
        "only when every host needs every pair's five maps")
    row("tiled H-tiles (model axis across hosts)", "model", 0.0,
        "quadtree-aligned row tiles need no halo (parallel/mesh.py)")
    # wtiled: one W-tile edge crosses the boundary; per direction the
    # descriptor halo, the LR halo and (merge_level 1) half the level-1 map.
    halo_q = (max_d - 1) // p + 2
    desc_halo = hp * (halo_q * p) * F32
    lr_halo = h0 * (halo_q + 1) * F32
    merge = (h0 // 2) * (w0 // 2) * (d0 // 2) * F32 / 2
    row("wtiled + merge_level=1 (tw across hosts)", "model",
        ndir * (desc_halo + lr_halo + merge),
        "one tile edge across hosts: descriptor and LR halos, coarse merge")
    row("wtiled, tile-local pyramid (tw across hosts)", "model",
        ndir * (desc_halo + lr_halo), "merge_level=None: halos only")
    # dslab: the all_to_all sends half the volume across a 2-host split.
    vol = h0 * w0 * d0 * F32
    row("dslab all_to_all (model axis across hosts)", "model", ndir * vol / 2,
        "half the (H0, W0, D) volume crosses a direction")
    # ringd: 2 ring edges across hosts; per edge a halo plane a level, the
    # (value, index) ring steps and a psum plane up and down a level.
    plane = h0 * w0 * F32
    ring = ndir * 2 * (levels * plane + 2 * plane + levels * 2 * plane)
    row("ringd (model axis across hosts)", "model", ring,
        "only (H0, W0) planes cross; 2 ring edges across hosts")
    # KITTI class, D=256: compute and dslab's traffic grow with D, ringd's
    # does not.
    scale_d = 256 // max_d
    for name, b in (("dslab, D=256 (model across hosts)",
                     ndir * vol * scale_d / 2),
                    ("ringd, D=256 (model across hosts)", ring)):
        row(name, "model", b, "compute x4, ringd's traffic unchanged",
            t_comp=t_pair * scale_d / n_cards)
    return rows


def table(rows, t_pair: float, chip: str, source: str) -> List[str]:
    n_cards = N_HOSTS * CARDS_PER_HOST
    lines = [
        "# Cross-host traffic budget: 2 hosts of 8 H100s",
        "",
        "Generated by `python -m deepmatching_stereo_matching_tpu_torch."
        "tools.dcn_budget` (its docstring holds the model and the stated "
        f"rates: {HOST_LINK_BYTES_PER_S / 1e9:g} GB/s across hosts).  "
        f"Measured compute: {t_pair * 1e6:.4f} us/pair (`full_step_fused` "
        f"of {source}, on {chip}), split over {n_cards} cards.",
        "",
        "| strategy | axis across hosts | bytes/pair | link us/pair | "
        "eff@2hosts | >=80% |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['strategy']} | {r['axis_over_hosts']} | "
            f"{r['cross_host_bytes_per_pair']:,} | "
            f"{r['link_seconds_per_pair'] * 1e6:.4f} | "
            f"{r['efficiency_at_2_hosts'] * 100:.2f}% | "
            f"{'yes' if r['meets_80pct'] else 'NO'} |")
    return lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deepmatching_stereo_matching_tpu_torch.tools.dcn_budget",
        description="Cross-host bytes per pair of each strategy against "
                    "the compute a pair takes on the card")
    ap.add_argument("--roofline", required=True,
                    help="a file `tools.roofline --out` wrote on the card")
    ap.add_argument("--out", default=None, help="write the table here")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        t_pair, chip = compute_per_pair(args.roofline)
    except (OSError, KeyError, json.JSONDecodeError, BudgetError) as e:
        print(f"dcn_budget: {e}", file=sys.stderr)
        return 1
    lines = table(budget(t_pair), t_pair, chip, args.roofline)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(chip, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
