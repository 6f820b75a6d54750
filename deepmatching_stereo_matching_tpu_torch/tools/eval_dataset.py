"""Evaluate the port on a directory of real stereo pairs.

    python -m deepmatching_stereo_matching_tpu_torch.tools.eval_dataset \\
        DATASET_DIR [-D 64] [--impl fused|exact|torch] [--gt-scale S] \\
        [--oracle-check N] [--max-pairs N] [--cpu] [--out EVAL.json] \\
        [--save-disparity DIR] [--center-descriptors]

Counterpart of the JAX package's `tools/eval_dataset.py`: the same
layouts, the same per-pair rows and the same summary line, for one pair
per `api.match_stereo` call on the card.

Layout auto-detection (first match wins for each scene directory/file):
  Middlebury-style   <root>/<scene>/im2.png + im6.png   GT disp2.pgm/pfm
                     <root>/<scene>/im0.png + im1.png   GT disp0.pfm
                     (cones/teddy quarter-size: GT is disparity*4 in
                     a PGM; pass --gt-scale 0.25)
  KITTI-style        <root>/image_2/NNNNNN_10.png + image_3/NNNNNN_10.png
                     GT disp_occ_0/NNNNNN_10.png (16-bit PNG, /256,
                     0 = invalid — io/writers.py:read_disparity_png16)
  Flat pairs         <root>/*_left.png + *_right.png [+ *_gt.pfm|png]

Each pair's row (stderr) holds its host-wall seconds, Mpx/s and coverage,
with ground truth the bad-pixel rates (kept and all) and the EPE, and with
`--oracle-check N`, on the first N pairs, the share of decisions and of
validity that differ from the port's copy of the NumPy oracle.  The
summary goes to stdout as one JSON line; `--out` writes the report.

`--impl` takes the port's routes (default `fused`).
`--center-descriptors` matches by ZNCC (`Config.center_descriptors`),
which the oracle check applies too.  The tool runs on `cuda:0`; `--cpu`
runs the kernels' plain versions on the CPU, and without a card and
without `--cpu` it exits 2.  It exits 2 when no pair is found.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

NOTE = ("QUALITY evidence only, NOT a throughput figure: each pair is one "
        "api.match_stereo call. Its seconds hold host preprocessing, the "
        "copy in, the single-pair step and the copy of all five outputs "
        "out; the first pair's also hold the CUDA context and the kernel "
        "build or load.")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _read_gt(path: str, scale: float) -> np.ndarray:
    """Ground truth as float32, NaN where invalid, times `scale`."""
    from ..io import images, writers

    if path.endswith(".pfm"):
        gt = writers.read_pfm(path)
        gt = np.where(np.isinf(gt), np.nan, gt)
    elif path.endswith(".pgm"):
        gt = images.load_image(path).astype(np.float32)
        gt[gt == 0] = np.nan          # Middlebury PGM: 0 = unknown
    elif path.endswith(".png"):
        gt = writers.read_disparity_png16(path)  # NaN = invalid
    else:
        raise ValueError(f"unsupported GT format: {path}")
    return gt * np.float32(scale)


def discover(root: str, gt_scale: float):
    """[(name, left_path, right_path, gt_path_or_None, gt_scale)]."""
    found = []
    # KITTI layout.
    img2 = os.path.join(root, "image_2")
    if os.path.isdir(img2):
        for lp in sorted(glob.glob(os.path.join(img2, "*_10.png"))):
            base = os.path.basename(lp)
            rp = os.path.join(root, "image_3", base)
            if not os.path.exists(rp):
                continue
            gt = None
            for sub in ("disp_occ_0", "disp_noc_0", "disp_occ", "disp_noc"):
                cand = os.path.join(root, sub, base)
                if os.path.exists(cand):
                    gt = cand
                    break
            found.append((base[:-4], lp, rp, gt, gt_scale))
        if found:
            return found
    # Middlebury scene directories.
    for scene in sorted(os.listdir(root)):
        sdir = os.path.join(root, scene)
        if not os.path.isdir(sdir):
            continue
        for l_, r_, g_ in (("im2.png", "im6.png", ("disp2.pfm",
                                                   "disp2.pgm")),
                           ("im0.png", "im1.png", ("disp0.pfm",
                                                   "disp0.pgm",
                                                   "disp0GT.pfm"))):
            lp, rp = os.path.join(sdir, l_), os.path.join(sdir, r_)
            if os.path.exists(lp) and os.path.exists(rp):
                gt = next((os.path.join(sdir, g) for g in g_
                           if os.path.exists(os.path.join(sdir, g))), None)
                found.append((scene, lp, rp, gt, gt_scale))
                break
    if found:
        return found
    # Flat *_left/*_right pairs.
    for lp in sorted(glob.glob(os.path.join(root, "*_left.*"))):
        stem = lp[: lp.rfind("_left")]
        ext = lp[lp.rfind("."):]
        rp = stem + "_right" + ext
        if not os.path.exists(rp):
            continue
        gt = next((stem + "_gt" + e for e in (".pfm", ".png")
                   if os.path.exists(stem + "_gt" + e)), None)
        found.append((os.path.basename(stem), lp, rp, gt, gt_scale))
    return found


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="deepmatching_stereo_matching_tpu_torch.tools.eval_dataset",
        description="dataset evaluation for the stereo engine on a GPU")
    ap.add_argument("root", help="dataset directory")
    ap.add_argument("-D", "--max-disparity", type=int, default=64)
    ap.add_argument("--impl", choices=("fused", "exact", "torch"),
                    default="fused", help="matching route (ops/_dispatch.py)")
    ap.add_argument("--gt-scale", type=float, default=1.0,
                    help="multiply raw GT values (0.25 for quarter-size "
                         "Middlebury PGMs stored as disparity*4)")
    ap.add_argument("--oracle-check", type=int, default=0, metavar="N",
                    help="also run the NumPy oracle on the first N pairs")
    ap.add_argument("--max-pairs", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--center-descriptors", action="store_true",
                    help="centre each patch descriptor on its mean before "
                         "normalising it (ZNCC matching)")
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument("--save-disparity", default=None,
                    help="directory for predicted PFM/color maps")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        log("error: no CUDA device (torch.cuda.is_available() is False); "
            "pass --cpu to run on the CPU")
        return 2
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)

    from .. import api
    from ..config import Config
    from ..io import images, writers
    from ..oracle import reference as oracle
    from ..utils import metrics

    pairs = discover(args.root, args.gt_scale)
    if not pairs:
        log(f"no stereo pairs found under {args.root} (see --help for "
            f"recognised layouts)")
        return 2
    if args.max_pairs:
        pairs = pairs[: args.max_pairs]
    cfg = Config(max_disparity=args.max_disparity,
                 center_descriptors=args.center_descriptors)
    log(f"{len(pairs)} pairs, impl={args.impl}, device={device}, "
        f"D={args.max_disparity}")

    rows = []
    for i, (name, lp, rp, gtp, scale) in enumerate(pairs):
        left, right = images.load_pair(lp, rp)
        t0 = time.perf_counter()
        res = api.match_stereo(left, right, cfg, impl=args.impl,
                               device=device)
        dt = time.perf_counter() - t0
        row = {"pair": name, "shape": list(left.shape[:2]),
               "seconds": round(dt, 6),
               "mpx_per_s": round(left.shape[0] * left.shape[1] * 1e-6
                                  / dt, 3),
               "coverage": round(metrics.coverage(res.disparity), 4)}
        if gtp:
            gt = _read_gt(gtp, scale)
            row.update(
                bad_pixel_rate_kept=round(metrics.bad_pixel_rate(
                    res.disparity, gt, count_invalid=False), 4),
                bad_pixel_rate_all=round(metrics.bad_pixel_rate(
                    res.disparity, gt, count_invalid=True), 4),
                epe_kept=round(metrics.end_point_error(
                    res.disparity, gt), 4))
        if i < args.oracle_check:
            want = oracle.match_stereo(left, right, cfg)
            row["oracle_decision_disagreement"] = round(float(np.mean(
                res.disparity_raw != want.disparity_raw)), 6)
            row["oracle_valid_disagreement"] = round(float(np.mean(
                res.valid != want.valid)), 6)
        if args.save_disparity:
            os.makedirs(args.save_disparity, exist_ok=True)
            writers.write_pfm(os.path.join(args.save_disparity,
                                           f"{name}.pfm"), res.disparity)
            writers.write_disparity_color(
                os.path.join(args.save_disparity, f"{name}.png"),
                res.disparity)
        rows.append(row)
        log(json.dumps(row))

    keyed = [r for r in rows if "bad_pixel_rate_kept" in r]
    summary = {
        "pairs": len(rows),
        "with_gt": len(keyed),
        "mean_mpx_per_s": round(float(np.mean(
            [r["mpx_per_s"] for r in rows])), 3),
        "mean_coverage": round(float(np.mean(
            [r["coverage"] for r in rows])), 4),
    }
    if keyed:
        summary["mean_bad_pixel_rate_kept"] = round(float(np.mean(
            [r["bad_pixel_rate_kept"] for r in keyed])), 4)
        summary["mean_epe_kept"] = round(float(np.mean(
            [r["epe_kept"] for r in keyed])), 4)
    report = {"config": {"max_disparity": args.max_disparity,
                         "impl": args.impl, "gt_scale": args.gt_scale,
                         "device": str(device)},
              "note": NOTE, "pairs": rows, "summary": summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
