"""How `correct` is decided: the program's answers against the plain
reference's, on the same inputs, after the window has closed.

A sample is (left, right, answer): the raw pair the benchmark made and
handed the program, and the program's cropped host outputs for it, taken
from the timed path.  The reference (`reference.match_stereo`) starts from
the raw pair and works the grayscale, the padding and the geometry out
again itself.  Five numbers, each held to its limit in
`limits/<cell>.json`:

  decisions_off  share of sampled pixels whose raw disparity (the
                 backtracked decision, densified) differs;
  validity_off   share whose LR-check validity differs;
  disparity_off  share whose output disparity differs, the map users read
                 (the decision where valid, the configuration's
                 `invalid_value` elsewhere; NaN equals NaN);
  right_off      share whose right-view disparity differs;
  score_err      largest |score - reference score| over the pixels whose
                 decision agrees (the level-0 correlation it chose).

An answer that never came (None) fails the run outright.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import reference

NUMBERS = ("decisions_off", "validity_off", "disparity_off", "right_off",
           "score_err")
Sample = Tuple[np.ndarray, np.ndarray, Optional[Dict[str, np.ndarray]]]


def compare(samples: Sequence[Sample], ref_cfg: reference.Config
            ) -> Tuple[Dict[str, float], int]:
    """The five numbers over `samples`, and how many answers never
    came."""
    n_px = raw = val = disp = right = 0
    score_err = 0.0
    missing = 0
    for left, right_img, got in samples:
        if got is None:
            missing += 1
            continue
        want = reference.match_stereo(left, right_img, ref_cfg)
        g_raw = np.asarray(got["disparity_raw"])
        if g_raw.shape != want.disparity_raw.shape:
            raise ValueError(f"answer shaped {g_raw.shape}, reference "
                             f"{want.disparity_raw.shape}")
        same = g_raw == want.disparity_raw
        n_px += same.size
        raw += int((~same).sum())
        val += int((np.asarray(got["valid"]) != want.valid).sum())
        g_disp = np.asarray(got["disparity"])
        if g_disp.shape != want.disparity.shape:
            raise ValueError(f"disparity shaped {g_disp.shape}, reference "
                             f"{want.disparity.shape}")
        disp += int((~((g_disp == want.disparity)
                       | (np.isnan(g_disp) & np.isnan(want.disparity))))
                    .sum())
        right += int((np.asarray(got["disparity_right"])
                      != want.disparity_right).sum())
        diff = np.abs(np.asarray(got["score"], dtype=np.float64)
                      - want.score.astype(np.float64))[same]
        if diff.size:
            score_err = max(score_err, float(diff.max()))
        if not np.all(np.isfinite(np.asarray(got["score"]))):
            score_err = float("inf")
    n = max(n_px, 1)
    return ({"decisions_off": raw / n, "validity_off": val / n,
             "disparity_off": disp / n, "right_off": right / n,
             "score_err": score_err}, missing)


def judge(numbers: Dict[str, float], missing: int,
          limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(correct, lines): each number beside its limit."""
    lines = [f"check {k} {numbers[k]!r} limit {limits[k]!r}"
             for k in NUMBERS]
    lines.append(f"check missing_answers {missing} limit 0")
    ok = missing == 0 and all(numbers[k] <= limits[k] for k in NUMBERS)
    return ok, lines
