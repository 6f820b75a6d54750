"""The harness end to end on the CPU, at a tiny geometry on the 'torch'
route: every driver, traced and not, finds its files by name, prints the
contract's keys and no device metric; a timed path broken underneath
comes out not correct; without a card the command exits non-zero."""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from stereobench import harness

from .conftest import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2 ** 31 + 12345          # beyond 32 signed bits, as the driver's are


def run(root, cell, trace=False, seconds=0.6, seed=SEED):
    t0 = time.perf_counter()
    result = harness.run_cell(harness.load_cell(root, cell), seed, seconds,
                              trace, torch.device("cpu"), t0,
                              log=lambda *a: None)
    result.pop("_check_lines")
    return result


def device_metric_names(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    return {m["name"] for m in manifest["per_layer"]
            if m["source"] == "device_trace"}


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("traffic", ["step", "stream", "online"])
def test_cell_runs_on_cpu(tiny_root, traffic, trace):
    result = run(tiny_root, f"tiny.{traffic}", trace)
    assert list(result) == KEYS
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    names = set(result["metrics"])
    assert not names & device_metric_names(tiny_root)
    assert not {"busy_s", "window_s"} & set(result["device"])
    assert result["device"]["platform"] == "cpu"
    if trace:
        assert names and "setup_s" not in names
    else:
        assert "setup_s" in names and len(names) == 2
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.dumps(result, allow_nan=False)


def test_new_metric_found_by_name(tiny_root):
    """tiny.spans exists only as a file of the tiny root."""
    result = run(tiny_root, "tiny.step", trace=True)
    assert result["metrics"]["tiny.spans"]["value"] >= 1


def test_new_driver_found_by_name(tiny_root):
    """tiny_closed exists only as a file of the tiny root's drivers."""
    assert not os.path.exists(os.path.join(REPO, "stereobench", "drivers",
                                           "tiny_closed.py"))
    result = run(tiny_root, "tiny.closed")
    assert list(result) == KEYS
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"pairs_on_time_pct", "setup_s"}
    assert result["metrics"]["pairs_on_time_pct"]["value"] > 0


def test_same_seed_same_inputs(tiny_root):
    a = run(tiny_root, "tiny.step", seed=7)
    b = run(tiny_root, "tiny.step", seed=7)
    assert a["checks"] == b["checks"]


# ---------------------------------------------------------------------------
# Faults planted under the timed path: each must come out not correct.
# ---------------------------------------------------------------------------

def _stale(real):
    """A step that hands back its previous outputs."""
    last = []

    def fn(*args, **kwargs):
        out = real(*args, **kwargs)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return fn


def _half_batch(real):
    """Half of the batch left out: the first half's answers stand for
    the rest."""
    def fn(left, right, *args, **kwargs):
        n = left.shape[0]
        half = max(1, n // 2)
        out = real(left[:half], right[:half], *args, **kwargs)
        idx = torch.arange(n) % half
        return {k: v[idx] for k, v in out.items()}
    return fn


def _altered(real):
    """An answer altered where it is produced: one 16x16 block of every
    pair's decisions moved by a patch."""
    def fn(*args, **kwargs):
        out = dict(real(*args, **kwargs))
        raw = out["disparity_raw"].clone()
        raw[..., :16, :16] += 4
        out["disparity_raw"] = raw
        return out
    return fn


def _invalid_as_zero(real):
    """Only the output map altered: invalid pixels written as 0, not as
    the configuration's `invalid_value` (NaN); decisions, validity and
    scores untouched."""
    def fn(*args, **kwargs):
        out = dict(real(*args, **kwargs))
        out["disparity"] = torch.nan_to_num(out["disparity"], nan=0.0)
        return out
    return fn


@pytest.mark.parametrize("traffic,fault", [
    ("step", _stale), ("step", _half_batch), ("step", _altered),
    ("step", _invalid_as_zero),
    ("stream", _stale), ("stream", _half_batch), ("stream", _altered),
    ("stream", _invalid_as_zero),
    ("online", _stale), ("online", _altered), ("online", _invalid_as_zero)])
def test_fault_is_not_correct(tiny_root, monkeypatch, traffic, fault):
    from deepmatching_stereo_matching_tpu_torch.models import pipeline
    monkeypatch.setattr(pipeline, "match_padded_core",
                        fault(pipeline.match_padded_core))
    result = run(tiny_root, f"tiny.{traffic}")
    assert result["correct"] is False, result["checks"]
    if fault is _invalid_as_zero:
        failing = {k for k, c in result["checks"].items()
                   if c["value"] > c["limit"]}
        assert failing == {"disparity_off"}, result["checks"]


def test_missing_answer_is_not_correct(tiny_root, monkeypatch):
    """Every pair of the window fails (the warm-up's do not)."""
    from deepmatching_stereo_matching_tpu_torch import api
    real, calls = api.match_stereo, []

    def fail(*args, **kwargs):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("planted")
        return real(*args, **kwargs)
    monkeypatch.setattr(api, "match_stereo", fail)
    result = run(tiny_root, "tiny.online")
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0
    assert result["checks"]["missing_answers"]["value"] > 0


# ---------------------------------------------------------------------------
# The command and the import check
# ---------------------------------------------------------------------------

def _command(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "stereobench.run", "--workload",
         "middlebury03_q_d64.step_b128", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_command_without_card_exits_nonzero():
    proc = _command(REPO)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_command_without_the_port_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "stereobench"),
                    tmp_path / "stereobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = _command(str(tmp_path))
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    # The port's name begins with the JAX package's; it is not the JAX
    # package.
    assert "deepmatching_stereo_matching_tpu_torch" in sys.modules
    for name in ("jax.numpy", "deepmatching_stereo_matching_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert harness.forbidden_modules() == [name.split(".")[0]]
        monkeypatch.delitem(sys.modules, name)


def test_sample_reaches_both_halves():
    from stereobench.drive import positions
    for seed in range(50):
        picks = positions(np.random.default_rng(seed), 4, 2,
                          {0: "a", 2: "b", 5: "c"})
        slots = sorted(s for _, s in picks)
        assert slots[0] < 2 <= slots[1]
        assert all(entry in "abc" for entry, _ in picks)
    assert positions(np.random.default_rng(0), 8, 3, {}) \
        == [(None, s) for _, s in positions(np.random.default_rng(0), 8,
                                             3, {0: None})]
