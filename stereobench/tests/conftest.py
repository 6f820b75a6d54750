"""A small benchmark root for the CPU tests: a new configuration, traffic
mixes, limits, a per-layer metric and a traffic driver, written as files
beside a manifest, which the harness must find by name alone."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "stereobench")

TINY_TRAFFIC = {
    "step": {"driver": "step", "batch": 4, "pool_batches": 2,
             "check_pairs": 3, "trace_seconds": 0.5},
    "stream": {"driver": "stream", "strategy": "tiled", "batch": 4,
               "pool_pairs": 8, "check_pairs": 3, "trace_seconds": None},
    "online": {"driver": "online", "rate_hz": 20, "deadline_ms": 1000,
               "pool_pairs": 4, "check_pairs": 3, "trace_seconds": 0.2},
    "closed": {"driver": "tiny_closed", "pool_pairs": 3, "check_pairs": 2,
               "trace_seconds": None},
}
MOVES = {"step": "step_mpx_per_s", "stream": "stream_mpx_per_s",
         "online": "pairs_on_time_pct"}
# The cells that report an end-to-end metric but no per-layer one.
E2E_ONLY = {"closed": "pairs_on_time_pct"}
# A reader that exists only in the tiny root: the spans the run traced.
TINY_METRIC = '''"""tiny.spans: how many spans the traced window holds."""


def read(rec):
    return float(sum(len(v) for v in rec.trace.spans.values()))
'''
# A driver that exists only in the tiny root: one pair at a time through
# `api.match_stereo`, closed loop (the next as soon as the last returns),
# each on time within a second.
TINY_DRIVER = '''"""tiny_closed: closed-loop pairs through api.match_stereo."""

import dataclasses
import time

from stereobench import drive, synthetic


def run(ctx):
    pool = [(synthetic.to_rgb8(a), synthetic.to_rgb8(b))
            for a, b in ctx.pairs(ctx.traffic["pool_pairs"])]

    def serve(k):
        return ctx.port.api.match_stereo(*pool[k % len(pool)], ctx.cfg,
                                         impl=ctx.route, device=ctx.device)

    drive.warm_up(ctx, serve, 1)
    latency, answers = [], {}
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + ctx.seconds or len(latency) < len(pool):
        begin = time.perf_counter()
        res = serve(len(latency))
        latency.append(time.perf_counter() - begin)
        answers[(len(latency) - 1) % len(pool)] = dataclasses.asdict(res)
    keep = ctx.rng().choice(len(pool), ctx.traffic["check_pairs"],
                            replace=False)
    return drive.Outcome(
        values={"pairs_on_time_pct":
                100.0 * sum(x <= 1.0 for x in latency) / len(latency)},
        attempted=len(latency), failed=0, window_start=t0,
        samples=[pool[k] + (answers[int(k)],) for k in keep])
'''


def write_tiny_root(root: str) -> str:
    """A manifest with cells tiny.step, tiny.stream, tiny.online and
    tiny.closed on a 40x72, D=16 configuration on the 'torch' route, every
    per-layer metric of the repo's manifest plus `tiny.spans`, the repo's
    drivers plus `tiny_closed`, and their files."""
    sb = os.path.join(root, "stereobench")
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(sb, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "drivers"),
                    os.path.join(sb, "drivers"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(sb, "drivers", "tiny_closed.py"), "w") as f:
        f.write(TINY_DRIVER)
    with open(os.path.join(BENCH, "configs",
                           "middlebury03_q_d64.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny", height=40, width=72, route="torch",
                recipe={"block": 16})
    conf["config"]["max_disparity"] = 16
    with open(os.path.join(sb, "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"] = [{"name": "tiny", "source": "https://example.org",
                            "file": "stereobench/configs/tiny.json",
                            "reduced": [], "why": "tests"}]
    manifest["workloads"] = [
        {"name": f"tiny.{t}", "config": "tiny", "traffic": f"tiny_{t}",
         "chips": 1, "why": "tests"} for t in TINY_TRAFFIC]
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny.{t}" for t, e2e in
                              {**MOVES, **E2E_ONLY}.items()
                              if e2e == m["name"]]
    for m in manifest["per_layer"]:
        m["workloads"] = [f"tiny.{t}" for t, e2e in MOVES.items()
                          if e2e == m["moves"]]
        shutil.copy(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                    os.path.join(sb, "metrics"))
    manifest["per_layer"].append(
        {"name": "tiny.spans", "unit": "spans", "better": "lower",
         "source": "program_span", "layer": "pipeline",
         "moves": "step_mpx_per_s", "workloads": ["tiny.step"]})
    with open(os.path.join(sb, "metrics", "tiny.spans.py"), "w") as f:
        f.write(TINY_METRIC)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    limits = {"decisions_off": 0.002, "validity_off": 0.002,
              "disparity_off": 0.002, "right_off": 0.002, "score_err": 5e-5}
    for t, traffic in TINY_TRAFFIC.items():
        with open(os.path.join(sb, "traffic", f"tiny_{t}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(sb, "limits", f"tiny.{t}.json"), "w") as f:
            json.dump(limits, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tiny_root(str(tmp_path_factory.mktemp("tiny_bench")))


@pytest.fixture(autouse=True)
def no_warm_up_time(monkeypatch):
    """The tiny runs warm up each shape once, not for two seconds."""
    from stereobench import drive
    monkeypatch.setattr(drive, "WARMUP_SECONDS", 0.0)
