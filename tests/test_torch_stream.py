"""The port's stream runner (parallel/runner.py) on a world of 4 gloo ranks.

The eight cases of tests/test_runner.py, on the port: one world of 4
ranks per module (`launch.spawn`) runs every case once.  Each batch a
stream hands to `on_result` is held bitwise to the port's
`match_batch_sharded` on the same padded batch, and in decisions to the
JAX package's `run_stream` on a CPU mesh of the same shape ('exact' here,
'jnp' there).  `pairs_from_paths`: the native loader equals the Python
readers, and both equal the JAX package's planes.  The stream's one batch
ahead: uint8 colour pairs bitwise the direct path, arrays held from
`on_result` unchanged at the end, each `batch_done`'s `copy` and `ahead`,
a failure at the next batch's issue, and a resume onto the tail batch.
"""

import dataclasses
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu import Config as JConfig
from deepmatching_stereo_matching_tpu import parallel as jparallel
from deepmatching_stereo_matching_tpu.parallel import runner as jrunner
from deepmatching_stereo_matching_tpu_torch import native, parallel
from deepmatching_stereo_matching_tpu_torch.config import carry_over
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.parallel import launch, sharded
from deepmatching_stereo_matching_tpu_torch.utils.logging import JsonlLogger

H, W, D = 64, 96, 16
KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")
DECISIONS = ("disparity_raw", "valid", "disparity_right", "disparity")


def make_pairs(n, seed=0):
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, D, rng, block=16)
        left, right, _ = synthetic.make_pair(H, W, field, seed=seed + i)
        out.append((left, right))
    return out


def _collect(into):
    return lambda i, out: into.update({i: out})


def _direct(pairs, cfg, mesh, batch_size):
    """Each batch (tail padded with its last pair) through
    match_batch_sharded, cut to its real pairs."""
    out = {}
    for b, i in enumerate(range(0, len(pairs), batch_size)):
        chunk = pairs[i:i + batch_size]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch_size - real)
        lp, rp = (sharded.pad_batch([p[j] for p in chunk], cfg, H, W, mesh)
                  for j in (0, 1))
        got = sharded.match_batch_sharded(lp, rp, cfg, H, W, mesh,
                                          "tiled", "exact")
        out[b] = {k: v.cpu().numpy()[:real] for k, v in got.items()}
    return out


def colour_pairs(n, seed=40):
    """uint8 (H, W, 3) pairs whose channels differ, for the stream's raw
    path (`sharded.raw_batch`)."""
    rng = np.random.default_rng(seed)
    return [tuple(np.clip(np.round(x * 255)[..., None]
                          + rng.integers(-9, 10, (H, W, 3)), 0, 255)
                  .astype(np.uint8) for x in pair)
            for pair in make_pairs(n, seed)]


def _records(text):
    return [json.loads(line) for line in text.getvalue().splitlines()]


def _rank_stream(cfg):
    """Rank body: the eight runner cases on this world of 4 ranks."""
    res = {}
    pairs8 = make_pairs(8)
    mesh22 = parallel.make_mesh(2, 2)
    mesh14 = parallel.make_mesh(1, 4)

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "metrics.jsonl")
        with JsonlLogger(log_path) as logger:
            rep = parallel.run_stream(pairs8, cfg, H, W, mesh22, batch_size=4,
                                      route="exact",
                                      on_result=_collect(results),
                                      logger=logger)
        with open(log_path) as f:
            events = [json.loads(line)["event"] for line in f]
    res["complete"] = dict(report=dataclasses.asdict(rep), results=results,
                           events=events,
                           direct=_direct(pairs8, cfg, mesh22, 4))

    results = {}
    pairs5 = make_pairs(5)
    rep = parallel.run_stream(pairs5, cfg, H, W, mesh14, batch_size=4,
                              route="exact", on_result=_collect(results))
    res["tail"] = dict(report=dataclasses.asdict(rep), results=results,
                       direct=_direct(pairs5, cfg, mesh14, 4))

    seen = []
    parallel.run_stream(make_pairs(12), cfg, H, W, mesh14, batch_size=4,
                        route="exact", start_batch=2,
                        on_result=lambda i, out: seen.append(i))
    res["resume"] = seen

    calls = {"n": 0}

    def flaky(lp, rp):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected: lost rank")
        return parallel.match_batch_sharded(lp, rp, cfg, H, W, mesh14,
                                            "tiled", "exact")

    results = {}
    rep = parallel.run_stream(pairs8, cfg, H, W, mesh14, batch_size=4,
                              route="exact", on_result=_collect(results),
                              _match_fn=flaky)
    res["retry"] = dict(report=dataclasses.asdict(rep), results=results,
                        direct=_direct(pairs8, cfg, mesh14, 4))

    def dead(lp, rp):
        raise RuntimeError("injected: permanent failure")

    try:
        parallel.run_stream(make_pairs(4), cfg, H, W, mesh14, batch_size=4,
                            max_retries=1, _match_fn=dead)
        res["exhaust"] = None
    except RuntimeError as e:
        res["exhaust"] = str(e)

    # One batch ahead, uint8 colour pairs padded on the device: 10 pairs
    # in batches of 4 (a tail of 2), each batch's arrays snapshotted as
    # on_result gets them and held to the end of the stream.
    colour10 = colour_pairs(10)
    got, snaps, text = {}, {}, io.StringIO()

    def hold(i, out):
        got[i] = out
        snaps[i] = {k: v.copy() for k, v in out.items()}

    rep = parallel.run_stream(colour10, cfg, H, W, mesh22, batch_size=4,
                              route="exact", on_result=hold,
                              logger=JsonlLogger(stream=text))
    res["ahead"] = dict(report=dataclasses.asdict(rep), results=got,
                        snaps=snaps, records=_records(text),
                        direct=_direct(colour10, cfg, mesh22, 4))

    # A failure at the second batch's issue, which comes before the
    # first batch is collected.
    calls["n"] = 0
    order, text = [], io.StringIO()
    parallel.run_stream(pairs8, cfg, H, W, mesh14, batch_size=4,
                        route="exact",
                        on_result=lambda i, out: order.append(i),
                        logger=JsonlLogger(stream=text), _match_fn=flaky)
    res["retry_order"] = dict(order=order, records=_records(text))

    got, text = {}, io.StringIO()
    parallel.run_stream(colour10, cfg, H, W, mesh14, batch_size=4,
                        route="exact", start_batch=1,
                        on_result=_collect(got),
                        logger=JsonlLogger(stream=text))
    res["resume_tail"] = dict(results=got, records=_records(text),
                              direct=_direct(colour10, cfg, mesh14, 4))

    res["sweep"] = parallel.scaling_sweep(cfg, H, W, mesh_sizes=(1, 4),
                                          batch_size=2, n_batches=2,
                                          route="exact")
    res["sweep_wtiled"] = parallel.scaling_sweep(
        cfg, H, W, mesh_sizes=(4, 8), batch_size=2, n_batches=1,
        strategy="wtiled", route="exact", merge_level=1)
    return res


@pytest.fixture(scope="module")
def world():
    cfg = carry_over(JConfig(max_disparity=D))
    return launch.spawn(_rank_stream, 4, (cfg,), timeout=240)


def jax_stream(pairs, mesh_shape, batch_size=4):
    results = {}
    jparallel.run_stream(pairs, JConfig(max_disparity=D), H, W,
                         jparallel.make_mesh(*mesh_shape),
                         batch_size=batch_size, impl="jnp",
                         on_result=_collect(results))
    return results


def assert_batches(got, direct, jax_results):
    assert sorted(got) == sorted(direct) == sorted(jax_results)
    for b in got:
        for k in KEYS:
            np.testing.assert_array_equal(got[b][k], direct[b][k],
                                          err_msg=f"batch {b} {k}")
        for k in DECISIONS:
            np.testing.assert_array_equal(got[b][k],
                                          np.asarray(jax_results[b][k]),
                                          err_msg=f"batch {b} {k} vs JAX")


def test_stream_completes_and_reports(world):
    want = jax_stream(make_pairs(8), (2, 2))
    for rank in world:
        case = rank["complete"]
        assert case["report"]["batches_completed"] == 2
        assert case["report"]["pairs_completed"] == 8
        assert case["report"]["retries"] == 0
        assert case["results"][0]["disparity"].shape == (4, H, W)
        assert case["events"].count("batch_done") == 2
        assert case["events"][-1] == "stream_done"
        assert_batches(case["results"], case["direct"], want)


def test_stream_tail_batch_padding(world):
    """Padded tail slots are excluded from all accounting."""
    want = jax_stream(make_pairs(5), (1, 4))
    for rank in world:
        case = rank["tail"]
        rep = case["report"]
        assert rep["batches_completed"] == 2
        assert rep["pairs_completed"] == 5
        assert case["results"][1]["disparity"].shape == (1, H, W)
        assert rep["mpx_per_s"] <= 5 * H * W * 1e-6 / max(rep["seconds"],
                                                           1e-9)
        assert_batches(case["results"], case["direct"], want)


def test_stream_resume_skips_completed(world):
    assert [rank["resume"] for rank in world] == [[2]] * 4


def test_stream_retries_transient_failure(world):
    want = jax_stream(make_pairs(8), (1, 4))
    for rank in world:
        case = rank["retry"]
        assert case["report"]["batches_completed"] == 2
        assert case["report"]["retries"] == 1
        assert_batches(case["results"], case["direct"], want)


def test_stream_exhausts_retries(world):
    for rank in world:
        assert "permanent" in rank["exhaust"]


def test_stream_one_batch_ahead_equals_direct(world):
    """uint8 colour pairs padded on the device, one batch ahead: every
    batch, the tail's 2 pairs too, bitwise match_batch_sharded's."""
    for rank in world:
        case = rank["ahead"]
        assert case["report"]["batches_completed"] == 3
        assert case["report"]["pairs_completed"] == 10
        assert sorted(case["results"]) == sorted(case["direct"]) == [0, 1, 2]
        for b, want in case["direct"].items():
            for k in KEYS:
                np.testing.assert_array_equal(case["results"][b][k], want[k],
                                              err_msg=f"batch {b} {k}")


def test_stream_held_outputs_unchanged(world):
    """Arrays handed to on_result and held to the stream's end read as
    they did when handed over: no later batch writes into them."""
    for rank in world:
        case = rank["ahead"]
        for b, snap in case["snaps"].items():
            for k in KEYS:
                np.testing.assert_array_equal(case["results"][b][k], snap[k],
                                              err_msg=f"batch {b} {k}")


def test_stream_batch_done_copy_and_ahead(world):
    """On the CPU the copies are pageable; every batch but the last is
    collected after the next one was issued."""
    for rank in world:
        done = [r for r in rank["ahead"]["records"]
                if r["event"] == "batch_done"]
        assert [r["batch"] for r in done] == [0, 1, 2]
        assert [r["pairs"] for r in done] == [4, 4, 2]
        assert [r["pad"] for r in done] == ["device"] * 3
        assert [r["copy"] for r in done] == ["pageable"] * 3
        assert [r["ahead"] for r in done] == [True, True, False]


def test_stream_retry_at_issue_keeps_order(world):
    """The second batch's issue fails before the first is collected: it
    is retried as batch 1, and batch 0 still arrives once, first."""
    for rank in world:
        case = rank["retry_order"]
        assert case["order"] == [0, 1]
        events = [(r["event"], r.get("batch")) for r in case["records"]
                  if r["event"] in ("batch_retry", "batch_done")]
        assert events == [("batch_retry", 1), ("batch_done", 0),
                          ("batch_done", 1)]


def test_stream_resume_with_tail(world):
    """start_batch 1 of 3: batch 0 is never issued, and the tail batch
    keeps its 2 real pairs."""
    for rank in world:
        case = rank["resume_tail"]
        assert sorted(case["results"]) == [1, 2]
        for b in (1, 2):
            for k in KEYS:
                np.testing.assert_array_equal(case["results"][b][k],
                                              case["direct"][b][k],
                                              err_msg=f"batch {b} {k}")
        done = [r for r in case["records"] if r["event"] == "batch_done"]
        assert [(r["batch"], r["pairs"], r["ahead"]) for r in done] == [
            (1, 4, True), (2, 2, False)]


def test_init_distributed_single_host_noop():
    assert parallel.init_distributed() == 0
    assert not torch.distributed.is_initialized()


def test_scaling_sweep_reports_efficiency(world):
    """Rank 0 is in both meshes; ranks 1-3 only in the one of 4."""
    for r, rank in enumerate(world):
        rows = rank["sweep"]
        assert [row["devices"] for row in rows] == ([1, 4] if r == 0
                                                    else [4])
        assert rows[0]["scaling_efficiency"] == 1.0
        assert all(row["mpx_per_s"] > 0 for row in rows)
    assert world[0]["sweep"][0]["mesh"] == {"data": 1, "model": 1}
    assert world[0]["sweep"][1]["mesh"] == {"data": 2, "model": 2}


def test_scaling_sweep_wtiled(world):
    """Sizes above the world (8) are skipped."""
    for rank in world:
        rows = rank["sweep_wtiled"]
        assert [row["devices"] for row in rows] == [4]
        assert rows[0]["mesh"]["th"] * rows[0]["mesh"]["tw"] == 2
        assert rows[0]["mpx_per_s"] > 0


def _write_pairs(tmp_path, pairs):
    paths = ([], [])
    for i, pair in enumerate(pairs):
        for side, img in enumerate(pair):
            path = str(tmp_path / f"{i}_{'lr'[side]}.pgm")
            native.write_pnm(path, img)
            paths[side].append(path)
    return paths


def _rank_pairs_from_paths(paths, cfg, disable_native):
    if disable_native:
        native.available = lambda: False
    mesh = parallel.make_mesh(1, 1)
    return [tuple(np.asarray(x) for x in pair)
            for pair in parallel.pairs_from_paths(*paths, cfg, H, W, mesh)]


def test_pairs_from_paths_native_equals_python_and_jax(tmp_path):
    if not native.available():
        pytest.skip(f"native build unavailable: {native.build_error()}")
    u8 = [tuple(np.round(x * 255).astype(np.uint8) for x in pair)
          for pair in make_pairs(3, seed=20)]
    paths = _write_pairs(tmp_path, u8)
    cfg = carry_over(JConfig(max_disparity=D))
    with_native, = launch.spawn(_rank_pairs_from_paths, 1,
                                (paths, cfg, False), timeout=120)
    python, = launch.spawn(_rank_pairs_from_paths, 1, (paths, cfg, True),
                           timeout=120)
    want = list(jrunner.pairs_from_paths(
        *paths, JConfig(max_disparity=D), H, W, jparallel.make_mesh(1, 1)))
    assert len(with_native) == len(python) == len(want) == 3
    for a, b, c in zip(with_native, python, want):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, np.asarray(z))
