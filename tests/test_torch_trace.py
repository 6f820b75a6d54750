"""The port's own profiler spans (`utils/logging.span`) on the CPU.

Each entry point (the stream, the API, the step, and the step on the
large-D route) records its stages as `dm.` ranges under a CPU-only
`torch.profiler`, nested as the stages are; the outputs are bitwise the
same with the profiler on and off; each span is a profiler op, not a
user annotation, so a CUDA trace holds no device-side range of it; a call
that raises inside a span leaves no range open; with no profiler active,
`span` is the one shared null context and no range is entered; and
`profile_steps.stage_rows` counts each span's calls and time per step.
"""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepmatching_stereo_matching_tpu_torch import api, profile_steps
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda
from deepmatching_stereo_matching_tpu_torch.parallel import launch, mesh
from deepmatching_stereo_matching_tpu_torch.parallel import runner
from deepmatching_stereo_matching_tpu_torch.utils import logging as dm_log

STREAM_BATCHES = 3
STEP = ["dm.pipeline.flip", "dm.pipeline.match", "dm.pipeline.flip",
        "dm.pipeline.lr_check", "dm.pipeline.outputs"]
# Each span's children in order; a name not listed has none.
CHILDREN = {
    "dm.stream.batch": ["dm.stream.pad", "dm.stream.copy_in",
                        "dm.stream.match", "dm.stream.wait",
                        "dm.stream.copy_out", "dm.stream.on_result"],
    "dm.stream.match": ["dm.pipeline.step"],
    "dm.api.match_stereo": ["dm.api.preprocess", "dm.api.copy_in"] * 2
    + ["dm.api.match", "dm.api.wait", "dm.api.copy_out"],
    "dm.api.match": ["dm.pipeline.step"],
    "dm.pipeline.step": STEP,
}
LARGE_D_MATCH = ["dm.pipeline.cost", "dm.pipeline.aggregate",
                 "dm.pipeline.walk"]
# (height, width, max_disparity): K1's plain version; K4 -> K5's.
SIZES = {"k1": (48, 64, 16), "large_d": (128, 320, 256)}


def _pairs(n, h, w, d):
    out = []
    for i in range(n):
        field = synthetic.block_disparity_field(
            h, w, d, np.random.default_rng(i), block=16)
        left, right, _ = synthetic.make_pair(h, w, field, seed=i)
        out.append((left, right))
    return out


def _host(out):
    return {k: np.asarray(v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items() if v is not None}


def _stream(tmp_path):
    h, w, d = SIZES["k1"]
    cfg = Config(max_disparity=d)
    pairs = _pairs(2 * STREAM_BATCHES, h, w, d)
    worlds = itertools.count()

    def run():
        got = {}
        launch.init("gloo", 0, 1, str(tmp_path / f"rdv{next(worlds)}"))
        try:
            runner.run_stream(pairs, cfg, h, w, mesh.make_mesh(1, 1),
                              "tiled", 2, "fused",
                              on_result=lambda i, o: got.update(
                                  {f"{i}.{k}": v for k, v in o.items()}))
        finally:
            torch.distributed.destroy_process_group()
        return got
    return run, ["dm.stream.batch"] * STREAM_BATCHES, []


def _api(tmp_path):
    h, w, d = SIZES["k1"]
    (left, right), = _pairs(1, h, w, d)
    rgb = [np.repeat((x * 255).astype(np.uint8)[..., None], 3, -1)
           for x in (left, right)]

    def run():
        res = api.match_stereo(*rgb, Config(max_disparity=d), impl="fused",
                               device="cpu")
        return _host(vars(res))
    return run, ["dm.api.match_stereo"], []


def _step(size):
    def case(tmp_path):
        h, w, d = SIZES[size]
        cfg = Config(max_disparity=d)
        geom = cfg.geometry(h, w)
        assert fused_cuda.supported(cfg, geom) == (size == "k1")
        pairs = _pairs(2, h, w, d)
        lp, rp = (torch.from_numpy(np.stack([
            api.preprocess(p[j], cfg, h, w) for p in pairs]))
            for j in (0, 1))

        def run():
            return _host(pipeline.match_padded_core(lp, rp, cfg, geom,
                                                    "fused"))
        return run, ["dm.pipeline.step"], (LARGE_D_MATCH if size == "large_d"
                                           else [])
    return case


def _tree(prof):
    """The `dm.` host ranges as (name, children) trees, in time order.
    Each is a profiler op: an annotation would get a device-side range
    under CUDA activity."""
    ours = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith(dm_log.PREFIX)]
    assert all(ev.device_type() == torch.autograd.DeviceType.CPU
               and not ev.is_user_annotation() for ev in ours)
    events = sorted((ev.start_ns(), -ev.duration_ns(), ev.name())
                    for ev in ours)
    roots, stack = [], []
    for start, neg_dur, name in events:
        node = (name, [])
        while stack and stack[-1][0] <= start:
            stack.pop()
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((start - neg_dur, node))
    return roots


def _check_nesting(node, match_children):
    name, children = node
    want = (match_children if name == "dm.pipeline.match"
            else CHILDREN.get(name, []))
    assert [c[0] for c in children] == want, name
    for child in children:
        _check_nesting(child, match_children)


@pytest.mark.parametrize("entry", [_stream, _api, _step("k1"),
                                   _step("large_d")],
                         ids=["stream", "api", "step", "step_large_d"])
def test_entry_point_spans(entry, tmp_path, monkeypatch):
    run, roots, match_children = entry(tmp_path)
    real = dm_log._op_range
    entered = []

    def recording(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(dm_log, "_op_range", recording)

    off = run()
    assert entered == []                  # no profiler: nothing entered
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    assert off.keys() == on.keys()
    for k in off:                         # bitwise, NaN equal to NaN
        np.testing.assert_array_equal(off[k], on[k], err_msg=k)

    tree = _tree(prof)
    assert [name for name, _ in tree] == roots
    for node in tree:
        _check_nesting(node, match_children)
    assert len(entered) == sum(map(_count, tree))


def _count(node):
    return 1 + sum(map(_count, node[1]))


def test_api_span_closes_when_the_call_raises(tmp_path):
    run, _, _ = _api(tmp_path)
    small = np.zeros((8, 8), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            api.match_stereo(small, np.zeros((8, 9), np.uint8), device="cpu")
        run()
    # The failed call's range closed before the next call opened: two
    # roots, the second with all of its stages.
    first, second = _tree(prof)
    assert first == ("dm.api.match_stereo", [])
    _check_nesting(second, [])


def test_span_without_profiler_is_one_null_context(monkeypatch):
    def refuse(*args):
        raise AssertionError("a profiler range entered with no profiler")
    monkeypatch.setattr(dm_log, "_op_range", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = dm_log.span("pipeline.step"), dm_log.span("stream.batch")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError):
            dm_log.span("pipeline.step")


def test_stage_rows_count_each_span_per_step():
    run, _, _ = _step("k1")(None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        run()
    rows = {name: (calls, host, dev, ops) for name, calls, host, dev, ops
            in profile_steps.stage_rows(prof.events(), 2)}
    assert {k: v[0] for k, v in rows.items()} == {
        "dm.pipeline.step": 1, "dm.pipeline.flip": 2, "dm.pipeline.match": 1,
        "dm.pipeline.lr_check": 1, "dm.pipeline.outputs": 1}
    # A span's host time holds its children's; no device work on the CPU.
    inner = sum(v[1] for k, v in rows.items() if k != "dm.pipeline.step")
    assert 0 < inner <= rows["dm.pipeline.step"][1]
    assert all(v[2:] == (0, 0) for v in rows.values())
