"""The program's own spans (`dm.`, `utils/logging.span`) under the
benchmark's tracer: the reader finds none of them among its spans and no
device-side range of them among its device operations, so every metric
reads a traced run as it read the program without them.  On the card the
device work that the profiler charges to `dm.pipeline.step` is the step's
busy time (`kernels.busy_ms.step`'s count), so the stages split that time
and nothing else.  On the card: `python -m pytest stereobench/tests -m
card`."""

import numpy as np
import pytest
import torch

from stereobench import tracing

from deepmatching_stereo_matching_tpu_torch import api, profile_steps
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.models import pipeline

STEPS = 3


def _planes(n, h, w, cfg, device):
    rng = np.random.default_rng(7)
    return [torch.from_numpy(np.stack([
        api.preprocess(rng.random((h, w), dtype=np.float32), cfg, h, w)
        for _ in range(n)])).to(device) for _ in (0, 1)]


def _traced_steps(h, w, max_d, n, device):
    """(tracer's trace, the profile it read) over STEPS steps, each in
    the harness's `step` span as the step driver opens it."""
    cfg = Config(max_disparity=max_d)
    geom = cfg.geometry(h, w)
    lp, rp = _planes(n, h, w, cfg, device)
    step = lambda: pipeline.match_padded_core(lp, rp, cfg, geom,  # noqa
                                              "fused")
    tracer = tracing.Tracer(True, device.type == "cuda")
    tracer.prime(step)
    tracer.start()
    for _ in range(STEPS):
        with tracer.span("step"):
            step()
    tracer.stop()
    prof = tracer._done
    return tracer.read(), prof


def _assert_unseen(trace, prof):
    assert set(trace.spans) == {"step"}
    assert not [n for n, _, _ in trace.device_ops if n.startswith("dm.")]
    ours = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith("dm.")]
    assert ours and all(
        ev.device_type() == torch.autograd.DeviceType.CPU for ev in ours)


def test_reader_skips_program_spans_on_cpu():
    trace, prof = _traced_steps(48, 64, 16, 2, torch.device("cpu"))
    _assert_unseen(trace, prof)
    assert len(trace.spans["step"]) == STEPS


@pytest.mark.card
@pytest.mark.parametrize("h,w,max_d,n", [(375, 450, 64, 8),
                                         (375, 1242, 256, 2)],
                         ids=["k1", "k4_k5"])
def test_step_stages_hold_the_busy_time(card, h, w, max_d, n):
    trace, prof = _traced_steps(h, w, max_d, n, card)
    _assert_unseen(trace, prof)
    busy = tracing.device_seconds_per(trace, "step") * 1e3
    rows = {name: dev for name, _, _, dev, _ in
            profile_steps.stage_rows(prof.events(), STEPS)}
    assert rows["dm.pipeline.step"] == pytest.approx(busy, rel=0.01)
    assert 0 < rows["dm.pipeline.match"] < rows["dm.pipeline.step"]
