"""The trace arithmetic the device readers use, on a made-up trace (the
CPU runs record no device operations)."""

import pytest

from stereobench import tracing


@pytest.fixture
def trace():
    return tracing.Trace(
        window_s=1.0,
        spans={"step": [(0.0, 0.1), (0.2, 0.3)], "outer": [(0.0, 0.5)]},
        device_ops=[("k1", 0.05, 0.15), ("k1", 0.1, 0.2), ("copy", 0.9, 1.2),
                    ("early", -0.3, -0.1)])


def test_busy_and_idle(trace):
    assert tracing.busy_seconds(trace) == pytest.approx(0.25)
    assert tracing.idle_share(trace) == pytest.approx(0.75)
    assert tracing.busy_seconds(trace, within=[(0.0, 0.1), (0.05, 0.12)]) \
        == pytest.approx(0.07)
    # Summed, not merged: each step's operations counted once each.
    assert tracing.device_seconds_per(trace, "step") == pytest.approx(0.15)
    assert tracing.device_seconds_per(trace, "absent") is None
    empty = tracing.Trace(window_s=1.0, spans={"step": [(0, 1)]},
                          device_ops=[])
    assert tracing.idle_share(empty) is None
    assert tracing.device_seconds_per(empty, "step") is None


def test_gaps_take_the_innermost_open_span(trace):
    # 0-0.05: its middle lies in `step` and in `outer`, `step` opened
    # later; 0.2-0.9: its middle, 0.55, lies in no span.
    gaps = tracing.idle_gaps(trace)
    assert [label for label, _ in gaps] == ["step", "none"]
    assert [sec for _, sec in gaps] == pytest.approx([0.05, 0.7])
    b = tracing.breakdown(trace)
    # Operations outside the window count for nothing, and none below 0.
    assert b["device_ops"] == [["k1", pytest.approx(0.2)],
                               ["copy", pytest.approx(0.1)]]
    assert b["idle_gaps"] == [["none", pytest.approx(0.7)],
                              ["step", pytest.approx(0.05)]]
