"""The step's epilogue (EPI, csrc/epilogue.cu) on the CPU.

`pipeline.lr_outputs` on CPU tensors is the plain chain
(`lr_consistency_patch`, then `pixel_outputs`), bitwise; a NumPy
emulation of the kernel's threads (floor division, the sentinel read left
of the map, torch's int32 difference and float32 compare with tau, the
score's compare) gives the plain chain's bits on maps built for the
check's edges; the wrapper refuses what the kernel does not take and
launches nothing then; through the wrapper, with the emulation in place
of the library, every step route, `dslab` and `ringd` give the plain
chain's outputs, one EPI launch a step and no `pipeline.lr_check` span;
the work model; the source note; the benchmark's reader.  The kernel
itself is held on the card by tests/test_torch_epilogue_card.py.
"""

import contextlib
import ctypes
import importlib.util
import math
import os
import re
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu.models import pipeline as jpipeline
from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.data import synthetic
from deepmatching_stereo_matching_tpu_torch.models import pipeline
from deepmatching_stereo_matching_tpu_torch.ops import _build, epilogue_cuda
from deepmatching_stereo_matching_tpu_torch.parallel import launch
from stereobench import tracing

from epilogue_cases import (FAR_TAU, KEYS, assert_same, config, patch_maps,
                            plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "deepmatching_stereo_matching_tpu_torch", "csrc",
                      "epilogue.cu")
SENTINEL = -2 ** 30


def _tensors(lead, h0, w0, d, p, seed, lr=True, far=False):
    disp, score, right = patch_maps(lead, h0, w0, d, p, seed, far)
    return (torch.from_numpy(disp), torch.from_numpy(score),
            torch.from_numpy(right) if lr else None)


@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("tau", [1.0, 1.5, 0.3])
@pytest.mark.parametrize("min_score", [0.0, 0.25])
@pytest.mark.parametrize("lr", [True, False])
def test_lr_outputs_on_cpu_is_the_plain_chain(lr, min_score, tau, p):
    disp, score, right = _tensors((2,), 5, 9, 16, p, seed=p, lr=lr)
    cfg = config(p, tau, min_score, float("nan"))
    assert_same(pipeline.lr_outputs(disp, score, right, cfg, 16),
                plain(disp, score, right, cfg, 16))


def emulate(disp, score, disp_r, n, h0, w0, p, tau, use_min, min_score,
            invalid):
    """csrc/epilogue.cu's lr_outputs_kernel, every thread (pixel row y,
    patch column J) at once, in NumPy: its floor division, its sentinel
    read, its int32 difference and abs that wrap, its float32 compares.
    numpy (n, h0, w0) maps in, the five (n, h0 p, w0 p) maps out."""
    tau, min_score, invalid = (np.float32(v) for v in (tau, min_score,
                                                       invalid))
    rows = n * h0 * p
    y = np.arange(rows)[:, None]
    J = np.arange(w0)[None, :]
    row0 = y // p
    dl = disp.reshape(-1, w0)[row0, J]
    s = score.reshape(-1, w0)[row0, J]
    ok_a = ok_b = np.ones((rows, w0), bool)
    r = np.zeros((rows, w0), np.int64)
    reach = np.full((rows, w0), np.iinfo(np.int64).min)
    dr = np.zeros((rows, w0), np.int32)
    if disp_r is not None:
        right = disp_r.reshape(-1, w0)
        dr = right[row0, J]
        dl64 = dl.astype(np.int64)
        q = np.where(dl64 >= 0, dl64 // p, -((-dl64 + p - 1) // p))
        r = dl64 - q * p

        def right_at(j):
            inside = (j >= 0) & (j < w0)
            return np.where(inside, right[row0, np.clip(j, 0, w0 - 1)],
                            np.int32(SENTINEL)).astype(np.int32)

        def within(a, b):
            d = a.view(np.uint32) - b.view(np.uint32)
            m = np.where(d.view(np.int32) < 0, np.uint32(0) - d, d)
            return m.view(np.int32).astype(np.float32) <= tau

        ok_a = within(dl, right_at(J - q))
        ok_b = within(dl, right_at(J - q - 1))
        reach = dl64 - J * p
    score_ok = ~np.bool_(use_min) | (s >= min_score)
    out = {k: np.empty((rows, w0 * p), dt) for k, dt in (
        ("disparity", np.float32), ("disparity_raw", np.int32),
        ("valid", np.bool_), ("score", np.float32),
        ("disparity_right", np.int32))}
    d = dl.astype(np.float32)
    for c in range(p):
        v = score_ok & np.where(c >= r, ok_a, ok_b) & (c >= reach)
        out["disparity"][:, c::p] = np.where(v, d, invalid)
        out["disparity_raw"][:, c::p] = dl
        out["valid"][:, c::p] = v
        out["score"][:, c::p] = s
        out["disparity_right"][:, c::p] = dr
    return {k: v.reshape(n, h0 * p, w0 * p) for k, v in out.items()}


# (lead, h0, w0, D, p, tau, min_score, invalid, lr, far)
EMULATED = {
    "bench_grid": ((1,), 96, 128, 64, 4, 1.0, 0.0, float("nan"), True,
                   False),
    "kitti_grid": ((1,), 96, 384, 256, 4, 1.0, 0.0, float("nan"), True,
                   False),
    "lead_frac_tau_min_score": ((2, 3), 7, 33, 64, 4, 1.5, 0.25, -1.0,
                                True, False),
    "tie_at_two": ((3,), 11, 40, 32, 4, 2.0, 0.5, float("nan"), True,
                   False),
    "far_tau": ((2,), 6, 50, 64, 4, FAR_TAU, 0.0, float("nan"), True,
                True),
    "far": ((2,), 6, 50, 64, 4, 1.0, 0.0, float("nan"), True, True),
    "p3": ((2,), 9, 31, 30, 3, 1.0, 0.25, float("nan"), True, False),
    "p5_no_lr": ((2,), 5, 12, 40, 5, 1.0, 0.25, 7.0, False, False),
    "p1": ((2,), 4, 70, 16, 1, 0.5, 0.0, float("nan"), True, False),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_emulated_kernel_is_the_plain_chain(name):
    lead, h0, w0, d, p, tau, min_score, invalid, lr, far = EMULATED[name]
    disp, score, right = _tensors(lead, h0, w0, d, p, len(name), lr, far)
    cfg = config(p, tau, min_score, invalid)
    want = plain(disp, score, right, cfg, d)
    n = math.prod(lead)
    got = emulate(disp.numpy(), score.numpy(),
                  None if right is None else right.numpy(), n, h0, w0, p,
                  tau, min_score > 0, min_score, invalid)
    assert_same({k: torch.from_numpy(v).reshape(want[k].shape)
                 for k, v in got.items()}, want)


def test_maps_hold_the_edges():
    """The built maps reach what the check has to get right: dL past the
    pixel column, the sentinel's columns, |dL - dR| equal to 1 and 2 at
    the columns read, NaN scores, and (with far) a difference of 2^24 + 1
    and one that wraps to INT32_MIN in int32."""
    p, d = 4, 64
    disp, score, right = patch_maps((2,), 8, 40, d, p, seed=3, far=True)
    x = np.arange(40) * p
    assert (disp > x).any() and (disp // p > np.arange(40)).any()
    q = disp // p
    j = np.arange(40) - q
    rows = np.broadcast_to(np.arange(8)[None, :, None], disp.shape)
    lead = np.broadcast_to(np.arange(2)[:, None, None], disp.shape)
    inside = j >= 0
    read = right[lead[inside], rows[inside], j[inside]].astype(np.int64)
    diff = disp[inside] - read
    assert (np.abs(diff) == 1).any() and (np.abs(diff) == 2).any()
    assert (diff == 2 ** 31).any() and (diff == 2 ** 24 + 1).any()
    assert np.isnan(score).any() and (score == 0.25).any()


def _fake_launch(calls):
    """_build.launch for the epilogue with the emulation in place of the
    library: reads the maps at the arguments' addresses (CPU tensors),
    writes the outputs there, and counts the launch."""
    def view(ptr, dtype, shape):
        nbytes = math.prod(shape) * np.dtype(dtype).itemsize
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def fake(kernel, symbol, device, *args, count=1):
        assert (kernel, symbol) == ("EPI", "dm_lr_outputs")
        (disp, score, right, out, raw, valid, score_px, right_px, n, h0, w0,
         p, tau, use_min, min_score, invalid) = args
        maps = (n, h0, w0)
        got = emulate(view(disp, np.int32, maps), view(score, np.float32,
                                                        maps),
                      None if right is None else view(right, np.int32, maps),
                      n, h0, w0, p, tau, use_min, min_score, invalid)
        px = (n, h0 * p, w0 * p)
        for key, ptr, dtype in (("disparity", out, np.float32),
                                ("disparity_raw", raw, np.int32),
                                ("valid", valid, np.bool_),
                                ("score", score_px, np.float32),
                                ("disparity_right", right_px, np.int32)):
            view(ptr, dtype, px)[...] = got[key]
        calls.append(args)
        _build.launches[kernel] += count
    return fake


@pytest.fixture
def emulated_card(monkeypatch):
    """EPI's dispatch forced to the card's side and its launch emulated;
    -> the launches' arguments and the spans opened."""
    calls, spans = [], []
    monkeypatch.setattr(pipeline, "run_kernel", lambda *t: True)
    monkeypatch.setattr(epilogue_cuda, "run_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch", _fake_launch(calls))
    monkeypatch.setattr(_build, "launches", Counter())
    real_span = pipeline.span

    @contextlib.contextmanager
    def span(name):
        spans.append(name)
        with real_span(name):
            yield
    monkeypatch.setattr(pipeline, "span", span)
    return SimpleNamespace(calls=calls, spans=spans)


def _padded_pairs(n, h, w, d, cfg, geom):
    lefts, rights = [], []
    for i in range(n):
        field = synthetic.block_disparity_field(
            h, w, d, np.random.default_rng(i), block=16)
        left, right, _ = synthetic.make_pair(h, w, field, seed=i)
        for img, out in ((left, lefts), (right, rights)):
            pad = np.zeros((geom.padded_height, geom.padded_width),
                           np.float32)
            pad[:h, :w] = img
            out.append(pad)
    return torch.from_numpy(np.stack(lefts)), torch.from_numpy(
        np.stack(rights))


# (route, Config kwargs): the step routes that end in the epilogue.
STEPS = {
    "fused_flip": ("fused", {}),
    "fused_no_lr": ("fused", {"lr_check": False}),
    "exact_direct": ("exact", {"lr_mode": "direct"}),
    "torch_flip_min_score": ("torch", {"min_score": 0.3, "tau": 1.5}),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_through_the_wrapper_is_plain(name, emulated_card, monkeypatch):
    route, kw = STEPS[name]
    h, w, d = 48, 64, 16
    cfg = Config(max_disparity=d, **kw)
    geom = cfg.geometry(h, w)
    lp, rp = _padded_pairs(2, h, w, d, cfg, geom)
    got = pipeline.match_padded_core(lp, rp, cfg, geom, route)
    assert _build.launches == Counter(EPI=1)
    assert "pipeline.lr_check" not in emulated_card.spans
    assert emulated_card.spans[-1] == "pipeline.outputs"
    monkeypatch.undo()
    assert_same(got, pipeline.match_padded_core(lp, rp, cfg, geom, route))


@pytest.mark.parametrize("strategy", ["dslab", "ringd"])
@pytest.mark.parametrize("lr_check", [True, False])
def test_strategies_through_the_wrapper_are_plain(strategy, lr_check,
                                                  emulated_card, monkeypatch,
                                                  tmp_path):
    """dslab and ringd hand the epilogue the maps it takes (int32, float32,
    one shape; a right map with the check) and get the plain chain's
    outputs: on a world of one gloo rank, through the wrapper with the
    emulated launch, and again with the plain chain."""
    h, w, d = 48, 64, 16
    rng = np.random.default_rng(5)
    case = dict(cfg=Config(max_disparity=d, lr_check=lr_check),
                strategy=strategy, mesh=(1, 1), route="exact", height=h,
                width=w, lefts=[rng.random((h, w), dtype=np.float32)
                                for _ in range(2)],
                rights=[rng.random((h, w), dtype=np.float32)
                        for _ in range(2)])
    launch.init("gloo", 0, 1, str(tmp_path / "rdv"))
    try:
        got, = launch.match_cases([case])
        assert _build.launches == Counter(EPI=1)
        assert (emulated_card.calls[0][2] is None) == (not lr_check)
        monkeypatch.undo()
        want, = launch.match_cases([case])
    finally:
        torch.distributed.destroy_process_group()
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cpu_tensors_are_refused():
    disp, score, right = _tensors((1,), 4, 8, 16, 4, seed=0)
    before = _build.launches.copy()
    with pytest.raises(ValueError, match="CUDA tensors"):
        epilogue_cuda.lr_outputs(disp, score, right, 1.0, 4, 0.0,
                                 float("nan"))
    assert _build.launches == before


@pytest.mark.parametrize("bad", ["int64_disp", "float64_score",
                                 "int64_right", "shapes", "one_dim",
                                 "patch_size"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, monkeypatch):
    monkeypatch.setattr(epilogue_cuda, "run_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launches", Counter())
    disp, score, right = _tensors((1,), 4, 8, 16, 4, seed=0)
    p = 4
    if bad == "int64_disp":
        disp = disp.long()
    elif bad == "float64_score":
        score = score.double()
    elif bad == "int64_right":
        right = right.long()
    elif bad == "shapes":
        right = right[..., :-1]
    elif bad == "one_dim":
        disp, score, right = (t.reshape(-1) for t in (disp, score, right))
    else:
        p = 0
    with pytest.raises((TypeError, ValueError)):
        epilogue_cuda.lr_outputs(disp, score, right, 1.0, p, 0.0,
                                 float("nan"))
    assert _build.launches == Counter()


@pytest.mark.parametrize("cell,n,h0,w0,total,ms", [
    ("middlebury03_q_d64.step_b128", 128, 96, 128, 446_693_376, 0.1333),
    ("kitti15_d256.step_b32", 32, 96, 384, 335_020_032, 0.1000),
    ("middlebury14_f_d290.step_b16", 16, 512, 768, 1_786_773_504, 0.5334),
])
def test_work_model_at_the_step_cells(cell, n, h0, w0, total, ms):
    """12 B a patch read, 17 B a pixel written: 17.75 B a pixel at p = 4,
    the bytes of the plain chain's inputs and outputs."""
    model = work.epilogue(n, h0, w0, 4)
    assert model.total_bytes == total and model.total_ops == 0
    assert total == n * h0 * w0 * 16 * 17.75
    t, by = work.bound(model)
    assert by == "bytes" and t * 1e3 == pytest.approx(ms, abs=1e-4)
    disp, score, right = _tensors((1,), 3, 5, 16, 4, seed=1)
    out = plain(disp, score, right, config(4, 1.0, 0.0, 0.0), 16)
    small = work.epilogue(1, 3, 5, 4)
    assert small.total_bytes == sum(t.nbytes for t in (
        disp, score, right, *out.values()))
    assert work.epilogue(1, 3, 5, 4, lr=False).total_bytes == (
        small.total_bytes - right.nbytes)


def test_source_note_names_what_it_stands_in_for():
    """The note names the JAX functions the epilogue computes, which
    exist, and the byte counts that bound the kernel."""
    with open(SOURCE) as f:
        note = f.read().split("#include")[0]
    assert "deepmatching_stereo_matching_tpu/models/pipeline.py" in note
    for fn in ("lr_consistency_patch_padded", "densify"):
        assert fn in note and callable(getattr(jpipeline, fn))
    assert "446,693,376 B" in note and "0.1333 ms" in note
    assert "Replaces no TPU kernel" in note
    with open(SOURCE) as f:
        sentinel = re.search(r"constexpr int kSentinel = (-\d+);", f.read())
    assert int(sentinel[1]) == pipeline._SENTINEL == SENTINEL


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"),
        os.path.join(REPO, "stereobench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_reader():
    """kernels.epilogue_ms.step: the device operations named after the
    kernel's symbol (and no other kernel's), clipped to the window, over
    the harness's steps; None without them (the parent's program, no
    card) or without a step."""
    reader = _reader("kernels.epilogue_ms.step")
    read = reader.read
    assert reader.KERNEL == epilogue_cuda.KERNEL
    kernel = ("void (anonymous namespace)::lr_outputs_kernel<4, true>"
              "((anonymous namespace)::Maps, long long, int, int, float, "
              "int, float, float)")
    others = ["void (anonymous namespace)::fused_kernel<4>(...)",
              "void (anonymous namespace)::costrows_kernel<4, float>(...)",
              "void (anonymous namespace)::aggregate_kernel<false>(...)",
              "void (anonymous namespace)::magbin_planes_kernel<true>(...)",
              "void at::native::vectorized_elementwise_kernel<4>"]
    ops = [(kernel, 0.10, 0.1003), (others[0], 0.1003, 0.103),
           (kernel, 0.20, 0.2003), (others[4], 0.3, 0.31),
           (kernel, 0.999, 1.001)]              # clipped to the window

    def rec(device_ops, steps):
        return SimpleNamespace(trace=tracing.Trace(
            window_s=1.0, spans={"step": [(0.1 * i, 0.1 * i + 0.05)
                                          for i in range(steps)]},
            device_ops=device_ops))
    assert read(rec(ops, 2)) == pytest.approx((0.0003 * 2 + 0.001) / 2
                                              * 1e3)
    assert read(rec([(o, 0.1, 0.2) for o in others], 2)) is None
    assert read(rec(ops, 0)) is None
    assert not any(reader.KERNEL in o for o in others)
    for name in ("costrows_kernel", "aggregate_kernel",
                 "magbin_planes_kernel", "fused_kernel"):
        assert name not in kernel
