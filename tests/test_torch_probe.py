"""P1-P3, the streaming mul/add probes (ops/probe_cuda.py), on the CPU.

The JAX probes are closures inside `tools/vpu_ceiling.py:main`, which
runs them on the TPU and cannot be called without running that script,
so the plain versions are held here (bitwise) to a numpy statement of
the same sums in the same order: per output element, over 64 planes,
plane = ((t0 + t1) + t2) + t3 with t_i the schedule's products, and
total = total + plane.  The CUDA kernels are held bitwise to these plain
versions on the card by chip_smoke.py.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.ops import probe_cuda
from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.tools import vpu_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def numpy_probe(a, name):
    """The probe's sums in numpy, one f32 op at a time, in the TPU order."""
    total = None
    for d in range(probe_cuda.NPLANES):
        acc = None
        for i in range(4):
            k = 4 * d + i
            if name == "shift":
                j1, j2, o = probe_cuda.TRIPS[k]
                t = a[j1, :, :128] * a[j2, :, o:o + 128]
            else:
                j1, j2 = probe_cuda.PAIRS[k]
                rows = 96 if name == "small" else a.shape[1]
                t = a[j1, :rows] * a[j2, :rows]
            acc = t if acc is None else acc + t
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("name", ["stream", "small", "shift"])
def test_plain_probe_bitwise_to_numpy(name):
    a = probe_cuda.make_input(name)
    want = numpy_probe(a.numpy(), name)
    for repeats in (1, 2):
        got = probe_cuda.PLAIN[name](a, repeats)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == probe_cuda.PROBES[name][1]
        np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper runs the plain version for a CPU tensor.
    np.testing.assert_array_equal(
        probe_cuda.KERNELS[name](a, repeats=1, inner=1).numpy(), want)


def test_schedules_are_the_tpu_probes_and_unique():
    k = np.arange(256)
    assert probe_cuda.PAIRS == list(zip((5 * k + 1) % 31,
                                        ((3 * k + 7) % 29) + 3))
    assert probe_cuda.TRIPS == list(zip((5 * k + 1) % 31,
                                        ((3 * k + 7) % 8) + 3,
                                        ((7 * k + 3) % 11) + 1))
    assert len(set(probe_cuda.PAIRS)) == len(set(probe_cuda.TRIPS)) == 256
    assert all(0 <= j < 32 for p in probe_cuda.PAIRS for j in p)
    assert {o for *_, o in probe_cuda.TRIPS} == set(range(1, 12))
    # csrc/probe.cu reads P3's windows once: product k reads the window
    # (j2, o) of product k % 88, and products 0..87 read 88 distinct ones.
    windows = [(j2, o) for _, j2, o in probe_cuda.TRIPS]
    assert all(windows[k] == windows[k % 88] for k in range(256))
    assert len(set(windows[:88])) == 88


def test_probe_work_accounting():
    """The probes' work as the port's one work model counts it
    (`work.probe`), and the L2 traffic `vpu_probe` reports."""
    n = probe_cuda.NPLANES * 8
    ops = {name: work.probe(name).total_ops
           for name in ("stream", "small", "shift")}
    assert ops["stream"] == 64 * n * 384 * 128
    assert ops["small"] == 512 * n * 96 * 128
    assert ops["shift"] == 128 * n * 192 * 128
    assert work.probe("stream", 1).total_ops == n * 384 * 128
    read = {name: work.probe(name).bytes["read"] for name in ops}
    assert read["stream"] == 32 * 384 * 128 * 4
    assert read["small"] == 32 * 96 * 128 * 4
    assert read["shift"] == 32 * 192 * 160 * 4
    for name, (_, _, grid, inner) in probe_cuda.PROBES.items():
        assert grid % inner == 0
        assert vpu_probe.l2_bytes(name) == (grid // inner) * read[name]
        assert work.probe(name).peak == work.PEAK_F32 / 2


def test_entry_point_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert vpu_probe.main([]) == 2
    assert "--cpu" in capsys.readouterr().err


def test_entry_point_on_the_cpu(monkeypatch, capsys, tmp_path):
    ceiling = os.path.join(REPO, "VPU_CEILING.json")
    before = open(ceiling, "rb").read()
    monkeypatch.setattr(vpu_probe, "run_probe", functools.partial(
        vpu_probe.run_probe, grid=1))
    out = tmp_path / "probe.jsonl"
    assert vpu_probe.main(["--cpu", "--out", str(out)]) == 0
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    written = [json.loads(line) for line in out.read_text().splitlines()]
    assert printed == written
    assert [r["probe"] for r in written] == ["stream", "small", "shift"]
    for r in written:
        assert r["device"] == "cpu" and r["card"] == "cpu"
        assert r["fraction_of_67_tflops"] is None     # no device metric
        assert r["seconds"]["median"] > 0
        assert r["repetitions"] == {"stream": 1, "small": 8,
                                    "shift": 2}[r["probe"]]
    assert open(ceiling, "rb").read() == before


def test_entry_point_fails_on_merged_work(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(vpu_probe, "card_line", lambda: "test card, 700 W")

    def fake(name, device):
        return {"probe": name, "fraction_of_67_tflops":
                1.2 if name == "small" else 0.4}

    monkeypatch.setattr(vpu_probe, "run_probe", fake)
    assert vpu_probe.main([]) == 1
    assert "['small']" in capsys.readouterr().err
