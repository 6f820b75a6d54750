"""The port's cross-host budget (`tools/dcn_budget.py`), on the CPU.

  * every row's cross-host bytes a pair equal the JAX tool's `budget()`
    at the bench geometry (tools/dcn_budget.py, loaded by path, read
    only), and at the JAX tool's link rate and compute the efficiencies
    are its too;
  * the compute comes only from a roofline file written on an NVIDIA card:
    a `tools.roofline --cpu` file, the repo's ROOFLINE.json (a TPU run)
    and a missing file exit 1;
  * on such a file it prints the table and the card, writes only --out,
    and leaves DCN_BUDGET.md as it was.
"""

import hashlib
import importlib.util
import json
import os

import pytest

from deepmatching_stereo_matching_tpu_torch.tools import dcn_budget, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def file_hash(name):
    with open(os.path.join(REPO, name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def jax_budget():
    """(rows, seconds a pair, cards) of the JAX tool's `budget()`."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_dcn_budget", os.path.join(REPO, "tools", "dcn_budget.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.budget()


def test_bytes_equal_jax_budget(jax_budget, monkeypatch):
    mod, (jrows, t_pair, n_chips) = jax_budget
    assert (mod.H, mod.W, mod.MAX_D) == (roofline.H, roofline.W,
                                         roofline.MAX_D)
    assert n_chips == dcn_budget.N_HOSTS * dcn_budget.CARDS_PER_HOST
    rows = dcn_budget.budget(1e-5)
    assert len(rows) == len(jrows) == 9
    assert [r["cross_host_bytes_per_pair"] for r in rows] == \
        [r["cross_host_bytes_per_pair"] for r in jrows]
    assert dcn_budget.HOST_LINK_BYTES_PER_S == 200e9
    monkeypatch.setattr(dcn_budget, "HOST_LINK_BYTES_PER_S", mod.DCN_BW)
    for r, j in zip(dcn_budget.budget(t_pair), jrows):
        assert r["efficiency_at_2_hosts"] == pytest.approx(
            j["efficiency_at_2_hosts"], rel=1e-12)
        assert r["meets_80pct"] == j["meets_80pct"]


def test_refuses_compute_not_measured_on_an_nvidia_card(tmp_path, monkeypatch,
                                                        capsys):
    for name, value in (("H", 32), ("W", 64), ("MAX_D", 16), ("BATCH", 1),
                        ("REPEATS", 1)):
        monkeypatch.setattr(roofline, name, value)
    cpu_file = tmp_path / "cpu.json"
    assert roofline.main(["--cpu", "--out", str(cpu_file)]) == 0
    capsys.readouterr()
    for path in (cpu_file, os.path.join(REPO, "ROOFLINE.json"),
                 tmp_path / "missing.json"):
        assert dcn_budget.main(["--roofline", str(path)]) == 1
        captured = capsys.readouterr()
        assert captured.out == ""
        assert ("not on an NVIDIA card" in captured.err
                or "no roofline file" in captured.err)


def test_table_from_a_card_file(tmp_path, monkeypatch, capsys):
    before = file_hash("DCN_BUDGET.md")
    rl = tmp_path / "roofline.json"
    rl.write_text(json.dumps({
        "chip": CARD, "geometry": {"batch_pairs": 32},
        "rows": {"full_step_fused": {"seconds": 6.4e-4}}}))
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "budget.md"
    assert dcn_budget.main(["--roofline", str(rl), "--out", str(out)]) == 0
    assert os.listdir(work) == []
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == CARD
    assert out.read_text().splitlines() == printed[:-1]
    table = [line for line in printed if line.startswith("| ")][1:]
    assert len(table) == 9
    assert "20.0000 us/pair" in printed[2]
    assert file_hash("DCN_BUDGET.md") == before
