"""On the card: each cell's control, the program in the configuration's
lower precision (`--control`, bfloat16), must come out not correct at
the cell's own size, and the program itself correct on the same seeds.
Run there with `python -m pytest stereobench/tests -m card`; here the
`card` fixture skips them."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _run(cell, seed, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", "stereobench.run", "--workload", cell,
         "--seed", str(seed), "--seconds", "3", "--trace", "0", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    result = _run(cell, seed, "--control")
    assert result["correct"] is False, result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    result = _run(cell, SEEDS[0])
    assert result["correct"] is True, result["checks"]
