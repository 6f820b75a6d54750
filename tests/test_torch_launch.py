"""The port's one launch seam, `ops._build.launch`, on the CPU.

Every kernel launch of the port goes through it and is counted there, in
`_build.launches`, under one name of `_build.KERNELS`.  An ast scan of the
package holds that no other module calls a launch function of the
library; each wrapper, its device check forced to the card's side and the
library replaced by a fake that records the call and returns 0, must
count exactly one name, the right one.  Imports nothing of JAX.
"""

import ast
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.ops import (
    _build, costvol_cuda, epilogue_cuda, fused_cuda, planes_cuda, prep_cuda,
    probe_cuda, pyramid_cuda)

PORT = Path(_build.__file__).resolve().parent.parent
# The library's launch functions: every entry point that returns a
# cudaError_t, not a shared-memory size, an occupancy or a grid.
LAUNCH_SYMBOLS = {name for name in _build._SIGNATURES
                  if not name.endswith(("_smem", "_blocks_per_sm", "_grid"))}
# Function attributes that would count launches beside the seam.
COUNTER_ATTRS = ("launches", "calls")
WRAPPER_MODULES = (costvol_cuda, epilogue_cuda, fused_cuda, planes_cuda,
                   prep_cuda, probe_cuda, pyramid_cuda)


def test_launch_symbols_are_called_only_in_build():
    assert "dm_fused_match" in LAUNCH_SYMBOLS and len(LAUNCH_SYMBOLS) == 14
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        where = path.relative_to(PORT)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Store)
                    and (node.attr in COUNTER_ATTRS
                         or node.attr.endswith("_launches"))):
                offenders.append(f"{where}:{node.lineno} sets .{node.attr}")
            if path.name == "_build.py":
                continue
            if (isinstance(node, ast.Attribute)
                    and node.attr in LAUNCH_SYMBOLS):
                offenders.append(f"{where}:{node.lineno} calls {node.attr}")
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and any(isinstance(a, ast.Constant)
                            and str(a.value).startswith("dm_")
                            for a in node.args)):
                offenders.append(f"{where}:{node.lineno} getattr of a "
                                 f"library symbol")
    assert not offenders, offenders


def _planes(cfg, n=2, magbin=False):
    """n padded (left, right[, left bins, right bins]) planes at 32 x 64."""
    geom = cfg.geometry(32, 64)
    shape = (n, geom.padded_height, geom.padded_width)
    gen = torch.Generator().manual_seed(0)
    planes = [torch.rand(shape, generator=gen) for _ in range(2)]
    if magbin:
        planes += [torch.randint(0, 8, shape, generator=gen).float()
                   for _ in range(2)]
    return geom, planes


def _fused(magbin, dtype):
    cfg = Config(max_disparity=16, levels=2, dtype=dtype,
                 descriptor="grad_hist" if magbin else "patch")
    geom, (l, r, *bins) = _planes(cfg, magbin=magbin)
    assert fused_cuda.supported(cfg, geom)
    fused_cuda.match_planes(l, r, cfg, geom, *bins)


def _rows(magbin, dtype):
    cfg = Config(max_disparity=16, levels=2, dtype=dtype,
                 descriptor="grad_hist" if magbin else "patch")
    geom, (l, r, *bins) = _planes(cfg, magbin=magbin)
    assert fused_cuda.cost_supported(cfg, geom)
    fused_cuda.cost_volume_rows(l, r, cfg, geom, *bins)


def _costvol(rows, dtype):
    src = torch.rand(2, 4, 8, 16).to(dtype)
    tgt = torch.rand(2, 4, 40, 16).to(dtype)
    fn = (costvol_cuda.cost_volume_rows if rows
          else costvol_cuda.cost_volume_dmajor)
    fn(src, tgt, 16, 4, 15)


def _pyramid(dtype):
    pyramid_cuda.pyramid_backtrack(torch.rand(2, 16, 8, 8).to(dtype), 2, 1.4)


def _aggregate(dtype, fast):
    pyramid_cuda.aggregate_dmajor(torch.rand(2, 16, 8, 8).to(dtype), 2, 1.4,
                                  fast)


def _probe(name):
    a = torch.zeros(probe_cuda.PROBES[name][0])
    probe_cuda.KERNELS[name](a)


# name -> (the library symbol it launches, a call of its wrapper).
CASES = {
    "K1": ("dm_fused_match", lambda: _fused(False, "float32")),
    "K1 bf16": ("dm_fused_match", lambda: _fused(False, "bfloat16")),
    "K1b": ("dm_fused_match", lambda: _fused(True, "float32")),
    "K1b bf16": ("dm_fused_match", lambda: _fused(True, "bfloat16")),
    "K2": ("dm_costvol_dmajor", lambda: _costvol(False, torch.float32)),
    "K2 bf16": ("dm_costvol_dmajor_bf16",
                lambda: _costvol(False, torch.bfloat16)),
    "K3": ("dm_pyramid_backtrack", lambda: _pyramid(torch.float32)),
    "K3 bf16": ("dm_pyramid_backtrack", lambda: _pyramid(torch.bfloat16)),
    "K4": ("dm_cost_rows", lambda: _rows(False, "float32")),
    "K4 bf16": ("dm_cost_rows", lambda: _rows(False, "bfloat16")),
    "K4b": ("dm_cost_rows_magbin", lambda: _rows(True, "float32")),
    "K4b bf16": ("dm_cost_rows_magbin", lambda: _rows(True, "bfloat16")),
    "K5": ("dm_aggregate", lambda: _aggregate(torch.float32, True)),
    # bf16's exact mode counts as its bf16 instance, not as "K5 exact".
    "K5 bf16": ("dm_aggregate", lambda: _aggregate(torch.bfloat16, False)),
    "K5 exact": ("dm_aggregate", lambda: _aggregate(torch.float32, False)),
    "K6": ("dm_costvol_rows", lambda: _costvol(True, torch.float32)),
    "P1": ("dm_probe_stream", lambda: _probe("stream")),
    "P2": ("dm_probe_small", lambda: _probe("small")),
    "P3": ("dm_probe_shift", lambda: _probe("shift")),
    "PLANES": ("dm_magbin_planes",
               lambda: planes_cuda.magbin_planes(torch.rand(2, 8, 8))),
    "PREP": ("dm_gray_pad", lambda: prep_cuda.gray_pad(
        torch.zeros(2, 8, 8, dtype=torch.uint8), 8, 8)),
    "EPI": ("dm_lr_outputs", lambda: epilogue_cuda.lr_outputs(
        torch.zeros(2, 4, 8, dtype=torch.int32), torch.zeros(2, 4, 8),
        torch.zeros(2, 4, 8, dtype=torch.int32), 1.0, 4, 0.0, 0.0)),
}


def test_cases_cover_the_catalogue_and_every_launch_symbol():
    assert tuple(CASES) == _build.KERNELS
    assert {symbol for symbol, _ in CASES.values()} == LAUNCH_SYMBOLS


@pytest.mark.parametrize("name", _build.KERNELS)
def test_each_wrapper_counts_its_kernel_once(name, monkeypatch):
    called = []

    class FakeLibrary:
        def __getattr__(self, symbol):
            def launch(*args):
                called.append((symbol, args[-1]))
                return 0
            return launch

    for module in WRAPPER_MODULES:
        monkeypatch.setattr(module, "run_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "library", FakeLibrary)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_build, "launches", Counter())
    symbol, call = CASES[name]
    call()
    assert called == [(symbol, 7)]      # one launch, on the current stream
    count = prep_cuda.LAUNCHES if name == "PREP" else 1
    assert _build.launches == Counter({name: count})
