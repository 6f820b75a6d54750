"""Build and load the CUDA kernels (`csrc/*.cu`).

All kernels compile, with nvcc for sm_90a, into ONE shared library with a
plain C interface, loaded with `ctypes` — no PyTorch headers, so a build
takes seconds.  Each source compiles in its own nvcc process, all started
together, and one more links them.  The library lands in `_build/`
beside the package (not committed), named by a hash of the sources so an
edited source is never served a stale build.  Nothing is built at
import time: the first kernel launch calls `library()`.  A failed build
raises with nvcc's output.

`--use_fast_math` is deliberately absent: it changes the rounding of
sqrtf, division and powf, and that rounding decides argmax ties.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes.  Every one returns an int: the launch
# functions a cudaError_t, the *_smem ones a block's shared memory in bytes,
# the *_blocks_per_sm ones the blocks one SM holds (negative: a CUDA error).
_SIGNATURES = {
    # p, d0, max_d, levels, magbin
    "dm_fused_smem": [_I, _I, _I, _I, _I],
    # p, d0, max_d, levels, magbin, bf16
    "dm_fused_blocks_per_sm": [_I, _I, _I, _I, _I, _I],
    # p, max_d
    "dm_cost_rows_smem": [_I, _I],
    # p, max_d, bf16
    "dm_cost_rows_blocks_per_sm": [_I, _I, _I],
    # d0, levels (+ bf16)
    "dm_pyramid_smem": [_I, _I],
    "dm_pyramid_blocks_per_sm": [_I, _I, _I],
    # c, d0, p (+ rows, bf16)
    "dm_costvol_smem": [_I, _I, _I],
    "dm_costvol_blocks_per_sm": [_I, _I, _I, _I, _I],
    # src, tgt, out, n, h0, w0, wt, c, d0, p, max_d, reverse, origin_offset, stream
    "dm_costvol_dmajor": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dm_costvol_dmajor_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P],
    # src, tgt, out, n, h0, w0, wt, c, d0, p, max_d, reverse, origin_offset,
    # d_offset, stream
    "dm_costvol_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    # cost, disp, score, n, d0, h0, w0, levels, lam, bf16, stream
    "dm_pyramid_backtrack": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # left, right, lbin, rbin, disp, score, n, hp, wp, p, d0, max_d, levels,
    # lam, bf16, stream
    "dm_fused_match": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _P],
    # left, right, out, n, hp, wp, p, d0, max_d, bf16, stream
    "dm_cost_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # p, max_d (+ bf16): K4b
    "dm_cost_rows_magbin_smem": [_I, _I],
    "dm_cost_rows_magbin_blocks_per_sm": [_I, _I, _I],
    # left, right, lbin, rbin, out, n, hp, wp, p, d0, max_d, bf16, stream
    "dm_cost_rows_magbin": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    # levels, bf16 (+ fast)
    "dm_aggregate_smem": [_I, _I],
    "dm_aggregate_blocks_per_sm": [_I, _I, _I],
    # vol, top, arg, n, d0, h0, w0, levels, fast, pow_first, lam, bf16, stream
    "dm_aggregate": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # a, out, inner, copies, stream (P1, P2, P3)
    "dm_probe_stream": [_P, _P, _I, _I, _P],
    "dm_probe_small": [_P, _P, _I, _I, _P],
    "dm_probe_shift": [_P, _P, _I, _I, _P],
    # (none); copies
    "dm_probe_shift_blocks_per_sm": [],
    "dm_probe_shift_grid": [_I],
    # src, flags, out, n, h, w, c, hp, wp, slices, stream
    "dm_gray_pad": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # img, mag, bin, n, h, w, stream
    "dm_magbin_planes": [_P, _P, _P, _I, _I, _I, _P],
    # disp, score, disp_r, out, raw, valid, score_px, right, n, h0, w0, p,
    # tau, use_min, min_score, invalid, stream
    "dm_lr_outputs": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                      _F, _F, _P],
}

# The kernels' names (PERF.md's table of kernels): every launch is counted
# under one of them in `launches`.  "K5 exact" is K5's float32 exact mode;
# "PREP" counts both of its kernels.
KERNELS = ("K1", "K1 bf16", "K1b", "K1b bf16", "K2", "K2 bf16", "K3",
           "K3 bf16", "K4", "K4 bf16", "K4b", "K4b bf16", "K5", "K5 bf16",
           "K5 exact", "K6", "P1", "P2", "P3", "PLANES", "PREP", "EPI")
# Kernel launches in this process by kernel name, since the last clear().
launches = collections.Counter()

_lock = threading.Lock()
_lib = None
_log = ""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def _target() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256()
    for f in cus + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdmstereo_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile `csrc/*.cu` into the shared library; returns its path.

    The compiler's output (ptxas registers / shared memory / spills per
    kernel) is kept for `build_log()`.
    """
    global _log
    so = _target()
    if so.exists() and not force:
        return so
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [str(Path(objdir) / (cu.stem + ".o")) for cu in cus]
        cmds = [[nvcc(), *NVCC_FLAGS, "-c", str(cu), "-o", obj]
                for cu, obj in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]     # waits for all
        _log = "".join(outs)
        for c, p in zip(cmds, procs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {p.returncode}): "
                                   f"{' '.join(c)}\n{_log}")
        cmd = [nvcc(), *ARCH, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{_log}")
    os.replace(tmp, so)
    return so


def build_log() -> str:
    """nvcc's output from the last build in this process ('' if none)."""
    return _log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dm_error_string.argtypes = [ctypes.c_int]
            lib.dm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def loaded() -> bool:
    return _lib is not None


def launch(kernel: str, symbol: str, device: torch.device, *args,
           count: int = 1) -> None:
    """Launch the library's `symbol` with `args` on `device`'s current
    stream (every launch function takes the stream last), raise on its
    CUDA error, and count `count` launches under `kernel` in `launches`.
    The one place a kernel is launched."""
    stream = torch.cuda.current_stream(device).cuda_stream
    check(getattr(library(), symbol)(*args, stream), f"{kernel} launch")
    launches[kernel] += count


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        msg = library().dm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
