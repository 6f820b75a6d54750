"""Route names and the current route.

Counterpart of the JAX package's `ops/_dispatch.py`.  The route is a
property of the call; where it runs is a property of the tensors: the
kernel wrappers run their plain PyTorch version for CPU tensors and
launch the CUDA kernel for CUDA tensors (`run_kernel`), never falling
back from one to the other.
"""

from __future__ import annotations

import contextlib
import threading

import torch

ROUTES = ("fused", "exact", "torch")
# Config.dtype -> the dtype of the cost volume and the pyramid's maps.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_state = threading.local()


def route() -> str:
    """Current route: 'fused' (default), 'exact' or 'torch'."""
    return getattr(_state, "route", "fused")


def check_route(name: str) -> str:
    if name not in ROUTES:
        raise ValueError(f"unknown route {name!r}; expected one of {ROUTES}")
    return name


def map_dtype(name: str) -> torch.dtype:
    """The torch dtype of a `Config.dtype`."""
    if name not in DTYPES:
        raise NotImplementedError(f"dtype={name!r}: the port runs "
                                  f"{' and '.join(DTYPES)}")
    return DTYPES[name]


@contextlib.contextmanager
def set_route(name: str):
    prev = route()
    _state.route = check_route(name)
    try:
        yield
    finally:
        _state.route = prev


def run_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (run the plain version).

    Raises for mixed or other devices.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")
