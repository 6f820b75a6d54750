"""Native host-IO runtime: C++ codecs + threaded prefetch loader.

Copy of the JAX package's `native/` (the same C++ source,
`src/dmstereo_io.cpp`, and the same ctypes bindings): decode, the
grayscale+normalize+pad prologue, encode, and the prefetching pair
loader that overlaps decode with the card's work on the previous batch.
Bindings are ctypes over a plain C ABI.

The shared library is built lazily with g++ on first use into the
package's `_build/native/` (not committed); if no toolchain is available
every caller falls back to the pure-Python implementations
(io/images.py, io/writers.py), and `build_error()` says why.  Host IO,
not a kernel: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "dmstereo_io.cpp")
_LIB = os.path.join(os.path.dirname(_DIR), "_build", "native",
                    "libdmstereo_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the shared library if stale; return an error string or None."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return None
    # -ffp-contract=off: no FMA contraction, so the grayscale dot product
    # rounds exactly like numpy's f32 matmul (bit-compat with the oracle).
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
           "-ffp-contract=off", "-fvisibility=hidden", _SRC, "-o",
           _LIB + ".tmp", "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e!r}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr[-2000:]}"
    os.replace(_LIB + ".tmp", _LIB)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_chr_pp = ctypes.POINTER(ctypes.c_char_p)
    f32_p = ctypes.POINTER(ctypes.c_float)
    int_p = ctypes.POINTER(ctypes.c_int)
    void_pp = ctypes.POINTER(ctypes.c_void_p)
    lib.dms_last_error.restype = ctypes.c_char_p
    lib.dms_free.argtypes = [ctypes.c_void_p]
    lib.dms_read_pnm.argtypes = [ctypes.c_char_p, void_pp, int_p, int_p,
                                 int_p, int_p]
    lib.dms_write_pnm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.dms_read_pfm.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(f32_p), int_p, int_p]
    lib.dms_write_pfm.argtypes = [ctypes.c_char_p, f32_p, ctypes.c_int,
                                  ctypes.c_int]
    lib.dms_write_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.dms_read_png.argtypes = [ctypes.c_char_p, void_pp, int_p, int_p,
                                 int_p, int_p]
    lib.dms_read_image.argtypes = [ctypes.c_char_p, void_pp, int_p, int_p,
                                   int_p, int_p]
    lib.dms_gray_norm_pad.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, f32_p]
    lib.dms_loader_create.restype = ctypes.c_void_p
    lib.dms_loader_create.argtypes = [c_chr_pp, c_chr_pp, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.dms_loader_next.argtypes = [ctypes.c_void_p, f32_p, f32_p]
    lib.dms_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound shared library, building it on first call; None if
    the toolchain is unavailable (callers then use Python fallbacks)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if os.environ.get("DMS_DISABLE_NATIVE"):
            _build_error = "disabled via DMS_DISABLE_NATIVE"
            return None
        err = _build()
        if err is not None:
            _build_error = err
            return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB))
        except OSError as e:
            # A stale/foreign-ABI .so (or missing runtime dep) must
            # degrade to the Python fallbacks, not crash the import.
            _build_error = f"dlopen failed: {e}"
            return None
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _build_error


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise IOError(f"{what}: {lib.dms_last_error().decode()}")


def read_pnm(path: str) -> Tuple[np.ndarray, int]:
    """Decode P5/P6 -> ((H,W) or (H,W,3) u8/u16 array, maxval)."""
    lib = get_lib()
    assert lib is not None
    data = ctypes.c_void_p()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    maxval = ctypes.c_int()
    _check(lib, lib.dms_read_pnm(path.encode(), ctypes.byref(data),
                                 ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(ch), ctypes.byref(maxval)),
           f"read_pnm({path})")
    try:
        dtype = np.uint16 if maxval.value > 255 else np.uint8
        count = h.value * w.value * ch.value
        buf = (ctypes.c_uint8 * (count * dtype().itemsize)).from_address(
            data.value)
        arr = np.frombuffer(buf, dtype=dtype, count=count).copy()
    finally:
        lib.dms_free(data)
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, 3)
    return arr.reshape(shape), maxval.value


def _read_via(fn, path: str) -> Tuple[np.ndarray, int]:
    """Shared decode tail: C buffer -> numpy array + maxval."""
    lib = get_lib()
    assert lib is not None
    data = ctypes.c_void_p()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    maxval = ctypes.c_int()
    _check(lib, fn(path.encode(), ctypes.byref(data), ctypes.byref(w),
                   ctypes.byref(h), ctypes.byref(ch), ctypes.byref(maxval)),
           f"read({path})")
    try:
        dtype = np.uint16 if maxval.value > 255 else np.uint8
        count = h.value * w.value * ch.value
        buf = (ctypes.c_uint8 * (count * dtype().itemsize)).from_address(
            data.value)
        arr = np.frombuffer(buf, dtype=dtype, count=count).copy()
    finally:
        lib.dms_free(data)
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, 3)
    return arr.reshape(shape), maxval.value


def read_png(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PNG -> ((H,W) or (H,W,3) u8/u16 array, maxval).

    Gray 8/16-bit, RGB 8/16-bit, RGBA 8-bit (alpha dropped);
    non-interlaced (the Middlebury/KITTI dataset formats).
    """
    lib = get_lib()
    assert lib is not None

    def fn(p, d, w, h, c, mv):
        depth = ctypes.c_int()
        rc = lib.dms_read_png(p, d, w, h, c, ctypes.byref(depth))
        if rc == 0:
            mv._obj.value = 65535 if depth.value == 16 else 255
        return rc

    return _read_via(fn, path)


def read_image(path: str) -> Tuple[np.ndarray, int]:
    """Magic-sniffing decode: PNM (P5/P6) or PNG."""
    lib = get_lib()
    assert lib is not None
    return _read_via(lib.dms_read_image, path)


def write_pnm(path: str, arr: np.ndarray, maxval: Optional[int] = None
              ) -> None:
    a = np.ascontiguousarray(arr)
    ch = 1 if a.ndim == 2 else a.shape[2]
    if maxval is None:
        maxval = 65535 if a.dtype == np.uint16 else 255
    a = a.astype(np.uint16 if maxval > 255 else np.uint8, copy=False)
    lib = get_lib()
    assert lib is not None
    _check(lib, lib.dms_write_pnm(path.encode(),
                                  a.ctypes.data_as(ctypes.c_void_p),
                                  a.shape[1], a.shape[0], ch, maxval),
           f"write_pnm({path})")


def read_pfm(path: str) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    data = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    _check(lib, lib.dms_read_pfm(path.encode(), ctypes.byref(data),
                                 ctypes.byref(w), ctypes.byref(h)),
           f"read_pfm({path})")
    try:
        arr = np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    finally:
        lib.dms_free(ctypes.cast(data, ctypes.c_void_p))
    return arr


def write_pfm(path: str, data: np.ndarray) -> None:
    d = np.ascontiguousarray(data, dtype=np.float32)
    if d.ndim != 2:
        raise ValueError("write_pfm expects a (H, W) array")
    lib = get_lib()
    assert lib is not None
    _check(lib, lib.dms_write_pfm(
        path.encode(), d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        d.shape[1], d.shape[0]), f"write_pfm({path})")


def write_png(path: str, arr: np.ndarray) -> None:
    """Write u8 gray/RGB or u16 gray PNG."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint16:
        if a.ndim != 2:
            raise ValueError("16-bit PNG must be grayscale (H, W)")
        ch, depth = 1, 16
    elif a.dtype == np.uint8:
        ch = 1 if a.ndim == 2 else a.shape[2]
        depth = 8
    else:
        raise ValueError(f"unsupported dtype {a.dtype}")
    lib = get_lib()
    assert lib is not None
    _check(lib, lib.dms_write_png(path.encode(),
                                  a.ctypes.data_as(ctypes.c_void_p),
                                  a.shape[1], a.shape[0], ch, depth),
           f"write_png({path})")


def gray_norm_pad(img: np.ndarray, padded_height: int, padded_width: int
                  ) -> np.ndarray:
    """u8/u16 (H,W[,3]) -> padded float32 (Hp,Wp); matches
    oracle.to_grayscale_f32 + pad_image (BT.601 weights, /255)."""
    a = np.ascontiguousarray(img)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {a.dtype}")
    ch = 1 if a.ndim == 2 else a.shape[2]
    out = np.empty((padded_height, padded_width), dtype=np.float32)
    lib = get_lib()
    assert lib is not None
    _check(lib, lib.dms_gray_norm_pad(
        a.ctypes.data_as(ctypes.c_void_p), a.shape[1], a.shape[0], ch,
        int(a.dtype == np.uint16), padded_width, padded_height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
        "gray_norm_pad")
    return out


class PairLoader:
    """Threaded prefetching loader for rectified PNM pairs.

    Decodes and runs the grayscale+normalize+pad prologue on C++ worker
    threads while the card computes the previous batch; `__next__` yields
    (index, left, right) with float32 (Hp, Wp) planes, in submission
    order (the stream runner consumes batches in order, SURVEY.md §5.3).
    """

    def __init__(self, left_paths: Sequence[str],
                 right_paths: Sequence[str], padded_height: int,
                 padded_width: int, num_threads: int = 4):
        if len(left_paths) != len(right_paths):
            raise ValueError("left/right path lists differ in length")
        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                f"native loader unavailable: {build_error()}")
        self._lib = lib
        self._n = len(left_paths)
        self._shape = (padded_height, padded_width)
        larr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in left_paths])
        rarr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in right_paths])
        self._handle = lib.dms_loader_create(
            larr, rarr, self._n, num_threads, padded_width, padded_height)

    def __iter__(self):
        return self

    def __next__(self):
        left = np.empty(self._shape, dtype=np.float32)
        right = np.empty(self._shape, dtype=np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.dms_loader_next(
            self._handle, left.ctypes.data_as(fp),
            right.ctypes.data_as(fp))
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise IOError(
                f"loader: {self._lib.dms_last_error().decode()}")
        return rc, left, right

    def close(self) -> None:
        if self._handle:
            self._lib.dms_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
