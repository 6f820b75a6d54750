"""The work model: the one place where the port counts a kernel's or a
step's work, and its one definition of the card's peaks.

Pure functions of `Config`, `Geometry`, dtype and instance count (one
instance is one direction of one pair), which take no tensors and need no
card.  Each returns an itemised `Work`: named byte terms and named
operation terms, both summed.  It counts the work of the function, not of
the design:

  * bytes: each input of the function read once and each output written
    once, at the sizes of the TPU kernel's signature, which the port's
    kernels share: padded pixel planes (K1, K4), (magnitude, bin) planes
    (K1b, K4b), (H0, W0, C) and (H0, Wp, C) descriptors (K2, K6), the
    D-major (D0, H0, W0) volume (K3, K5), (H0, W0) disparity int32 and
    score float32 maps;
  * operations: the correlation over min(max_disparity, D0) bins, 2 C a
    bin on descriptors of width C (p^2, or 8 p^2 for grad_hist); on
    (magnitude, bin) planes (K1b, K4b) the one-hot histogram leaves p^2
    multiply-adds and p^2 compares of the two bins a bin; per cell of each
    level above 0 the 3-pool (2 max), the 4-child mean (3 add, 1 mul) and
    the power (1); the walk down: the top level's argmax (D0 / 2^L - 1
    compares a cell) and 2 k + offset (2) a cell of each level below.
    Norms, relu and division are left out, so the count is a lower bound.

An FMA counts as 2 operations, against the float32 peak that counts it
so; the JAX model's VPU terms (tools/roofline.py) count 2 C - 1 a bin.
Its MXU terms (`sel`, `m2c`, `r2`, `invr`, `dcomp`, tools/roofline.py:
96-104) count Mosaic's phasing matmuls, which the port does not run, and
have no counterpart here.  K1 is K4's correlation plus K3's aggregation
and walk down on the same volume; K1b is the same on (magnitude, bin)
planes, and K4b K4's correlation on them; K6 is K2's function in the row
layout; K5's exact and fast modes compute the same function to different
roundings.  `bound(work)` is the
larger of the bytes over the memory rate and the operations over the
peak: the least time the card could take.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .config import Config, Geometry
from .ops import probe_cuda

# The card's peaks, from the NVIDIA H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32 = 67e12               # float32 outside the tensor cores, FMA = 2
PEAK_NO_FMA = PEAK_F32 / 2     # a mul/add mix with no FMA (P1-P3)
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_flop_per_s": PEAK_F32,
         "f32_no_fma_flop_per_s": PEAK_NO_FMA,
         "source": "NVIDIA H100 SXM data sheet"}
# A measured rate above this share of its bound means the model counted
# less work than the card did (or work was merged away).
MERGED_WORK = 1.05

ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}
MAP_BYTES = 8      # a kernel's disparity (int32) and score (float32) a cell
# The five padded maps `pipeline.match_padded_core` writes, bytes a pixel.
STEP_OUTPUT_BYTES = {"disparity": 4, "disparity_raw": 4, "valid": 1,
                     "score": 4, "disparity_right": 4}


@dataclasses.dataclass(frozen=True)
class Work:
    """Itemised work of one call: byte terms (each input read once, each
    output written once) and operation terms, the latter counted against
    `peak`."""

    bytes: Dict[str, float]
    ops: Dict[str, float]
    peak: float = PEAK_F32

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    @property
    def total_ops(self) -> float:
        return sum(self.ops.values())

    def scaled(self, factor: float) -> "Work":
        return Work({k: v * factor for k, v in self.bytes.items()},
                    {k: v * factor for k, v in self.ops.items()}, self.peak)

    def as_dict(self) -> dict:
        return {"bytes": dict(self.bytes), "ops": dict(self.ops),
                "total_bytes": self.total_bytes, "total_ops": self.total_ops,
                "peak_flop_per_s": self.peak}


def bound(work: Work, peak: Optional[float] = None) -> Tuple[float, str]:
    """(seconds, 'bytes' | 'operations'): the larger of the bytes over the
    memory rate and the operations over `peak` (default the work's)."""
    t_bytes = work.total_bytes / HBM_BYTES_PER_S
    t_ops = work.total_ops / (peak or work.peak)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def descriptor_width(cfg: Config) -> int:
    """C: p^2 pixels a patch, times 8 orientation bins for grad_hist."""
    return cfg.patch_size ** 2 * (8 if cfg.descriptor == "grad_hist" else 1)


def _elem(cfg: Config, dtype: Optional[str]) -> int:
    return ELEMENT_BYTES[dtype or cfg.dtype]


def _bins(cfg: Config, geom: Geometry, n: int) -> int:
    """Correlation bins computed: the bins below max_disparity, a cell."""
    return min(cfg.max_disparity, geom.disparities) * geom.grid_h \
        * geom.grid_w * n


def correlation_ops(cfg: Config, geom: Geometry, n: int) -> Dict[str, int]:
    """The descriptor dot: C multiply-adds a bin."""
    return {"corr": 2 * descriptor_width(cfg) * _bins(cfg, geom, n)}


def magbin_ops(cfg: Config, geom: Geometry, n: int) -> Dict[str, int]:
    """The same dot on (magnitude, bin) planes, mag_L mag_R [bin_L ==
    bin_R]: p^2 multiply-adds and p^2 compares a bin."""
    terms = cfg.patch_size ** 2 * _bins(cfg, geom, n)
    return {"corr": 2 * terms, "bin_eq": terms}


def aggregation_ops(geom: Geometry, n: int) -> Dict[str, int]:
    """Per cell of levels 1..L: the 3-pool (2), the 4-child mean (4), the
    power (1)."""
    cells = sum(n * (geom.disparities >> lvl) * (geom.grid_h >> lvl)
                * (geom.grid_w >> lvl) for lvl in range(1, geom.levels + 1))
    return {"pool": 2 * cells, "mean": 4 * cells, "pow": cells}


def walk_ops(geom: Geometry, n: int) -> Dict[str, int]:
    """The top level's first-max argmax, then k = 2 k + offset a cell of
    each level below it."""
    top = geom.levels
    return {"argmax": n * (geom.grid_h >> top) * (geom.grid_w >> top)
            * ((geom.disparities >> top) - 1),
            "walk": sum(2 * n * (geom.grid_h >> lvl) * (geom.grid_w >> lvl)
                        for lvl in range(top))}


def _planes(geom: Geometry, n: int) -> int:
    """Two float32 padded planes an instance."""
    return 2 * n * geom.padded_height * geom.padded_width * 4


def _volume(geom: Geometry, n: int, elem: int) -> int:
    return n * geom.disparities * geom.grid_h * geom.grid_w * elem


def _maps(geom: Geometry, n: int) -> int:
    return n * geom.grid_h * geom.grid_w * MAP_BYTES


def k1(cfg: Config, geom: Geometry, n: int) -> Work:
    """K1: padded pixel planes -> (disparity, score); with
    cfg.descriptor='grad_hist' K1b, whose planes are (magnitude, bin)
    pairs.  Its bytes are the same in bfloat16 (float32 planes in, int32
    and float32 maps out)."""
    moved = {"imgs": _planes(geom, n)}
    corr = correlation_ops(cfg, geom, n)
    if cfg.descriptor == "grad_hist":
        moved["bins"] = _planes(geom, n)
        corr = magbin_ops(cfg, geom, n)
    moved["out"] = _maps(geom, n)
    return Work(moved, {**corr, **aggregation_ops(geom, n),
                        **walk_ops(geom, n)})


def k1b(cfg: Config, geom: Geometry, n: int) -> Work:
    """K1b: K1's function on (magnitude, bin) planes."""
    return k1(dataclasses.replace(cfg, descriptor="grad_hist"), geom, n)


def k2(cfg: Config, geom: Geometry, n: int,
       dtype: Optional[str] = None) -> Work:
    """K2: (H0, W0, C) source and (H0, Wp, C) target descriptors -> the
    D-major volume, all in `dtype` (default cfg.dtype)."""
    e, c = _elem(cfg, dtype), descriptor_width(cfg)
    return Work({"src": n * geom.grid_h * geom.grid_w * c * e,
                 "tgt": n * geom.grid_h * geom.padded_width * c * e,
                 "vol": _volume(geom, n, e)}, correlation_ops(cfg, geom, n))


def k6(cfg: Config, geom: Geometry, n: int) -> Work:
    """K6: K2's function in the row layout, float32 only."""
    return k2(cfg, geom, n, "float32")


def k3(cfg: Config, geom: Geometry, n: int,
       dtype: Optional[str] = None) -> Work:
    """K3: the D-major volume in `dtype` -> (disparity, score)."""
    return Work({"vol": _volume(geom, n, _elem(cfg, dtype)),
                 "out": _maps(geom, n)},
                {**aggregation_ops(geom, n), **walk_ops(geom, n)})


def k4(cfg: Config, geom: Geometry, n: int) -> Work:
    """K4: padded pixel planes -> the D-major volume in cfg.dtype."""
    return Work({"imgs": _planes(geom, n),
                 "vol": _volume(geom, n, _elem(cfg, None))},
                correlation_ops(cfg, geom, n))


def k4b(cfg: Config, geom: Geometry, n: int) -> Work:
    """K4b: (magnitude, bin) planes -> the D-major volume in cfg.dtype.
    Counted as K1b counts its planes and correlation: four float32 padded
    planes an instance in (the magnitudes and the bins, as the kernel
    takes them), the volume out once, and a bin's p^2 multiply-adds (2
    each) and p^2 bin compares (1 each) over the bins below
    max_disparity.  The bins count 4 bytes a pixel because the kernel is
    given them as float32 planes (`descriptors.grad_hist_magbin`): a
    tenth of the bytes at KITTI D=256.  A uint8 bin plane would
    lower the bound at the 32-pair KITTI D=256 step's 64 instances from
    0.9015 to 0.8339 ms (f32 volume), or from 0.5409 to 0.4733 ms (bf16);
    count 1 byte once the plane build emits bytes."""
    return Work({"imgs": _planes(geom, n), "bins": _planes(geom, n),
                 "vol": _volume(geom, n, _elem(cfg, None))},
                magbin_ops(cfg, geom, n))


def k5(cfg: Config, geom: Geometry, n: int,
       dtype: Optional[str] = None) -> Work:
    """K5, fast or exact: the D-major volume in `dtype` -> the top map in
    `dtype` and every level's int8 pool offsets."""
    e, top = _elem(cfg, dtype), geom.levels
    offsets = sum(n * (geom.disparities >> (lvl + 1)) * (geom.grid_h >> lvl)
                  * (geom.grid_w >> lvl) for lvl in range(top))
    return Work({"vol": _volume(geom, n, e),
                 "top": n * (geom.disparities >> top) * (geom.grid_h >> top)
                 * (geom.grid_w >> top) * e,
                 "offsets": offsets}, aggregation_ops(geom, n))


def probe(name: str, repetitions: Optional[int] = None) -> Work:
    """P1 ('stream'), P2 ('small'), P3 ('shift'): the input rows read once
    (P2 reads rows [:96] only), the output written once; per repetition,
    plane and output element 4 mul + 3 add + the add into the total (8, as
    the JAX probe counts), at the peak of a mix with no FMA."""
    (nsrc, _, width), (rows, cols), grid, _ = probe_cuda.PROBES[name]
    reps = grid if repetitions is None else repetitions
    return Work({"read": nsrc * rows * width * 4, "out": rows * cols * 4},
                {"mul_add": reps * probe_cuda.NPLANES
                 * probe_cuda.FLOPS_PER_PLANE * rows * cols}, PEAK_NO_FMA)


def gray_pad(n: int, height: int, width: int, channels: int, hp: int,
             wp: int) -> Work:
    """The stream's input preparation (csrc/prep.cu): n raw uint8 images
    of (height, width, channels) read once, n float32 (hp, wp) planes
    written once.  Its arithmetic (5 operations a colour pixel, a compare
    and a divide) is left out: its time at the peak is a 30th of the
    bytes' time."""
    return Work({"raw": n * height * width * channels,
                 "planes": n * hp * wp * 4}, {})


def magbin_planes(n: int, height: int, width: int) -> Work:
    """grad_hist's plane build (csrc/planes.cu): n float32 (height, width)
    images read once, their float32 magnitude and bin planes written once.
    Its arithmetic (two gradients, a sum and the octant's compares, ~12
    operations a pixel) is left out: at the peak it takes a 27th of the
    bytes' time."""
    pixels = n * height * width
    return Work({"images": pixels * 4, "mag": pixels * 4, "bins": pixels * 4},
                {})


def epilogue(n: int, h0: int, w0: int, p: int, lr: bool = True) -> Work:
    """A step's epilogue (csrc/epilogue.cu): n (h0, w0) patch maps read
    once (disparity and score, and the R->L disparity with the LR check),
    the five (h0 p, w0 p) maps written once: 17.75 B a pixel at p = 4.
    Its compares (a few a pixel) are left out."""
    patches = n * h0 * w0
    pixels = patches * p * p
    return Work({"patch_maps": patches * (MAP_BYTES + (4 if lr else 0)),
                 **{k: pixels * b for k, b in STEP_OUTPUT_BYTES.items()}}, {})


def step_fused(cfg: Config, geom: Geometry, batch: int) -> Work:
    """The bench step's function (`match_padded_core`, 'fused', LR flip):
    two padded float32 planes a pair in, the five padded maps a pair out,
    K1's operations for both directions."""
    px = batch * geom.padded_height * geom.padded_width
    return Work({"imgs": _planes(geom, batch),
                 **{k: px * b for k, b in STEP_OUTPUT_BYTES.items()}},
                k1(cfg, geom, 2 * batch).ops)


def path_exact(cfg: Config, geom: Geometry, batch: int) -> Work:
    """The two-kernel path on both directions of `batch` pairs: the planes
    read by the descriptors, their outputs written and read by K2, the
    volume written by K2 and read by K3, K3's maps; K2's and K3's
    operations."""
    n = 2 * batch
    desc = k2(cfg, geom, n)
    desc_bytes = desc.bytes["src"] + desc.bytes["tgt"]
    return Work({"imgs": _planes(geom, n), "desc_w": desc_bytes,
                 "desc_r": desc_bytes, "vol_w": desc.bytes["vol"],
                 "vol_r": desc.bytes["vol"], "out": _maps(geom, n)},
                {**desc.ops, **k3(cfg, geom, n).ops})
