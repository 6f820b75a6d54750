"""Image stacks for the planes kernel's tests (tests/test_torch_planes.py
on the CPU, tests/test_torch_planes_card.py on the card): the shapes, and
images built to hold the binning's ties.  Imports nothing of JAX."""

import numpy as np

# name -> (..., H, W): the grad_hist KITTI step's two stacks (64 images of
# 384 x 1536 each, 128 in all), Middlebury's, H or W of 2 and 3, a width
# that is not a multiple of 4, several leading dimensions, and a width
# over one 512-column strip that is not a multiple of 4 either.
SHAPES = {
    "kitti_cell": (128, 384, 1536),
    "middlebury": (64, 384, 512),
    "h2": (3, 2, 40),
    "w2": (3, 40, 2),
    "h3": (2, 3, 37),
    "w3": (2, 37, 3),
    "ragged": (5, 29, 53),
    "lead": (2, 3, 17, 36),
    "wide_ragged": (2, 9, 1030),
}
# Small enough for the CPU's tests and the kernel's emulation.
SMALL = ("h2", "w2", "h3", "w3", "ragged", "lead")


def tie_images(shape, seed, subnormals=True):
    """float32 images of `shape` (..., H, W) made of five patterns in
    diagonal stripes, each built for a tie of the binning: halves in
    [-1, 1] (flat runs, |gx| == |gy|, gx or gy exactly 0 beside either
    sign of the other); ramps a x + b y with a, b in {-1, 0, 1} drawn per
    image (every gradient exact, ties and zeros everywhere); +0.0 and
    -0.0 mixed (gradients of -0.0); subnormal multiples of 2^-149 (their
    halves round), or uniform noise where `subnormals` is False; uniform
    noise in [0, 1)."""
    rng = np.random.default_rng(seed)
    *lead, h, w = shape
    y, x = np.mgrid[:h, :w].astype(np.float32)
    a, b = (rng.integers(-1, 2, (*lead, 1, 1)).astype(np.float32)
            for _ in range(2))
    noise = rng.random(shape, dtype=np.float32)
    zeros = np.where(rng.random(shape) < 0.5, np.float32(-0.0),
                     np.float32(0.0))
    tiny = (rng.integers(-8, 9, shape) * 2.0 ** -149).astype(np.float32)
    patterns = [
        (rng.integers(-2, 3, shape) / 2).astype(np.float32),
        (a * x + b * y).astype(np.float32),
        zeros,
        tiny if subnormals else rng.random(shape, dtype=np.float32),
        noise,
    ]
    s = max(2, min(h, w) // 4)
    stripe = (x.astype(int) // s + y.astype(int) // s) % len(patterns)
    out = np.choose(np.broadcast_to(stripe, shape), patterns)
    return np.ascontiguousarray(out, dtype=np.float32)


def reference_planes(img):
    """(magnitude, bin) of float32 images from np.gradient and the
    binning's comparisons, written out again in NumPy."""
    gy, gx = np.gradient(img, axis=(-2, -1))
    ax, ay = np.abs(gx), np.abs(gy)
    up = np.where(gx > 0, np.where(ay >= ax, 5, 4), np.where(ay > ax, 6, 7))
    dn = np.where(gx >= 0, np.where(ay > ax, 2, 3), np.where(ay >= ax, 1, 0))
    return ax + ay, np.where(gy >= 0, up, dn).astype(np.float32)


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)
