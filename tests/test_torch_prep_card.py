"""The prep kernel (csrc/prep.cu) on the card: bitwise its plain version
and the grayscale and pad of the oracle at the stream cell's shape, at
KITTI's, ragged RGBA and grayscale, and on all 2^24 colours; two launches
a call.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_prep_card.py --noconftest`: the machine with the card
has no JAX, and tests/conftest.py imports it.  For the same reason the
reference here is the port's NumPy copy of the oracle
(`deepmatching_stereo_matching_tpu_torch.oracle.reference`); the CPU
tests (tests/test_torch_prep.py) hold the plain version, on the same
cases and colours, to the JAX package's own oracle.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.ops import _build, prep_cuda
from deepmatching_stereo_matching_tpu_torch.oracle import reference as oracle

pytestmark = pytest.mark.card


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n, h, w, c, hp, wp", [
    (32, 375, 450, 3, 384, 512), (1, 375, 1242, 3, 384, 1536),
    (3, 37, 53, 4, 48, 66), (3, 37, 53, 1, 40, 64)],
    ids=["stream", "kitti", "rgba_ragged", "gray"])
def test_kernel_is_plain_and_oracle(card, n, h, w, c, hp, wp):
    rng = np.random.default_rng(5)
    shape = (n, h, w) if c == 1 else (n, h, w, c)
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    if n > 1:
        raw[1] = rng.integers(0, 2, shape[1:], dtype=np.uint8)   # dark
    if n > 2:
        raw[2] = 0
        raw[2, -1, -1] = 2                                     # lit
    before = _build.launches.copy()
    got = prep_cuda.gray_pad(torch.from_numpy(raw).to(card), hp, wp)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter(PREP=prep_cuda.LAUNCHES)
    assert got.device == card and got.shape == (n, hp, wp)
    plain = prep_cuda.gray_pad(torch.from_numpy(raw), hp, wp)
    geom = SimpleNamespace(padded_height=hp, padded_width=wp)
    want = np.stack([oracle.pad_image(oracle.to_grayscale_f32(x), geom)
                     for x in raw])
    np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                  bits(plain.numpy()))
    np.testing.assert_array_equal(bits(got.cpu().numpy()), bits(want))


def test_kernel_every_colour(card):
    """All 2^24 RGB values in one call: 8 lit images of 8192 x 256 x 3,
    image i holding red 32 i to 32 i + 31 with every green and blue."""
    r = np.arange(256, dtype=np.uint8)
    raw = np.stack([
        np.stack(np.meshgrid(r[lo:lo + 32], r, r, indexing="ij"), -1)
        .reshape(32 * 256, 256, 3) for lo in range(0, 256, 32)])
    got = prep_cuda.gray_pad(torch.from_numpy(raw).to(card), 32 * 256,
                             256).cpu().numpy()
    for i, x in enumerate(raw):
        np.testing.assert_array_equal(bits(got[i]),
                                      bits(oracle.to_grayscale_f32(x)),
                                      err_msg=f"image {i}")
