"""The planes kernel (PLANES, csrc/planes.cu) on the card: grad_hist's
(magnitude, bin) planes bitwise the plain version at the grad_hist KITTI
step's stacks, at Middlebury's, at H or W of 2 and 3, at ragged widths,
with several leading dimensions, on flipped and strided inputs and on one
whose base is not 16-byte aligned, on images built for the binning's
ties; one launch a call, two a grad_hist step; K4b's volume and K1b's
(disparity, score) the same bits on its planes as on the plain version's.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_planes_card.py --noconftest`: the machine with the card
has no JAX, and tests/conftest.py imports it.  tests/test_torch_planes.py
holds the plain version to np.gradient and to the JAX package on the CPU.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.models import (descriptors,
                                                           pipeline)
from deepmatching_stereo_matching_tpu_torch.ops import _build, fused_cuda

from planes_cases import SHAPES, bits, tie_images

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def kernel_and_plain(x_card, x_cpu):
    before = _build.launches.copy()
    got = descriptors.grad_hist_magbin(x_card)
    torch.cuda.synchronize()
    assert _build.launches - before == Counter(PLANES=1)
    want = descriptors.grad_hist_magbin_torch(x_cpu)
    for g, w_ in zip(got, want):
        assert g.device == x_card.device and g.dtype == torch.float32
        assert g.shape == x_cpu.shape
        np.testing.assert_array_equal(bits(g.cpu().numpy()),
                                      bits(w_.numpy()))
    return got


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_is_plain(card, name):
    img = tie_images(SHAPES[name], seed=len(name))
    kernel_and_plain(torch.from_numpy(img).to(card), torch.from_numpy(img))


def test_flipped_strided_and_misaligned_inputs(card):
    img = torch.from_numpy(tie_images((4, 48, 64), seed=3))
    kernel_and_plain(img.to(card).flip(-1), img.flip(-1))  # torch copies
    for view in (lambda x: x.transpose(-1, -2), lambda x: x[..., ::3]):
        strided = view(img.to(card))
        assert not strided.is_contiguous()
        kernel_and_plain(strided, view(img))
    # Contiguous, but 4 bytes past a 16-byte boundary: the 4-byte path.
    buf = torch.empty(img.numel() + 1, device=card)
    shifted = buf[1:].view(img.shape)
    shifted.copy_(img.to(card))
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    kernel_and_plain(shifted, img)


def test_empty_stack(card):
    before = _build.launches.copy()
    mag, bins = descriptors.grad_hist_magbin(
        torch.zeros((0, 5, 8), device=card))
    assert mag.shape == bins.shape == (0, 5, 8)
    assert _build.launches == before


def test_k4b_and_k1b_on_the_kernels_planes(card):
    """K4b at KITTI D=256 and K1b at Middlebury's geometry give the same
    bits on the kernel's planes as on the plain version's."""
    for (h, w, max_d), n in (((375, 1242, 256), 2), ((375, 450, 64), 4)):
        cfg = Config(max_disparity=max_d, descriptor="grad_hist")
        geom = cfg.geometry(h, w)
        imgs = [torch.from_numpy(tie_images(
            (2 * n, geom.padded_height, geom.padded_width), seed=s))
            for s in (max_d, max_d + 1)]
        ours = [descriptors.grad_hist_magbin(x.to(card)) for x in imgs]
        plain = [tuple(p.to(card) for p in
                       descriptors.grad_hist_magbin_torch(x)) for x in imgs]
        (lm, lb), (rm, rb) = ours
        (pm, pb), (qm, qb) = plain
        if fused_cuda.supported(cfg, geom):           # K1b
            got = fused_cuda.match_planes(lm, rm, cfg, geom, lb, rb)
            want = fused_cuda.match_planes(pm, qm, cfg, geom, pb, qb)
        else:                                          # K4b
            assert fused_cuda.cost_supported(cfg, geom)
            got = [fused_cuda.cost_volume_rows(lm, rm, cfg, geom, lb, rb)]
            want = [fused_cuda.cost_volume_rows(pm, qm, cfg, geom, pb, qb)]
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


def test_two_launches_a_grad_hist_step(card):
    cfg = Config(max_disparity=256, descriptor="grad_hist")
    geom = cfg.geometry(375, 1242)
    lp, rp = (torch.from_numpy(tie_images(
        (2, geom.padded_height, geom.padded_width), seed=s)).to(card)
        for s in (7, 8))
    before = _build.launches["PLANES"]
    pipeline.match_padded_core(lp, rp, cfg, geom, "fused")
    torch.cuda.synchronize()
    assert _build.launches["PLANES"] - before == 2
    patch = Config(max_disparity=256)
    before = _build.launches["PLANES"]
    pipeline.match_padded_core(lp, rp, patch, patch.geometry(375, 1242),
                               "fused")
    torch.cuda.synchronize()
    assert _build.launches["PLANES"] == before      # patch
