"""The fused kernel's block layout and routing (csrc/fused.cu), on the CPU.

K1/K1b keep no level-0 volume in shared memory: a block holds the staged
tile, its norms, the pyramid levels 1..L and the pool offsets (level 0 at
2 bits).  These tests hold `fused_cuda.smem_bytes` (the routing mirror of
the library's `dm_fused_smem`) to that layout at the bench geometry, show
that `fused_cuda.supported` takes exactly the configurations the earlier
layout (the whole (D0, T, T) level-0 tile in shared memory) took, and
hold the plain version to the identity the kernel's score relies on: the
score is the level-0 cost at the chosen bin, so the kernel recomputes it
from its staged pixels instead of keeping the volume.  Nothing here needs
a card.
"""

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config, Geometry
from deepmatching_stereo_matching_tpu_torch.models import descriptors
from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda, pyramid_cuda

# Shared memory of an SM (233,472 B) over two blocks, less the 1 KB the
# card reserves per block: the most a block may take for 2 per SM.
TWO_PER_SM = 233472 // 2 - 1024


def _geom(h0, w0, p, d0, levels):
    return Geometry(height=h0 * p, width=w0 * p, levels=levels,
                    padded_height=h0 * p, padded_width=w0 * p, grid_h=h0,
                    grid_w=w0, disparities=d0)


def _earlier_smem_bytes(p, d0, max_d, levels, magbin):
    """The earlier block: the (D0, T, T) level-0 tile, then the larger of
    the staged tile (cost.cuh's buffers, bins as f32) and the pyramid
    scratch."""
    t = 2 ** levels
    lw = p * t
    rw = lw + max_d - 1
    planes = 2 if magbin else 1
    images = planes * p * t * (lw + rw) + t * (rw - p + 1) + t * t
    scratch = (max(images, pyramid_cuda.scratch_bytes(d0, t, levels) // 4)
               + 3) & ~3
    return 4 * (d0 * t * t + scratch)


def _earlier_supported(cfg, geom):
    unit = 2 ** geom.levels
    if geom.grid_h % unit or geom.grid_w % unit or geom.disparities % unit:
        return False
    return _earlier_smem_bytes(
        cfg.patch_size, geom.disparities, cfg.max_disparity, geom.levels,
        cfg.descriptor == "grad_hist") <= pyramid_cuda.MAX_SMEM


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
def test_bench_block_fits_two_per_sm(descriptor):
    """At the bench geometry (p=4, T=16, D0=max_d=64) the block is the sum
    of its parts, in bytes: left rows 64 x 64 floats, right strip 64 rows
    at a stride of 132 floats (128 columns: 64 of the tile and 63 before
    it rounded up to 64; stride 4 mod 8), window norms 16 rows at 144
    (16 mod 32), patch norms 16 x 16, levels 1..4 (32*64 + 16*16 + 8*4 +
    4) floats, level-0 offsets 8 x 256 bytes, levels 1..3's 16*64 + 8*16
    + 4*4 bytes; grad_hist adds the bins as bytes, 64 x 64 and 64 x 144.
    """
    cfg = Config(max_disparity=64, descriptor=descriptor)
    geom = cfg.geometry(375, 450)
    assert (geom.levels, geom.disparities) == (4, 64)
    floats = 64 * 64 + 64 * 132 + 16 * 144 + 16 * 16 + (2048 + 256 + 32 + 4)
    offsets = 8 * 256 + (1024 + 128 + 16)
    bins = 64 * 64 + 64 * 144 if descriptor == "grad_hist" else 0
    want = 4 * floats + bins + offsets
    got = fused_cuda.smem_bytes(4, 64, 64, 4, descriptor == "grad_hist")
    assert got == want
    assert got <= TWO_PER_SM
    if descriptor == "patch":   # three K1 blocks per SM
        assert 3 * (got + 1024) <= 233472
    assert got < _earlier_smem_bytes(4, 64, 64, 4, descriptor == "grad_hist")


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_supported_covers_the_earlier_rule(p, descriptor):
    """Every configuration the earlier layout's rule accepted is still
    accepted, and no other: routing does not move, though the new block
    fits more (those configurations are counted, and refused).  Where
    the earlier block took more than 48 KB the new one is smaller (below
    that, the 16-byte row alignment can outweigh the level-0 tile it
    saves)."""
    taken = fits_only_now = 0
    magbin = descriptor == "grad_hist"
    for max_d in (1, 13, 16, 64, 100, 128, 192, 256):
        for levels in range(1, 7):
            unit = 2 ** levels
            d0 = -(-max_d // unit) * unit
            cfg = Config(max_disparity=max_d, levels=levels, patch_size=p,
                         descriptor=descriptor)
            geom = _geom(2 * unit, 3 * unit, p, d0, levels)
            shape = (p, d0, max_d, levels, magbin)
            assert (fused_cuda.route_bytes(*shape)
                    == _earlier_smem_bytes(*shape))
            earlier = _earlier_supported(cfg, geom)
            assert fused_cuda.supported(cfg, geom) == earlier, shape
            if not earlier:
                if fused_cuda.smem_bytes(*shape) <= pyramid_cuda.MAX_SMEM:
                    fits_only_now += 1
                continue
            taken += 1
            if _earlier_smem_bytes(*shape) > 48 * 1024:
                assert (fused_cuda.smem_bytes(*shape)
                        < _earlier_smem_bytes(*shape))
    assert taken >= 10
    assert fits_only_now >= 1


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
def test_large_d_at_four_levels_keeps_its_route(descriptor):
    """450x375 at max_disparity 192 with levels 4: the new block fits
    (139,104 B patch) where the earlier one did not (295,424 B), and the
    pair still takes the large-D route, not K1/K1b: K4 for patch, and
    for grad_hist K4b (which took the place of the `exact` route there)."""
    cfg = Config(max_disparity=192, levels=4, descriptor=descriptor)
    geom = cfg.geometry(375, 450)
    assert (geom.levels, geom.disparities) == (4, 192)
    shape = (4, 192, 192, 4, descriptor == "grad_hist")
    assert fused_cuda.smem_bytes(*shape) <= pyramid_cuda.MAX_SMEM
    assert fused_cuda.route_bytes(*shape) > pyramid_cuda.MAX_SMEM
    if descriptor == "patch":
        assert fused_cuda.smem_bytes(*shape) == 139104
        assert fused_cuda.route_bytes(*shape) == 295424
    assert not fused_cuda.supported(cfg, geom)
    assert fused_cuda.cost_supported(cfg, geom)


def test_kitti_still_takes_the_large_d_route():
    for max_d in (128, 256):
        cfg = Config(max_disparity=max_d)
        geom = cfg.geometry(375, 1242)
        assert geom.levels == 5
        assert not fused_cuda.supported(cfg, geom)
        assert fused_cuda.cost_supported(cfg, geom)


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
@pytest.mark.parametrize("h0,w0,max_d,levels", [
    (8, 16, 16, 2),
    (16, 16, 16, 2),
    (16, 24, 13, 2),
    (32, 48, 32, 3),
])
def test_plain_score_is_the_cost_at_the_chosen_bin(h0, w0, max_d, levels,
                                                    descriptor):
    """match_planes_torch's score equals cost_volume_torch gathered at its
    disparities, bitwise, for pixel planes and (magnitude, bin) planes."""
    p = 4
    unit = 2 ** levels
    d0 = -(-max_d // unit) * unit
    cfg = Config(max_disparity=max_d, levels=levels, descriptor=descriptor)
    geom = _geom(h0, w0, p, d0, levels)
    rng = np.random.default_rng(h0 + w0 + max_d)
    left, right = (torch.from_numpy(
        (rng.standard_normal((2, h0 * p, w0 * p)) * 0.3 + 0.5)
        .astype(np.float32)) for _ in range(2))
    if descriptor == "grad_hist":
        (lm, lb), (rm, rb) = map(descriptors.grad_hist_magbin, (left, right))
        planes = (lm, rm, cfg, geom, lb, rb)
    else:
        planes = (left, right, cfg, geom)
    disp, score = fused_cuda.match_planes_torch(*planes)
    vol = fused_cuda.cost_volume_torch(*planes)
    assert disp.shape == score.shape == (2, h0, w0)
    assert int(disp.min()) >= 0 and int(disp.max()) < d0
    at = torch.gather(vol, -3, disp.long().unsqueeze(-3)).squeeze(-3)
    assert torch.equal(at, score)
    # and the wrapper takes the same plain path on CPU tensors
    d2, s2 = fused_cuda.match_planes(*planes)
    assert torch.equal(d2, disp) and torch.equal(s2, score)
