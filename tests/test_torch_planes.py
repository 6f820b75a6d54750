"""grad_hist's (magnitude, bin) planes on the CPU: the plain version
(`descriptors.grad_hist_magbin_torch`) bitwise np.gradient and the JAX
package; the dispatch (a CPU tensor never launches, a CUDA request of
another dtype or size raises before any launch); a NumPy emulation of the
planes kernel's schedule (csrc/planes.cu) giving the plain version's bits
and writing every pixel once; its work model at the grad_hist KITTI
step; its source note; the benchmark's reader of its device time.  The
kernel itself is held on the card by tests/test_torch_planes_card.py.
"""

import importlib.util
import math
import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu.models import descriptors as jdesc
from deepmatching_stereo_matching_tpu_torch import work
from deepmatching_stereo_matching_tpu_torch.models import descriptors
from deepmatching_stereo_matching_tpu_torch.ops import _build, planes_cuda
from stereobench import tracing

from planes_cases import SHAPES, SMALL, bits, reference_planes, tie_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "deepmatching_stereo_matching_tpu_torch", "csrc",
                      "planes.cu")
with open(SOURCE) as _f:
    KBAND = int(re.search(r"constexpr int kBand = (\d+);", _f.read())[1])


@pytest.mark.parametrize("name", SMALL)
def test_plain_is_numpy_gradient(name):
    img = tie_images(SHAPES[name], seed=11)
    mag, bins = descriptors.grad_hist_magbin_torch(torch.from_numpy(img))
    want_mag, want_bins = reference_planes(img)
    np.testing.assert_array_equal(bits(mag.numpy()), bits(want_mag))
    np.testing.assert_array_equal(bits(bins.numpy()), bits(want_bins))


@pytest.mark.parametrize("name", ["h2", "w2", "ragged"])
def test_plain_is_jax(name):
    """Without subnormals: XLA on the CPU flushes them to zero."""
    img = tie_images(SHAPES[name], seed=12, subnormals=False)
    mag, bins = descriptors.grad_hist_magbin_torch(torch.from_numpy(img))
    for i in range(img.shape[0]):
        jm, ji = jdesc.grad_hist_magbin(jnp.asarray(img[i]))
        np.testing.assert_array_equal(bits(mag[i].numpy()), bits(jm))
        np.testing.assert_array_equal(bins[i].numpy(), np.asarray(ji))


def test_tie_images_hold_the_ties():
    """Every tie the binning has to break appears: flat pixels,
    |gx| == |gy| != 0, gx == 0 with gy of either sign and gy == 0 with gx
    of either sign, a gradient of -0.0, a halved subnormal."""
    img = tie_images(SHAPES["ragged"], seed=11)
    gy, gx = np.gradient(img, axis=(-2, -1))
    ax, ay = np.abs(gx), np.abs(gy)
    assert ((gx == 0) & (gy == 0)).any()
    assert ((ax == ay) & (ax > 0)).any()
    for g, o in ((gx, gy), (gy, gx)):
        assert ((g == 0) & (o > 0)).any() and ((g == 0) & (o < 0)).any()
    assert (np.signbit(gx) & (gx == 0)).any()
    assert (np.signbit(gy) & (gy == 0)).any()
    assert ((ax > 0) & (ax < np.finfo(np.float32).tiny)).any()
    _, bins = reference_planes(img)
    assert set(np.unique(bins)) == set(range(8))


@pytest.mark.parametrize("name", ["lead", "ragged"])
def test_cpu_tensor_takes_the_plain_version(name, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    img = torch.from_numpy(tie_images(SHAPES[name], seed=4))
    before = _build.launches["PLANES"]
    got = descriptors.grad_hist_magbin(img)
    want = descriptors.grad_hist_magbin_torch(img)
    assert _build.launches["PLANES"] == before == 0
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_) and g.dtype == torch.float32
    flipped = img.flip(-1)
    for g, w_ in zip(descriptors.grad_hist_magbin(flipped),
                     reference_planes(flipped.numpy())):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w_))
    with pytest.raises(ValueError, match="CUDA tensor"):
        planes_cuda.magbin_planes(img)


@pytest.mark.parametrize("dtype,shape,error", [
    (torch.float64, (2, 8, 8), TypeError),
    (torch.bfloat16, (2, 8, 8), TypeError),
    (torch.float16, (2, 8, 8), TypeError),
    (torch.float32, (2, 1, 8), ValueError),
    (torch.float32, (2, 8, 1), ValueError),
    (torch.float32, (8,), ValueError),
])
def test_cuda_request_raises_before_launch(dtype, shape, error, monkeypatch):
    """A CUDA tensor (the device check mocked) of another dtype, or with H
    or W below 2, raises and launches nothing; there is no fallback."""
    monkeypatch.setattr(planes_cuda, "run_kernel", lambda *t: True)
    monkeypatch.setattr(descriptors, "run_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    with pytest.raises(error):
        descriptors.grad_hist_magbin(torch.zeros(shape, dtype=dtype))
    assert _build.launches["PLANES"] == 0


def emulate(img, band, vec):
    """csrc/planes.cu's schedule in NumPy, its arithmetic in float32:
    blocks of 128 threads over 512-column strips and (image, band) items,
    4 columns a thread; each thread walks its band with the rows above, at
    and below held, the row after next loaded ahead; the quad's column
    neighbours from the next lanes of its warp, at the warp's ends from
    memory.  Returns the planes and how often each pixel was written."""
    n, h, w = img.shape
    mag = np.zeros(img.shape, np.float32)
    bins = np.zeros(img.shape, np.float32)
    writes = np.zeros(img.shape, int)
    threads, half = np.arange(128), np.float32(0.5)
    lane = threads % 32
    bands = -(-h // band)
    for bx in range(-(-w // 512)):
        x0 = bx * 512 + threads * 4
        cols = x0[:, None] + np.arange(4)
        ok = (x0[:, None] < w) & (cols < w) if vec else cols < w

        def load(b, y):
            q = np.zeros((128, 4), np.float32)
            q[ok] = img[b, y][cols[ok]]
            return q

        def edge(b, y, x):
            return np.array([img[b, y, c] if 0 <= c < w else 0.0
                             for c in x], np.float32)

        for it in range(n * bands):
            b, j = divmod(it, bands)
            y0 = j * band
            y1 = min(y0 + band, h)
            cur = load(b, y0)
            up = load(b, y0 - 1) if y0 > 0 else cur
            dn = load(b, y0 + 1) if y0 + 1 < h else cur
            for y in range(y0, y1):
                nxt = load(b, y + 2) if y + 2 < h and y + 1 < y1 else dn
                warps = cur.reshape(4, 32, 4)
                left = np.concatenate([warps[:, :1, 3], warps[:, :-1, 3]],
                                      1).ravel()      # __shfl_up_sync
                right = np.concatenate([warps[:, 1:, 0], warps[:, -1:, 0]],
                                       1).ravel()     # __shfl_down_sync
                left[lane == 0] = edge(b, y, x0[lane == 0] - 1)
                right[lane == 31] = edge(b, y, x0[lane == 31] + 4)
                prev = np.concatenate([left[:, None], cur[:, :3]], 1)
                nex = np.concatenate([cur[:, 1:], right[:, None]], 1)
                with np.errstate(all="ignore"):
                    gx = np.where(cols == 0, nex - cur,
                                  np.where(cols == w - 1, cur - prev,
                                           (nex - prev) * half))
                    gy = (dn - cur if y == 0 else cur - up if y == h - 1
                          else (dn - up) * half)
                ax, ay = np.abs(gx), np.abs(gy)
                o = np.where(gy >= 0,
                             np.where(gx > 0, np.where(ay >= ax, 5, 4),
                                      np.where(ay > ax, 6, 7)),
                             np.where(gx >= 0, np.where(ay > ax, 2, 3),
                                      np.where(ay >= ax, 1, 0)))
                mag[b, y, cols[ok]] = (ax + ay)[ok]
                bins[b, y, cols[ok]] = o.astype(np.float32)[ok]
                writes[b, y, cols[ok]] += 1
                up, cur, dn = cur, dn, nxt
    return mag, bins, writes


@pytest.mark.parametrize("name", ["h2", "w2", "h3", "w3", "ragged", "lead",
                                  "wide_ragged"])
@pytest.mark.parametrize("band", [1, KBAND, 3, 64])
def test_emulated_schedule_is_plain(name, band):
    """At the kernel's band and at others: which rows a block walks does
    not change a bit."""
    shape = SHAPES[name]
    img = tie_images(shape, seed=band).reshape(-1, *shape[-2:])
    want = descriptors.grad_hist_magbin_torch(torch.from_numpy(img))
    for vec in sorted({False, shape[-1] % 4 == 0}):
        mag, bins, writes = emulate(img, band, vec)
        assert (writes == 1).all()
        np.testing.assert_array_equal(bits(mag), bits(want[0].numpy()))
        np.testing.assert_array_equal(bits(bins), bits(want[1].numpy()))


def test_work_model_at_the_grad_hist_step():
    """Two stacks of 64 images of 384 x 1536 a step: 4 B a pixel read, 8
    written, 905,969,664 B, 0.2704 ms at 3.35 TB/s."""
    model = work.magbin_planes(128, 384, 1536)
    assert model.total_bytes == 905_969_664 and model.total_ops == 0
    t, by = work.bound(model)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.2704, abs=1e-4)
    assert math.isclose(t, 905_969_664 / work.HBM_BYTES_PER_S)


def test_source_note_names_what_it_stands_in_for():
    """The note names the JAX function the planes come from, which
    exists, and the byte count that bounds the kernel."""
    with open(SOURCE) as f:
        note = f.read().split("#include")[0]
    assert "deepmatching_stereo_matching_tpu/models/descriptors.py" in note
    assert "magbin_from_gradients" in note
    assert callable(jdesc.magbin_from_gradients)
    assert "905,969,664 B" in note and "0.2704 ms" in note
    assert "Replaces no TPU kernel" in note


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"),
        os.path.join(REPO, "stereobench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_reader():
    """kernels.planes_ms.step: the device operations named after the
    kernel's symbol (and no other kernel's), clipped to the window, over
    the harness's steps; None without them (the parent's program, a patch
    cell, no card) or without a step."""
    reader = _reader("kernels.planes_ms.step")
    read = reader.read
    assert reader.KERNEL == planes_cuda.KERNEL
    kernel = ("void (anonymous namespace)::magbin_planes_kernel<true>"
              "(float const*, float*, float*, int, int, int, int)")
    others = ["void (anonymous namespace)::costrows_magbin_kernel<4, float>"
              "(...)", "void at::native::vectorized_elementwise_kernel<4>"]
    ops = [(kernel, 0.10, 0.1003), (others[0], 0.1003, 0.103),
           (kernel, 0.20, 0.2003), (others[1], 0.3, 0.31),
           (kernel, 0.999, 1.001)]              # clipped to the window

    def rec(device_ops, steps):
        return SimpleNamespace(trace=tracing.Trace(
            window_s=1.0, spans={"step": [(0.1 * i, 0.1 * i + 0.05)
                                          for i in range(steps)]},
            device_ops=device_ops))
    assert read(rec(ops, 2)) == pytest.approx((0.0003 * 2 + 0.001) / 2
                                              * 1e3)
    assert read(rec([(o, 0.1, 0.2) for o in others], 2)) is None
    assert read(rec(ops, 0)) is None
    assert not any(reader.KERNEL in o for o in others)
