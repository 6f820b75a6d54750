"""The stream (parallel/runner.run_stream) on the card at the stream cell's
shape: one rank, uint8 colour pairs of 375x450x3 in batches of 32, four
whole batches and a tail of 16 over a pool of 96 pairs that repeats.  One
batch ahead, through page-locked buffers and a side stream, every batch
is bitwise the serial path (`pad_batch` -> `match_batch_sharded` ->
`.cpu()`) when `on_result` gets it and again after the stream ends; the
serial path's planes are the host padding's; every batch logs `copy`
"pinned" and launches what the serial path launches.

Skips without a CUDA card.  On the card run it as `python -m pytest
tests/test_torch_stream_card.py --noconftest`: the machine with the card
has no JAX, and tests/conftest.py imports it.  tests/test_torch_stream.py
holds the same order to the direct path on a CPU world of 4 ranks.
"""

import io
import json
import os
import tempfile
from collections import Counter

import numpy as np
import pytest
import torch

from deepmatching_stereo_matching_tpu_torch.config import Config
from deepmatching_stereo_matching_tpu_torch.ops import _build
from deepmatching_stereo_matching_tpu_torch.parallel import (launch, runner,
                                                             sharded)
from deepmatching_stereo_matching_tpu_torch.parallel import mesh as mesh_lib
from deepmatching_stereo_matching_tpu_torch.utils.logging import JsonlLogger

pytestmark = pytest.mark.card

H, W, BATCH, POOL, TAIL = 375, 450, 32, 96, 16
N_PAIRS = 4 * BATCH + TAIL
KEYS = ("disparity", "disparity_raw", "valid", "score", "disparity_right")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def pool_pairs():
    """uint8 colour pairs, the right a shifted copy of the left plus
    noise."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(POOL):
        left = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        shift = 4 * (i % 12)
        right = np.roll(left, -shift, axis=1) ^ rng.integers(
            0, 8, (H, W, 3), dtype=np.uint8)
        out.append((left, right))
    return out


@pytest.fixture(scope="module")
def stream():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    card = torch.device("cuda", 0)
    cfg = Config(max_disparity=64)
    pool = pool_pairs()
    feed = [pool[k % POOL] for k in range(N_PAIRS)]
    with tempfile.TemporaryDirectory() as rdzv:
        launch.init("nccl", 0, 1, os.path.join(rdzv, "rendezvous"))
        try:
            mesh = mesh_lib.make_mesh(1, 1)
            serial, serial_launches, planes_equal = [], [], []
            for b in range(0, N_PAIRS, BATCH):
                chunk = feed[b:b + BATCH]
                real = len(chunk)
                chunk += [chunk[-1]] * (BATCH - real)
                before = _build.launches.copy()
                lp, rp = (sharded.pad_batch([p[j] for p in chunk], cfg, H, W,
                                            mesh, device=card)
                          for j in (0, 1))
                out = sharded.match_batch_sharded(lp, rp, cfg, H, W, mesh,
                                                  "tiled", "fused")
                serial.append({k: v.cpu().numpy()[:real]
                               for k, v in out.items()})
                torch.cuda.synchronize()
                serial_launches.append(_build.launches - before)
                host = sharded.pad_batch([p[0] for p in chunk], cfg, H, W,
                                         mesh)
                planes_equal.append(np.array_equal(bits(lp.cpu().numpy()),
                                                   bits(host)))

            held, at_hand = {}, {}

            def on_result(i, out):
                held[i] = out
                at_hand[i] = all(np.array_equal(bits(out[k]),
                                                bits(serial[i][k]))
                                 for k in KEYS)

            text = io.StringIO()
            before = _build.launches.copy()
            report = runner.run_stream(feed, cfg, H, W, mesh, "tiled", BATCH,
                                       "fused", on_result=on_result,
                                       logger=JsonlLogger(stream=text))
            torch.cuda.synchronize()
            stream_launches = _build.launches - before
        finally:
            dist.destroy_process_group()
    records = [json.loads(line) for line in text.getvalue().splitlines()]
    return dict(serial=serial, serial_launches=serial_launches,
                planes_equal=planes_equal, held=held, at_hand=at_hand,
                report=report, records=records,
                stream_launches=stream_launches)


def test_stream_bitwise_serial_when_handed_and_after(stream):
    n = len(stream["serial"])
    assert stream["report"].batches_completed == n == 5
    assert stream["report"].pairs_completed == N_PAIRS
    assert stream["report"].retries == 0
    assert stream["planes_equal"] == [True] * n
    assert stream["at_hand"] == {i: True for i in range(n)}
    for i, want in enumerate(stream["serial"]):
        for k in KEYS:
            got = stream["held"][i][k]
            assert got.shape == want[k].shape
            np.testing.assert_array_equal(bits(got), bits(want[k]),
                                          err_msg=f"batch {i} {k}")


def test_stream_pinned_and_ahead(stream):
    done = [r for r in stream["records"] if r["event"] == "batch_done"]
    assert [r["batch"] for r in done] == [0, 1, 2, 3, 4]
    assert [r["pairs"] for r in done] == [BATCH] * 4 + [TAIL]
    assert [r["copy"] for r in done] == ["pinned"] * 5
    assert [r["pad"] for r in done] == ["device"] * 5
    assert [r["ahead"] for r in done] == [True] * 4 + [False]


def test_stream_launches_as_serial(stream):
    """PREP twice a side, K1 and EPI once a batch, as on the serial
    path."""
    per_batch = stream["serial_launches"]
    assert per_batch == [Counter(PREP=4, K1=1, EPI=1)] * 5
    assert stream["stream_launches"] == Counter(PREP=20, K1=5, EPI=5)
