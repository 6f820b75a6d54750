"""Batched stereo stream with failure recovery, on torch.distributed.

Counterpart of the JAX package's `parallel/runner.py`:

  * `init_distributed` joins this process to a world of ranks on several
    hosts (no-op on one host); every rank then holds the full batch and
    computes its own block of it (parallel/sharded.py).
  * `run_stream` drives batches of stereo pairs through a sharded
    strategy (`match_batch_sharded`), one batch ahead: the next batch is
    issued while the last one's outputs copy out.  The per-pair pipeline
    is stateless and short, so recovery needs no checkpoints: the stream
    records the last completed batch index, a failed batch is retried
    `max_retries` times, and a restarted job resumes with `start_batch` =
    the recorded index.  Structured JSONL metrics are emitted per batch
    (utils/logging.py).
  * `pairs_from_paths` feeds it pre-padded planes from image files,
    through the native prefetch loader where it built (native/).
  * `scaling_sweep` measures Mpx/s on meshes of several sizes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import Config
from ..models import pipeline
from ..utils.logging import JsonlLogger, span
from . import mesh as mesh_lib
from . import sharded


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join a world of `num_processes` ranks; returns this rank.

    One host (all args None): no-op, returns 0.  Otherwise every rank
    meets at `coordinator_address` (`host:port` or a `tcp://` URL) through
    `launch.init`: NCCL on the card (each rank takes card `process_id`
    mod the host's card count), gloo on a host without one.  A lost rank
    fails the collectives on the others, which `run_stream` retries.
    """
    if coordinator_address is None:
        return 0
    from . import launch

    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with "
                         "a coordinator_address")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    launch.init(backend, process_id, num_processes, url)
    return torch.distributed.get_rank()


def pairs_from_paths(left_paths: Sequence[str],
                     right_paths: Sequence[str], cfg: Config,
                     height: int, width: int,
                     mesh: Optional[DeviceMesh] = None,
                     strategy: str = "tiled",
                     merge_level: Optional[int] = None,
                     num_threads: int = 4):
    """Stream (left, right) pre-padded float32 planes from image files.

    Uses the native C++ prefetch loader (decode + grayscale/normalise/
    pad on worker threads, overlapping the card's previous batch) when
    it built and every input is PNM or PNG; otherwise the Python readers.
    Both paths emit bit-identical planes shaped for `strategy`'s padded
    geometry on `mesh` (`sharded.as_padded`), so the output feeds
    `run_stream` directly.
    """
    from .. import native

    if mesh is None:
        mesh = mesh_lib.auto_mesh()
    glob = sharded.strategy_geometry(cfg, height, width, mesh, strategy,
                                     merge_level)
    native_fmts = (".pgm", ".ppm", ".pnm", ".png")
    if (native.available()
            and all(p.lower().endswith(native_fmts)
                    for p in list(left_paths) + list(right_paths))):
        with native.PairLoader(list(left_paths), list(right_paths),
                               glob.padded_height, glob.padded_width,
                               num_threads) as loader:
            for _idx, left, right in loader:
                yield sharded.as_padded(left), sharded.as_padded(right)
        return
    from ..io import images
    from ..oracle import reference as oracle

    for lp, rp in zip(left_paths, right_paths):
        left, right = images.load_pair(lp, rp)
        out = []
        for img in (left, right):
            g = oracle.to_grayscale_f32(img)
            plane = np.zeros((glob.padded_height, glob.padded_width),
                             dtype=np.float32)
            plane[: g.shape[0], : g.shape[1]] = g
            out.append(sharded.as_padded(plane))
        yield out[0], out[1]


@dataclasses.dataclass
class StreamReport:
    """Summary of one `run_stream` call."""

    batches_completed: int
    pairs_completed: int
    retries: int
    seconds: float
    mpx_per_s: float


@dataclasses.dataclass
class _Batch:
    """One batch of a stream in flight: its padded inputs, held for a
    retry, and what its issue left to collect."""

    index: int
    real: int          # genuine pairs; the tail's padded slots follow
    pad: str           # "device" or "host"
    lefts: object
    rights: object
    attempt: int = 0
    t0: float = 0.0
    out: Optional[dict] = None      # device outputs, held until `done`
    host: Optional[dict] = None     # their host copies
    done: Optional[torch.cuda.Event] = None


def run_stream(pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
               cfg: Config, height: int, width: int,
               mesh: Optional[DeviceMesh] = None,
               strategy: str = "tiled",
               batch_size: int = 8,
               route: str = "fused",
               start_batch: int = 0,
               max_retries: int = 2,
               merge_level: Optional[int] = None,
               on_result: Optional[Callable[[int, dict], None]] = None,
               logger: Optional[JsonlLogger] = None,
               _match_fn: Optional[Callable] = None) -> StreamReport:
    """Run a stream of stereo pairs through a sharded strategy.

    Every rank of `mesh` calls this with the same stream.

    Args:
      pairs: iterable of (left, right) arrays, all height x width, or
        `sharded.as_padded` planes (`pairs_from_paths`).  A batch of raw
        uint8 images (`sharded.raw_batch`) is copied in as bytes and
        padded on the mesh's device, inside `pad_batch`; any other is
        padded on the host and copied in as float32 planes, inside the
        timed step.  Each `batch_done` record says which (`pad`:
        "device" or "host").
      mesh: default `parallel.auto_mesh()` over the whole world.
      start_batch: skip batches below this index (resume after restart).
      max_retries: per-batch retry budget; exceeded -> the error
        propagates.  The batch issued before the failing one is then
        still in flight and is not handed over: resume after the last
        `batch_done`.  The retry is for host-side and collective
        failures: a sticky CUDA error (an illegal address, for example)
        poisons the process's CUDA context, so its retries fail too, and
        `max_retries` bounds them.
      merge_level: for "wtiled", the pyramid level at which tiles
        all_gather-merge (parallel/wtiled.py); it changes the input
        padding, so it flows to both pad_batch and the matcher.
      on_result: callback(batch_index, host outputs dict) with the
        (real pairs, height, width) numpy outputs, in batch order.  The
        arrays are the caller's: no later batch writes into them.
      _match_fn: test hook replacing the sharded step (fault injection).
    Returns a StreamReport; emits per-batch JSONL metrics via `logger`.
    In bfloat16 the stream computes as its strategy does
    (`sharded.match_batch_sharded`).

    The stream runs one batch ahead: batch i+1 is padded, copied in and
    issued before the host waits for batch i's outputs and hands them to
    `on_result`.  On a CUDA mesh neither copy blocks the host: a raw
    batch's bytes are staged in page-locked memory (`pad_batch`), and the
    outputs leave on a side stream after the step that made them, each
    into a fresh page-locked tensor from PyTorch's caching host
    allocator; the wait is on that copy's event, so a CUDA error shows at
    the wait of the batch that raised it or of the batch after it.  Each
    `batch_done` record says `copy` ("pinned" on a CUDA mesh, else
    "pageable"; a host-padded batch's planes are copied in from pageable
    memory either way) and `ahead` (the next batch was issued before this
    one's outputs were collected); its `seconds` run from the batch's
    copy in being issued to its outputs on the host, which includes the
    next batch's issue.  A failure while a batch is issued is retried as
    that batch; a failure at its wait issues it again from its held
    inputs.
    """
    pipeline.check_supported(cfg, route)
    if mesh is None:
        mesh = mesh_lib.auto_mesh()
    log = logger or JsonlLogger()
    match = _match_fn or (
        lambda lp, rp: sharded.match_batch_sharded(
            lp, rp, cfg, height, width, mesh, strategy, route,
            merge_level))
    device = mesh_lib.mesh_device(mesh)
    n_data = mesh_lib.axis_size(mesh, "data")
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} must divide the "
                         f"data axis ({n_data})")
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    copy = "pinned" if cuda else "pageable"

    t_start = time.perf_counter()
    done = retries = pairs_done = 0
    batch: List[Tuple[np.ndarray, np.ndarray]] = []
    index = 0
    pending: Optional[_Batch] = None

    def retrying(b, step):
        nonlocal retries
        while True:
            try:
                return step()
            except Exception as e:  # lost rank / transient failure
                b.attempt += 1
                retries += 1
                log.log("batch_retry", batch=b.index, attempt=b.attempt,
                        error=repr(e)[:200])
                if b.attempt > max_retries:
                    log.log("stream_failed", batch=b.index,
                            completed_batches=done)
                    raise

    def launch(b):
        """Issue b's copy in, step and copy out; nothing waits."""
        b.out = b.done = None
        b.t0 = time.perf_counter()
        with span("stream.copy_in"):
            lp, rp = (torch.as_tensor(x, device=device)
                      for x in (b.lefts, b.rights))
        with span("stream.match"):
            out = match(lp, rp)
        with span("stream.copy_out"):
            b.host = out if on_result is not None else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    if b.host is not None:
                        b.host = {k: torch.empty(
                            v.shape, dtype=v.dtype, pin_memory=True).copy_(
                                v.contiguous(), non_blocking=True)
                            for k, v in out.items()}
                    b.done = torch.cuda.Event()
                    b.done.record()
        b.out = out

    def issue(batch, index, real):
        """Pad a batch whose first `real` pairs are genuine and issue it.
        Padded tail slots (duplicates of the last pair) are excluded from
        every report: Mpx/s, pairs_completed, and the outputs handed to
        `on_result` all cover the first `real` pairs only."""
        with span("stream.batch"):
            sides = [p[0] for p in batch], [p[1] for p in batch]
            # Raw pairs are copied in and padded on the device inside
            # pad_batch; any other batch is padded on the host and copied
            # in by `launch`, inside the timed copy_in.
            raw = all(sharded.raw_batch(s, height, width) for s in sides)
            with span("stream.pad"):
                lefts, rights = (sharded.pad_batch(
                    s, cfg, height, width, mesh, strategy, merge_level,
                    device=device if raw else None) for s in sides)
            b = _Batch(index, real, "device" if raw else "host", lefts,
                       rights)
            retrying(b, lambda: launch(b))
        return b

    def collect(b, ahead):
        """Wait for b's outputs (issuing b again after a failure), report
        it and hand them over."""
        nonlocal done, pairs_done

        def wait():
            if b.out is None:
                launch(b)
            try:
                with span("stream.wait"):
                    if b.done is not None:
                        b.done.synchronize()
            except Exception:
                b.out = None
                raise
            return time.perf_counter() - b.t0

        dt = retrying(b, wait)
        out = (None if b.host is None
               else {k: v.numpy()[:b.real] for k, v in b.host.items()})
        b.out = b.host = None
        done += 1
        pairs_done += b.real
        log.log("batch_done", batch=b.index, pairs=b.real, pad=b.pad,
                copy=copy, ahead=ahead, seconds=round(dt, 4),
                mpx_per_s=round(b.real * height * width * 1e-6 / dt, 3))
        if on_result is not None:
            with span("stream.on_result"):
                on_result(b.index, out)

    def flush(batch, index, real):
        """Issue this batch, then collect the one issued before it."""
        nonlocal pending
        if index < start_batch:
            return
        b = issue(batch, index, real)
        if pending is not None:
            collect(pending, ahead=True)
        pending = b

    for pair in pairs:
        batch.append(pair)
        if len(batch) == batch_size:
            flush(batch, index, batch_size)
            batch = []
            index += 1
    if batch:
        # Pad the tail batch by repeating the last pair; the padded
        # slots are stripped from the outputs and all accounting.
        tail = len(batch)
        while len(batch) % batch_size:
            batch.append(batch[-1])
        log.log("tail_batch", batch=index, real_pairs=tail)
        flush(batch, index, tail)
    if pending is not None:
        collect(pending, ahead=False)

    seconds = time.perf_counter() - t_start
    report = StreamReport(
        batches_completed=done,
        pairs_completed=pairs_done,
        retries=retries,
        seconds=seconds,
        mpx_per_s=pairs_done * height * width * 1e-6 / max(seconds, 1e-9),
    )
    log.log("stream_done", **dataclasses.asdict(report))
    return report


def scaling_sweep(cfg: Config, height: int, width: int,
                  mesh_sizes: Sequence[int],
                  batch_size: int = 8, n_batches: int = 4,
                  strategy: str = "tiled", route: str = "fused",
                  merge_level: Optional[int] = None,
                  seed: int = 0) -> List[dict]:
    """Mpx/s at several mesh sizes -> scaling-efficiency table.

    Every rank of the world calls this.  For each size n (sizes above the
    world are skipped) every rank builds the mesh over ranks 0..n-1; the
    ranks outside it skip that size and take part in none of its
    collectives, so their rows leave it out.  Efficiency is relative to
    the smallest mesh the rank ran.
    """
    from ..data import synthetic

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(batch_size * n_batches):
        field = synthetic.block_disparity_field(
            height, width, cfg.max_disparity, rng, block=32)
        left, right, _ = synthetic.make_pair(height, width, field,
                                             seed=seed + i)
        pairs.append((left, right))

    world = torch.distributed.get_world_size()
    rows = []
    base = None
    for n in mesh_sizes:
        if n > world:
            continue
        n_data = 2 if (n % 2 == 0 and batch_size % 2 == 0 and n > 1) else 1
        n_model = n // n_data
        if strategy == "wtiled":
            # 2-D tile grid: favour a square-ish (th, tw) split.
            n_th = 1
            for cand in range(int(n_model ** 0.5), 0, -1):
                if n_model % cand == 0:
                    n_th = cand
                    break
            mesh = mesh_lib.make_mesh2d(n_data, n_th, n_model // n_th,
                                        part_of_world=True)
        else:
            mesh = mesh_lib.make_mesh(n_data, n_model, part_of_world=True)
        if not mesh_lib.in_mesh(mesh):
            continue
        # Warm-up (kernel build, first launches) outside the timed stream.
        run_stream(pairs[:batch_size], cfg, height, width, mesh,
                   strategy, batch_size, route, merge_level=merge_level)
        rep = run_stream(pairs, cfg, height, width, mesh, strategy,
                         batch_size, route, merge_level=merge_level)
        row = {"devices": n,
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "mpx_per_s": round(rep.mpx_per_s, 3)}
        if base is None:
            base = (n, rep.mpx_per_s)
        row["scaling_efficiency"] = round(
            (rep.mpx_per_s / base[1]) / (n / base[0]), 3)
        rows.append(row)
    return rows
