"""Batched stereo stream with failure recovery, on torch.distributed.

Counterpart of the JAX package's `parallel/runner.py`:

  * `init_distributed` joins this process to a world of ranks on several
    hosts (no-op on one host); every rank then holds the full batch and
    computes its own block of it (parallel/sharded.py).
  * `run_stream` drives batches of stereo pairs through a sharded
    strategy (`match_batch_sharded`).  The per-pair pipeline is stateless
    and short, so recovery needs no checkpoints: the stream records the
    last completed batch index, a failed batch is retried `max_retries`
    times, and a restarted job resumes with `start_batch` = the recorded
    index.  Structured JSONL metrics are emitted per batch
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
        `sharded.as_padded` planes (`pairs_from_paths`).
      mesh: default `parallel.auto_mesh()` over the whole world.
      start_batch: skip batches below this index (resume after restart).
      max_retries: per-batch retry budget; exceeded -> the error
        propagates.  Each batch ends in `torch.cuda.synchronize`, so a
        CUDA error is charged to the batch that raised it and each
        batch's seconds cover its device work, not the host's enqueue.
        The retry is for host-side and collective failures: a sticky
        CUDA error (an illegal address, for example) poisons the
        process's CUDA context, so its retries fail too, and
        `max_retries` bounds them.
      merge_level: for "wtiled", the pyramid level at which tiles
        all_gather-merge (parallel/wtiled.py); it changes the input
        padding, so it flows to both pad_batch and the matcher.
      on_result: callback(batch_index, host outputs dict) with the
        (real pairs, height, width) numpy outputs.
      _match_fn: test hook replacing the sharded step (fault injection).
    Returns a StreamReport; emits per-batch JSONL metrics via `logger`.
    In bfloat16 the stream computes as its strategy does
    (`sharded.match_batch_sharded`).
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

    t_start = time.perf_counter()
    done = retries = pairs_done = 0
    batch: List[Tuple[np.ndarray, np.ndarray]] = []
    index = 0

    def flush(batch, index, real):
        """Run one padded batch; `real` <= len(batch) pairs are genuine.

        Padded tail slots (duplicates of the last pair) are excluded
        from every report: Mpx/s, pairs_completed, and the outputs
        handed to `on_result` all cover the first `real` pairs only.
        """
        nonlocal done, retries, pairs_done
        if index < start_batch:
            return
        with span("stream.batch"):
            with span("stream.pad"):
                lefts = sharded.pad_batch([p[0] for p in batch], cfg, height,
                                          width, mesh, strategy, merge_level)
                rights = sharded.pad_batch([p[1] for p in batch], cfg, height,
                                           width, mesh, strategy, merge_level)
            attempt = 0
            while True:
                try:
                    t0 = time.perf_counter()
                    with span("stream.copy_in"):
                        lp = torch.from_numpy(lefts).to(device)
                        rp = torch.from_numpy(rights).to(device)
                    with span("stream.match"):
                        out = match(lp, rp)
                    with span("stream.wait"):
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                    if on_result is not None:
                        with span("stream.copy_out"):
                            out = {k: v.cpu().numpy() for k, v in out.items()}
                    dt = time.perf_counter() - t0
                    break
                except Exception as e:  # lost rank / transient failure
                    attempt += 1
                    retries += 1
                    log.log("batch_retry", batch=index, attempt=attempt,
                            error=repr(e)[:200])
                    if attempt > max_retries:
                        log.log("stream_failed", batch=index,
                                completed_batches=done)
                        raise
            done += 1
            pairs_done += real
            log.log("batch_done", batch=index, pairs=real,
                    seconds=round(dt, 4),
                    mpx_per_s=round(real * height * width * 1e-6 / dt, 3))
            if on_result is not None:
                with span("stream.on_result"):
                    on_result(index, {k: v[:real] for k, v in out.items()})

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
