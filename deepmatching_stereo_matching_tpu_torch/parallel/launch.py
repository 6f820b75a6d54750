"""Start a torch.distributed world on one host.

`init` joins this process to a world through a `file://` rendezvous
(no port is shared, so concurrent worlds do not meet), with a timeout on
every collective.  `spawn` starts N gloo ranks on the CPU, each with one
intra-op thread, runs `fn(*args)` on every rank and returns the ranks'
results in rank order; a rank that fails, hangs or dies raises here
within `timeout` seconds.  (The JAX package's counterpart is
tools/multihost_sim.py.)  `match_cases` is a rank body that runs sharded
cases through `match_batch_sharded`.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init(backend: str, rank: int, world_size: int, rendezvous_file: str,
         timeout: float = 120.0) -> None:
    """Join the world of `world_size` ranks that meet at `rendezvous_file`
    (a path on a local disk that does not exist yet), or at a URL such as
    `tcp://host:port` where ranks on several hosts meet."""
    url = (rendezvous_file if "://" in rendezvous_file
           else f"file://{rendezvous_file}")
    dist.init_process_group(
        backend, init_method=url, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank: int, world_size: int, rendezvous_file: str,
               timeout: float, fn: Callable, args: Sequence, results):
    try:
        torch.set_num_threads(1)
        init("gloo", rank, world_size, rendezvous_file, timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          timeout: float = 300.0) -> List[Any]:
    """Run `fn(*args)` on a fresh world of `world_size` gloo ranks (CPU
    processes); returns [result of rank 0, ..., rank N-1].  `fn`, `args`
    and the results must pickle."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, rendezvous, timeout, fn,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_lib.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited without a "
                                           f"result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"world of {world_size} ranks did not finish in "
                            f"{timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]


def match_cases(cases: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Rank body: each case through `match_batch_sharded` on this world.

    A case holds `cfg`, `mesh` (a shape: 2 axes for make_mesh, 3 for
    make_mesh2d), `strategy`, `route`, `height`, `width`, the raw
    `lefts` and `rights` (padded here with `pad_batch`) and optionally
    `merge_level` and `debug_checks`.  Returns each case's global outputs
    as numpy arrays.
    """
    from . import mesh as mesh_lib
    from . import sharded

    meshes: Dict[tuple, Any] = {}
    outs = []
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            make = mesh_lib.make_mesh if len(shape) == 2 else \
                mesh_lib.make_mesh2d
            meshes[shape] = make(*shape)
        mesh = meshes[shape]
        cfg, h, w = case["cfg"], case["height"], case["width"]
        ml = case.get("merge_level")
        lefts, rights = (sharded.pad_batch(case[k], cfg, h, w, mesh,
                                           case["strategy"], ml)
                         for k in ("lefts", "rights"))
        out = sharded.match_batch_sharded(
            lefts, rights, cfg, h, w, mesh, case["strategy"], case["route"],
            ml, case.get("debug_checks", False))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return outs
