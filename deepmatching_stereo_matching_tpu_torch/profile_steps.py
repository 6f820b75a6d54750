"""Where the time goes in the port's batched steps, on one CUDA device.

    python -m deepmatching_stereo_matching_tpu_torch.profile_steps \
        [--cells bench,grad_hist,zncc,kitti128,kitti256,kitti256gh,mb14f] \
        [--routes fused,exact] \
        [--steps 5] [--strategies tiled,dslab,ringd,wtiled,wtiled1] \
        [--dtype float32,bfloat16]
    python deepmatching_stereo_matching_tpu_torch/profile_steps.py --k1 \
        [--root CHECKOUT]
    python deepmatching_stereo_matching_tpu_torch/profile_steps.py \
        --costvol --hashes FILE [--root CHECKOUT]
    python deepmatching_stereo_matching_tpu_torch/profile_steps.py \
        --rows --hashes FILE [--root CHECKOUT]
    python deepmatching_stereo_matching_tpu_torch/profile_steps.py \
        --sass-diff CHECKOUT
    python deepmatching_stereo_matching_tpu_torch/profile_steps.py \
        --step-times [--cells ...] [--routes ...] [--dtype ...] \
        [--strategies ...] [--root DIR]
    python -m deepmatching_stereo_matching_tpu_torch.profile_steps \
        --stages [--cells bench,kitti256] [--steps 5]

Cells (synthetic pairs made from seeds, `lr_mode="flip"`): bench
(450x375, D=64, 32 pairs, bench.py's recipe), grad_hist (the same with
grad_hist descriptors), zncc (bench with centred descriptors, ZNCC: every
route takes 'exact', torch descriptors -> K2 -> K3, whose stage rows are
`dm.pipeline.descriptors`, `cost` and `pyramid`), kitti128 and kitti256
(1242x375 at D=128 x 8 pairs and D=256 x 4 pairs, tools/bench_large.py's
recipe), kitti256gh (kitti256 with grad_hist descriptors: the magbin
planes, K4b -> K5), mb14f (Middlebury 2014 at full resolution, 2880x1988
at D=290 x 2 pairs, 128 x 128 disparity blocks: L = 6, K4 -> K5 in two
passes, whose stage rows are `dm.pipeline.aggregate_pass0` and `_pass1`,
one a K5 launch).

For each cell, dtype (`--dtype`, default float32; bfloat16 runs on every
route) and route, `--steps` calls of `match_padded_core` run
once unprofiled and once under torch.profiler; with `--strategies`, so do
`parallel.match_batch_sharded` calls of each named sharded strategy on a
world of one rank over NCCL (tiled on 'fused', the others on 'exact';
wtiled1 is wtiled with merge_level 1).  Of the profiled steps it
prints, per step:
  span: device time from a CUDA event recorded before the first step to
      one recorded after the last;
  kernels: the sum of the profiler's device rows (an aten:: row, or the
      row of one of the program's `dm.` spans, repeats its kernels' time
      and is skipped);
  idle: 1 - kernels / span, as it falls: a negative share means the two
      clocks disagree, and is printed, not clamped;
  enqueue: host time to issue the steps;
then the top device rows, the top host ops by self CPU time, and the
program's stages (`stage_rows`).  The profiler adds host time to every
op, so where the host is the bound the profiled span is longer than the
unprofiled one, which is printed beside it.

--stages profiles, for each --cells cell on the 'fused' route, --steps
batches of `parallel.run_stream` ('tiled' on a world of one rank over
NCCL, a batch of the cell's pairs as 8-bit colour images, outputs copied
back) and --steps calls of `api.match_stereo` (one colour pair each), and
prints the stage rows of each: per batch or pair, every `dm.` span's
calls, host ms, and the device ms and device operations launched inside
it.  Then the copy rates, each way, pinned and pageable, at the bytes of
the stream's batch of raw pairs and of its outputs.

--k1 times K1 and K1b alone at the bench shapes (CUDA events, 5 x 20
launches each, after a forced build) from the port package under --root
(default: this checkout).  Run as a file, once per checkout in one call
(parent, change, change, parent), it compares two trees on the same card.

--costvol prints the FFMA/FMUL/FADD counts of each costvol_kernel
instance in the built library's SASS, times K2 (bench, bench at C=128,
KITTI D=256) and K6 (KITTI D=256) as --k1 does, and hashes the volume of
every cost-volume launch chip_smoke.py makes (`costvol_cases`, inputs
made on the card from seeds), and times the bench's descriptors (patch
and grad_hist, 64 instances, left + sliding): the hashes go to --hashes
FILE where it does not exist, else each is compared with it (exit 1 if
any differs).  K2's bfloat16 instance runs every K2 case again on the
descriptors rounded to bf16 (keys "... bf16", new keys: listed, not
compared) and is timed at the bench and at C=128.
Run on the parent first, then the change, to show the volumes bitwise
equal.

--rows does the same for K4 and K3: it times K4 (KITTI D=128 x 16 and
D=256 x 8 instances) and K3 (bench x 64) as --k1 does, hashes K4's volume
and K3's (disparity, score) at every shape chip_smoke.py launches them
(`rows_cases`, inputs made on the card from seeds), and hashes the SASS
of each fused_kernel instance (K1/K1b compile the cost block K4 shares;
the float32 instances keep their keys, the bfloat16 ones are new keys and
are listed, not compared),
and on the small cases' planes runs K1 too, hashes its (disparity,
score) and counts its scores that differ from K4's volume at its
disparities: written to or compared with --hashes FILE as --costvol
does.  K3's bfloat16 instance runs every K3 case again on the volume
rounded to bf16 (new keys "... bf16") and is timed at the bench.  The first run also keeps the small cases' inputs and outputs
beside FILE (FILE.npz), so that a later run prints how far a differing
case is off.

--rows also hashes K5's (top, offsets) at every K5 case of `rows_cases`
(both modes, both dtypes, real-valued and tie-heavy volumes) and times K5
at KITTI D=128 x 16 and D=256 x 8 in each dtype and mode: event time as
--k1, and device time from torch.profiler.  Run on the parent first,
then the change, to show K5's outputs the parent's at every shape.

--step-times times the --cells steps in each --dtype and route, and with
--strategies each named strategy's float32 step, as chip_smoke.py does
(7 samples of one call: median, range; peak device memory), from the
package under --root: parent, change, change, parent in one call
compares two trees' steps on one card.

--sass-diff CHECKOUT builds this checkout's library and CHECKOUT's and
compares the SASS of every instance of every kernel, matched by template
arguments (labels renumbered alike, column padding ignored): a kernel
whose source gained an instance shows whether its earlier instances
compile as before.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

CELLS = {  # name -> (height, width, max_disparity, descriptor, pairs, block, seed0)
    "bench": (375, 450, 64, "patch", 32, 32, 100),
    "grad_hist": (375, 450, 64, "grad_hist", 32, 32, 100),
    "zncc": (375, 450, 64, "patch", 32, 32, 100),
    "kitti128": (375, 1242, 128, "patch", 8, 48, 0),
    "kitti256": (375, 1242, 256, "patch", 4, 48, 0),
    "kitti256gh": (375, 1242, 256, "grad_hist", 4, 48, 0),
    "mb14f": (1988, 2880, 290, "patch", 2, 128, 0),
}
CENTRED = {"zncc"}  # cells whose descriptors are centred (ZNCC)
STRATEGIES = {  # name -> (strategy, route, merge_level)
    "tiled": ("tiled", "fused", None),
    "dslab": ("dslab", "exact", None),
    "ringd": ("ringd", "exact", None),
    "wtiled": ("wtiled", "exact", None),
    "wtiled1": ("wtiled", "exact", 1),
}


def _padded_pairs(cell, dtype="float32"):
    """(cfg, geom, left, right): the cell's padded pairs on the card."""
    import torch
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.data import synthetic
    from deepmatching_stereo_matching_tpu_torch import api

    h, w, max_d, desc, n, block, seed0 = CELLS[cell]
    cfg = Config(max_disparity=max_d, descriptor=desc, dtype=dtype,
                 center_descriptors=cell in CENTRED)
    lefts, rights = [], []
    for s in range(seed0, seed0 + n):
        field = synthetic.block_disparity_field(
            h, w, max_d, np.random.default_rng(s), block=block)
        left, right, _ = synthetic.make_pair(h, w, field, seed=s)
        lefts.append(api.preprocess(left, cfg, h, w))
        rights.append(api.preprocess(right, cfg, h, w))
    return (cfg, cfg.geometry(h, w),
            torch.from_numpy(np.stack(lefts)).cuda(),
            torch.from_numpy(np.stack(rights)).cuda())


def _strategy_steps(cfg, geom, lp, rp, names):
    """(label, step) for each named strategy on the one-rank world."""
    if not names:       # no process group to build meshes on
        return
    from deepmatching_stereo_matching_tpu_torch.parallel import (
        mesh as mesh_lib, sharded)

    meshes = {2: mesh_lib.make_mesh(1, 1), 3: mesh_lib.make_mesh2d(1, 1, 1)}
    for name in names:
        strategy, route, ml = STRATEGIES[name]
        mesh = meshes[3 if strategy == "wtiled" else 2]
        glob = sharded.strategy_geometry(cfg, geom.height, geom.width, mesh,
                                         strategy, ml)
        if (glob.padded_height, glob.padded_width, glob.disparities) != (
                geom.padded_height, geom.padded_width, geom.disparities):
            raise ValueError(f"{name} pads this cell differently: {glob}")

        def step(strategy=strategy, route=route, ml=ml, mesh=mesh):
            return sharded.match_batch_sharded(
                lp, rp, cfg, geom.height, geom.width, mesh, strategy, route,
                ml)
        yield f"{name} [{route}]", step


def profile_cells(cells, routes, steps, strategies=(), dtypes=("float32",)):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepmatching_stereo_matching_tpu_torch.models import pipeline

    def timed(fn):
        """(device span ms, host enqueue ms) per step of `steps` calls."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps, enqueue * 1e3 / steps

    for cell, dtype in ((c, d) for c in cells for d in dtypes):
        cfg, geom, lp, rp = _padded_pairs(cell, dtype)
        todo = []
        for route in routes:
            try:
                pipeline.check_supported(cfg, route)
            except NotImplementedError as e:
                print(f"\n== {cell} [{route}] {dtype}: skipped: {e}")
                continue
            todo.append((f"[{route}] {dtype}",
                         lambda route=route: pipeline.match_padded_core(
                             lp, rp, cfg, geom, route)))
        if dtype == "float32":
            todo += list(_strategy_steps(cfg, geom, lp, rp, strategies))
        for label, step in todo:
            for _ in range(3):
                step()
            plain_span, plain_enq = timed(step)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                span, enq = timed(step)
            rows = prof.key_averages()
            dev = sorted(((e.self_device_time_total / steps / 1e3,
                           e.count // steps, e.key) for e in rows
                          if e.self_device_time_total > 0
                          and not e.key.startswith(("aten::", "dm."))),
                         reverse=True)
            host = sorted(((e.self_cpu_time_total / steps / 1e3,
                            e.count // steps, e.key) for e in rows
                           if e.self_cpu_time_total > 0), reverse=True)
            kernels = sum(ms for ms, _, _ in dev)
            print(f"\n== {cell} {label} {lp.shape[0]} pairs, per step over "
                  f"{steps} profiled steps: span {span:.4f} ms, kernels "
                  f"{kernels:.4f} ms, idle {1 - kernels / span:+.4f}, "
                  f"enqueue {enq:.4f} ms; unprofiled: span "
                  f"{plain_span:.4f} ms, enqueue {plain_enq:.4f} ms")
            for ms, count, key in dev[:10]:
                print(f"   device {ms:9.4f} ms {100 * ms / kernels:5.1f}% "
                      f"x{count:<3d} {key[:80]}")
            for ms, count, key in host[:8]:
                print(f"   host   {ms:9.4f} ms x{count:<3d} {key[:80]}")
            _print_stages(prof, steps)
            sys.stdout.flush()


def stage_rows(events, units):
    """(name, calls, host ms, device ms, device operations) per unit of
    work for each of the program's spans (`utils/logging.span`, named
    `dm.`) among the profiler's `events`, in order of first appearance.
    A span counts the device work launched inside it, its children's
    included: the profiler charges each device operation to the op that
    launched it (`FunctionEvent.device_time_total`)."""
    from deepmatching_stereo_matching_tpu_torch.utils.logging import PREFIX

    def launched(e):
        return len(e.kernels) + sum(launched(c) for c in e.cpu_children)

    rows = {}
    for e in events:
        if e.name.startswith(PREFIX):
            row = rows.setdefault(e.name, [0, 0.0, 0.0, 0])
            row[0] += 1
            row[1] += e.cpu_time_total / 1e3
            row[2] += e.device_time_total / 1e3
            row[3] += launched(e)
    return [(name, calls / units, host / units, dev / units, ops / units)
            for name, (calls, host, dev, ops) in rows.items()]


def _print_stages(prof, units):
    for name, calls, host, dev, ops in stage_rows(prof.events(), units):
        print(f"   stage  host {host:9.4f} ms  device {dev:9.4f} ms "
              f"x{ops:<6.1f} launches  x{calls:<4.1f} {name}")


def profile_stages(cells, steps):
    """--stages: the stream's and the API's stage rows (see the module's
    docstring), on the one-rank world `main` opens."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepmatching_stereo_matching_tpu_torch import api
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.data import synthetic
    from deepmatching_stereo_matching_tpu_torch.parallel import (
        mesh as mesh_lib, runner)

    mesh = mesh_lib.make_mesh(1, 1)
    dev = torch.device("cuda", 0)
    for cell in cells:
        h, w, max_d, desc, n, block, seed0 = CELLS[cell]
        cfg = Config(max_disparity=max_d, descriptor=desc,
                     center_descriptors=cell in CENTRED)
        pairs = []
        for s in range(seed0, seed0 + n):
            field = synthetic.block_disparity_field(
                h, w, max_d, np.random.default_rng(s), block=block)
            left, right, _ = synthetic.make_pair(h, w, field, seed=s)
            pairs.append(tuple(
                np.repeat(np.rint(x * 255).astype(np.uint8)[..., None], 3, -1)
                for x in (left, right)))

        out_bytes = []

        def stream(batches):
            runner.run_stream(pairs * batches, cfg, h, w, mesh, "tiled", n,
                              "fused", on_result=lambda i, o: out_bytes.append(
                                  sum(v.nbytes for v in o.values())))

        def pair(k):
            api.match_stereo(*pairs[k % n], cfg, impl="fused", device=dev)

        for label, units, work in (
                (f"stream, batches of {n}", steps, lambda: stream(steps)),
                ("api, one pair", steps,
                 lambda: [pair(k) for k in range(steps)])):
            work()                                   # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                work()
                torch.cuda.synchronize()
            print(f"\n== {cell} {label}: per unit over {units}")
            _print_stages(prof, units)
            sys.stdout.flush()
        in_bytes = n * sum(x.nbytes for x in pairs[0])
        for label, nbytes in (("a batch's raw pairs", in_bytes),
                              ("a batch's outputs", out_bytes[-1])):
            print_copy_rates(label, nbytes, dev)


def print_copy_rates(label, nbytes, dev):
    """Device ms and GB/s of one copy of `nbytes` between the host and
    `dev`, each way, from page-locked and from pageable host memory: the
    median of 5 copies timed with CUDA events after a first one."""
    import torch

    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for kind, host in (("pinned", torch.ones(nbytes, dtype=torch.uint8,
                                             pin_memory=True)),
                       ("pageable", torch.ones(nbytes, dtype=torch.uint8))):
        for way, dst, src in (("HtoD", card, host), ("DtoH", host, card)):
            ms = []
            for _ in range(6):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dst.copy_(src, non_blocking=True)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            med = float(np.median(ms[1:]))
            print(f"   copy {way} {kind} {label}, {nbytes / 1e6:.2f} MB: "
                  f"{med:.4f} ms, {nbytes / med / 1e6:.2f} GB/s", flush=True)


def time_steps(cells, routes, dtypes, strategies=()):
    """--step-times: each cell's batched `match_padded_core` step per dtype
    and route, and in float32 each of `strategies`' `match_batch_sharded`
    step on the one-rank world, as chip_smoke.py times them: 7 samples of
    one call (CUDA events) after a warm-up, their median and range, and
    the step's peak device memory, from the port package under --root."""
    import torch

    from deepmatching_stereo_matching_tpu_torch.models import pipeline
    from deepmatching_stereo_matching_tpu_torch.ops import _build

    def one(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for cell, dtype in ((c, d) for c in cells for d in dtypes):
        cfg, geom, lp, rp = _padded_pairs(cell, dtype)
        todo = [(f"[{route}]", lambda route=route: pipeline.match_padded_core(
            lp, rp, cfg, geom, route)) for route in routes]
        if dtype == "float32":
            todo += list(_strategy_steps(cfg, geom, lp, rp, strategies))
        for label, step in todo:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms = [one(step) for _ in range(7)]
            print(f"step {cell} {label} {dtype} {_build.SRC_DIR}: median "
                  f"{float(np.median(ms)):.4f} ms [{min(ms):.4f}.."
                  f"{max(ms):.4f}] over 7; peak {peak / 2**20:.1f} MiB",
                  flush=True)
        del lp, rp


def time_k1():
    import torch

    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.models import descriptors
    from deepmatching_stereo_matching_tpu_torch.ops import _build, fused_cuda

    _build.build(force=True)
    cfg, geom, lp, rp = _padded_pairs("bench")
    lefts, rights = torch.stack([lp, rp.flip(-1)]), torch.stack([rp, lp.flip(-1)])
    gh = Config(max_disparity=cfg.max_disparity, descriptor="grad_hist")
    (lm, lb), (rm, rb) = map(descriptors.grad_hist_magbin, (lefts, rights))
    runs = {"K1": lambda: fused_cuda.match_planes(lefts, rights, cfg, geom),
            "K1b": lambda: fused_cuda.match_planes(lm, rm, gh, geom, lb, rb)}
    for name, fn in runs.items():
        ms = _median_launch_ms(torch, fn)
        print(f"{name} {_build.SRC_DIR}: ms per 64-instance call, 5 x 20 "
              f"launches: " + " ".join(f"{x:.4f}" for x in ms)
              + f"; median {float(np.median(ms)):.4f}", flush=True)


def costvol_cases():
    """(name, kind, shape) of every cost-volume launch chip_smoke.py
    makes, kind 'K2' (D-major) or 'K6' (rows); shape = (lead, h0, w0, wt,
    c, d0, p, max_d, reverse, origin_offset, d_offset, aligned).  The
    bench (2 x 32 instances: 96x128 patches, 512 target columns, C = 16
    or 128 for grad_hist, D0 = 64), its halo-extended target (16 patches
    each side), KITTI D=256 (2 x 4 instances, 96x384, 1536 columns) whole
    and in 64-bin slabs, and small ragged shapes on every staging form:
    p = 3 (C = 9) and 5 (C = 25) by 4-byte copies, p = 6 and 7 with a
    ragged last C chunk, p = 8 with C = 64 and 512 (chunked), d_offset
    not a multiple of p, w0 not a multiple of the 32-column tile, and a
    C = 16 pair off 16-byte alignment."""
    cases = []

    def both(name, kinds, lead, h0, w0, wt, c, d0, p, max_d, oo=0, dofs=0,
             aligned=True):
        for reverse in (False, True):
            for kind in kinds:
                cases.append((f"{kind} {name} {'rev' if reverse else 'fwd'}",
                              kind, ((*lead,), h0, w0, wt, c, d0, p, max_d,
                                     reverse, oo, dofs, aligned)))

    both("bench", ("K2",), (2, 32), 96, 128, 512, 16, 64, 4, 64)
    both("bench C=128", ("K2",), (2, 32), 96, 128, 512, 128, 64, 4, 64)
    both("bench halo", ("K6",), (2, 32), 96, 128, 512 + 128, 16, 64, 4, 64,
         oo=16)
    both("kitti D=256", ("K2", "K6"), (2, 4), 96, 384, 1536, 16, 256, 4, 256)
    for k in range(4):
        both(f"kitti slab {64 * k}", ("K6",), (2, 4), 96, 384, 1536, 16, 64,
             4, 256, dofs=64 * k)
    for p, c, h0, w0, d0, max_d, dofs in (
            (3, 9, 6, 45, 24, 22, 7), (5, 25, 3, 33, 20, 20, 3),
            (6, 36, 3, 21, 48, 45, 5), (7, 49, 2, 19, 28, 25, 0),
            (8, 64, 4, 20, 40, 37, 13), (8, 512, 2, 12, 24, 24, 9),
            (8, 64, 2, 40, 256, 250, 0), (4, 128, 3, 40, 16, 16, 2)):
        both(f"p={p} C={c} {h0}x{w0} D0={d0}", ("K2", "K6"), (3,), h0, w0,
             p * w0 + p - 1, c, d0, p, max_d, dofs=dofs)
    both("p=4 C=16 unaligned", ("K2", "K6"), (2,), 5, 50, 200, 16, 32, 4, 30,
         oo=2, aligned=False)
    return cases


def costvol_inputs(torch, shape, seed, device="cuda", dtype=None):
    """Unit-norm descriptors for one case, made on the device from a seed:
    (src, tgt), the target's last p - 1 columns zero as sliding
    descriptors are, and off 16-byte alignment where the case says so
    (one element off).  `dtype` (default float32): bfloat16 rounds the
    float32 descriptors."""
    lead, h0, w0, wt, c, d0, p, *_, aligned = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(cols):
        x = torch.randn((*lead, h0, cols, c), generator=gen, device=device)
        x = (x / x.square().sum(-1, keepdim=True).sqrt()).to(
            dtype or torch.float32)
        if aligned:
            return x
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
        buf[1:].copy_(x.flatten())
        return buf[1:].view(x.shape)

    src, tgt = make(w0), make(wt)
    tgt[..., wt - (p - 1):, :] = 0.0
    return src, tgt


def costvol_launch(costvol_cuda, kind, shape, src, tgt):
    lead, h0, w0, wt, c, d0, p, max_d, reverse, oo, dofs, _ = shape
    if kind == "K2":
        return costvol_cuda.cost_volume_dmajor(src, tgt, d0, p, max_d,
                                               reverse, oo)
    return costvol_cuda.cost_volume_rows(src, tgt, d0, p, max_d, reverse, oo,
                                         dofs)


def sass(so, kernel):
    """{function: its SASS lines} of every instance of `kernel` in the
    built library, or None where the toolkit has no cuobjdump.  A body
    ends at the next function or at the header of the next cubin
    ("Fatbin ..."), which follows the last function of a source file."""
    import os
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    bodies, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            cur = fn if kernel in fn else None
            if cur:
                bodies[cur] = []
        elif line.startswith("Fatbin"):
            cur = None
        elif cur:
            bodies[cur].append(line)
    return bodies


def costvol_sass(so):
    """{costvol_kernel instance: {FFMA, FMUL, FADD: count}} in the built
    library's SASS, or None where the toolkit has no cuobjdump."""
    import re

    bodies = sass(so, "costvol_kernel")
    if bodies is None:
        return None
    return {fn: {op: sum(bool(re.search(rf"\b{op}\b", line))
                         for line in lines)
                 for op in ("FFMA", "FMUL", "FADD")}
            for fn, lines in bodies.items()}


def time_costvol(hashes: Path):
    """--costvol: SASS op counts of costvol_kernel, times of K2 bench, K2
    C=128, K2 and K6 at KITTI D=256, and a hash of every case's volume,
    written to `hashes` if it does not exist, else compared with it."""
    import hashlib
    import json

    import torch

    from deepmatching_stereo_matching_tpu_torch.ops import _build, costvol_cuda

    so = _build.build(force=True)
    print(f"costvol_kernel SASS {_build.SRC_DIR}: {costvol_sass(so)}",
          flush=True)
    timed = ("K2 bench fwd", "K2 bench C=128 fwd", "K2 kitti D=256 fwd",
             "K6 kitti D=256 fwd", "K2 bench fwd bf16",
             "K2 bench C=128 fwd bf16")
    got = {}
    cases = [(seed, name, kind, shape, torch.float32)
             for seed, (name, kind, shape) in enumerate(costvol_cases())]
    cases += [(seed, f"{name} bf16", kind, shape, torch.bfloat16)
              for seed, name, kind, shape, _ in cases if kind == "K2"]
    for seed, name, kind, shape, dtype in cases:
        src, tgt = costvol_inputs(torch, shape, seed, dtype=dtype)
        vol = costvol_launch(costvol_cuda, kind, shape, src, tgt)
        torch.cuda.synchronize()
        bits = vol.view(torch.int16) if dtype == torch.bfloat16 else vol
        got[name] = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
        if name in timed:
            ms = _median_launch_ms(torch, lambda: costvol_launch(
                costvol_cuda, kind, shape, src, tgt))
            print(f"{name} {tuple(vol.shape)} {_build.SRC_DIR}: ms per call, "
                  f"5 x 20 launches: " + " ".join(f"{x:.4f}" for x in ms)
                  + f"; median {float(np.median(ms)):.4f}", flush=True)
        del src, tgt, vol
    # The descriptors K2 reads, in both directions at the bench: their
    # normalisation's sums are the package's own (the oracle's order).
    from deepmatching_stereo_matching_tpu_torch.models import descriptors
    for cell in ("bench", "grad_hist"):
        cfg, _, lp, rp = _padded_pairs(cell)
        lefts = torch.stack([lp, rp.flip(-1)])
        rights = torch.stack([rp, lp.flip(-1)])
        ms = _median_launch_ms(torch, lambda: (
            descriptors.left_descriptors(lefts, cfg),
            descriptors.right_sliding_descriptors(rights, cfg)))
        print(f"descriptors {cell} (64 instances, left + sliding) "
              f"{_build.SRC_DIR}: ms per call: "
              + " ".join(f"{x:.4f}" for x in ms)
              + f"; median {float(np.median(ms)):.4f}", flush=True)
    if not hashes.exists():
        hashes.write_text(json.dumps(got, indent=1))
        print(f"costvol: {len(got)} volume hashes written to {hashes}")
        return 0
    want = json.loads(hashes.read_text())
    new = sorted(k for k in got if k not in want)
    differ = sorted(k for k in got if k in want and want[k] != got[k])
    print(f"costvol: {len(got) - len(new) - len(differ)} of "
          f"{len(got) - len(new)} volumes bitwise equal to {hashes}; differ: "
          f"{differ}; new, not compared: {new}", flush=True)
    return 1 if differ else 0


# K1's small tiles in chip_smoke.py, (h0, w0, max_d, levels, p): levels 2
# and 3 at p = 4, then the runtime-p instance at p 3 and 8.
SMALL_TILES = ((8, 16, 16, 2, 4), (16, 16, 16, 2, 4), (16, 24, 13, 2, 4),
               (32, 48, 32, 3, 4), (16, 24, 13, 2, 3), (8, 16, 16, 2, 8))


def small_name(h0, w0, max_d, levels, p):
    return f"small p={p} {h0}x{w0} max_d={max_d} L={levels}"


def rows_cases():
    """(name, kind, shape) of every K4 and K3 launch shape chip_smoke.py
    makes.  K4: shape = (n, h0, w0, p, d0, max_d): the bench (64
    instances), the small tiles of K1's witness (p 3, 4, 8), KITTI D=128 x
    16 and D=256 x 8, a ragged 28x76 grid at D0 = 100, and ragged grids at
    the runtime-p instance (p 3, 5, 6, 7) and at D0 not a multiple of 4.  K3:
    shape = (n, d0, h0, w0, levels): the bench (64 instances, on real-valued
    costs and on quarter steps with many ties), the centred adversarial
    pairs' geometry (L = 2, D0 = 24), D0 = 128 at L = 4, and L = 1, 2, 5.
    K5: shape = (n, d0, h0, w0, levels, offset): KITTI D=128 x 16 and
    D=256 x 8, dslab's bench volume (32 x (64, 96, 128), L = 4), L 1-6,
    tile counts that do not divide the grid, D0 = 2^L and D0 not a
    multiple of 32, W0 = 2 mod 4 at L = 1 and 4 mod 8 at L = 2 (the narrow
    form), a base `offset` elements off 16-byte alignment, and two launches
    at L = 6; each case runs in both modes and both dtypes."""
    k4 = [("bench", (64, 96, 128, 4, 64, 64))]
    k4 += [(small_name(h0, w0, m, lv, p),
            (4, h0, w0, p, -(-m // 2 ** lv) * 2 ** lv, m))
           for h0, w0, m, lv, p in SMALL_TILES]
    k4 += [("kitti D=128", (16, 96, 384, 4, 128, 128)),
           ("kitti D=256", (8, 96, 384, 4, 256, 256)),
           ("ragged 28x76 D0=100", (4, 28, 76, 4, 100, 99)),
           ("ragged p=3", (3, 13, 45, 3, 24, 22)),
           ("ragged p=5", (3, 11, 37, 5, 18, 17)),
           ("ragged p=6", (3, 10, 41, 6, 20, 19)),
           ("ragged p=7", (2, 9, 35, 7, 16, 15)),
           ("ragged D0=14", (2, 9, 40, 4, 14, 13))]
    k3 = [("bench", (64, 64, 96, 128, 4)), ("bench ties", (64, 64, 96, 128, 4)),
          ("adversarial L=2", (6, 24, 28, 36, 2)),
          ("D0=128 L=4", (8, 128, 32, 48, 4)), ("L=2", (8, 32, 12, 20, 2)),
          ("L=5", (4, 32, 32, 64, 5)), ("L=1 D0=6", (4, 6, 8, 10, 1))]
    k5 = [("kitti D=128", (16, 128, 96, 384, 5, 0)),
          ("kitti D=256", (8, 256, 96, 384, 5, 0)),
          ("dslab bench", (32, 64, 96, 128, 4, 0)),
          ("L=1 W0=10", (3, 6, 6, 10, 1, 0)),
          ("L=1 D0=66", (2, 66, 4, 70, 1, 0)),
          ("L=2 W0=36", (2, 36, 12, 36, 2, 0)),
          ("L=3 ragged D0=40", (2, 40, 40, 24, 3, 0)),
          ("L=3 D0=8", (2, 8, 8, 48, 3, 0)),
          ("L=4 ragged D0=48", (2, 48, 48, 80, 4, 0)),
          ("L=4 D0=16", (2, 16, 16, 16, 4, 0)),
          ("L=5 D0=32", (2, 32, 64, 32, 5, 0)),
          ("L=5 ragged", (2, 96, 64, 96, 5, 0)),
          ("L=5 off alignment", (2, 64, 32, 64, 5, 1)),
          ("L=6", (1, 64, 64, 128, 6, 0))]
    return ([(f"K4 {n}", "K4", s) for n, s in k4]
            + [(f"K3 {n}", "K3", s) for n, s in k3]
            + [(f"K5 {n}", "K5", s) for n, s in k5])


def rows_inputs(torch, kind, shape, seed, device="cuda"):
    """Inputs of one case, made on the device from a seed: K4 a pair of
    (n, p*h0, p*w0) planes of uniform pixels; K3 an (n, d0, h0, w0) volume,
    uniform in [0, 1), or in quarter steps 0..1.25 where the case is named
    'ties'; K5 both, flat, with room for its offset view (`k5_volume`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "K5":      # flat, 8 spare elements for the offset view
        n, d0, h0, w0, _, _ = shape
        size = n * d0 * h0 * w0 + 8
        return (torch.rand(size, generator=gen, device=device),
                torch.randint(0, 6, (size,), generator=gen, device=device)
                .float() / 4)
    if kind == "K4":
        n, h0, w0, p, *_ = shape
        return tuple(torch.rand((n, p * h0, p * w0), generator=gen,
                                device=device) for _ in range(2))
    return (torch.rand(shape[:4], generator=gen, device=device),
            torch.randint(0, 6, shape[:4], generator=gen, device=device)
            .float() / 4)


def k5_volume(shape, flat, dtype="float32"):
    """A K5 case's (n, d0, h0, w0) volume in `dtype`: a view `offset`
    elements into the flat input (off 16-byte alignment where offset is
    not a multiple of the 16-byte word)."""
    import torch

    n, d0, h0, w0, _, offset = shape
    flat = flat.to(getattr(torch, dtype))
    return flat[offset:offset + n * d0 * h0 * w0].view(n, d0, h0, w0)


def k5_launch(shape, volume, fast, plain=False):
    """K5's (top, *offsets) on `volume` through aggregate_dmajor (or its
    plain version)."""
    from deepmatching_stereo_matching_tpu_torch.ops import pyramid_cuda

    fn = (pyramid_cuda.aggregate_dmajor_torch if plain
          else pyramid_cuda.aggregate_dmajor)
    top, args = fn(volume, shape[4], 1.4, fast)
    return (top, *args)


def rows_launch(kind, shape, inputs, name="", plain=False, dtype="float32"):
    """K4's volume (in `dtype`) or K3's (disparity, score) on the case's
    volume rounded to `dtype`, through the kernel's wrapper (or its plain
    version).  K5 cases go through `k5_volume` and `k5_launch`."""
    from deepmatching_stereo_matching_tpu_torch.config import Config, Geometry
    import torch

    from deepmatching_stereo_matching_tpu_torch.ops import (fused_cuda,
                                                            pyramid_cuda)

    if kind == "K4":
        n, h0, w0, p, d0, max_d = shape
        cfg = Config(max_disparity=max_d, patch_size=p, dtype=dtype)
        geom = Geometry(height=p * h0, width=p * w0, levels=1,
                        padded_height=p * h0, padded_width=p * w0,
                        grid_h=h0, grid_w=w0, disparities=d0)
        if plain:
            return fused_cuda.cost_volume_torch(*inputs, cfg, geom).to(
                getattr(torch, dtype))
        return fused_cuda.cost_volume_rows(*inputs, cfg, geom)
    volume = (inputs[1] if "ties" in name else inputs[0]).to(
        getattr(torch, dtype))
    if plain:
        return pyramid_cuda.pyramid_body(volume, shape[4], 1.4, fast=False)
    return pyramid_cuda.pyramid_backtrack(volume, shape[4], 1.4)


def k1_witness(shape, levels, inputs, volume):
    """K1 (patch form) on the planes of a small K4 case, and how many of
    its scores differ from K4's volume at K1's disparities: K1's witness."""
    from deepmatching_stereo_matching_tpu_torch.config import Config
    from deepmatching_stereo_matching_tpu_torch.ops import fused_cuda

    n, h0, w0, p, d0, max_d = shape
    cfg = Config(max_disparity=max_d, levels=levels, patch_size=p)
    d, s = fused_cuda.match_planes(*inputs, cfg, cfg.geometry(h0 * p, w0 * p))
    at = volume.gather(-3, d.long().unsqueeze(-3)).squeeze(-3)
    return (d, s), int((at != s).sum())


def time_rows(hashes: Path):
    """--rows: times of K4 at KITTI D=128 and D=256 and K3 at the bench, a
    hash of every case's outputs and of each fused_kernel instance's SASS,
    written to `hashes` if it does not exist, else compared with it."""
    import hashlib
    import json
    import re

    import torch

    from deepmatching_stereo_matching_tpu_torch.ops import _build

    small = 1 << 20      # outputs kept for the comparison, elements
    kept = hashes.with_suffix(hashes.suffix + ".npz")
    writing = not hashes.exists()
    want = {} if writing else json.loads(hashes.read_text())
    earlier = {} if writing else dict(np.load(kept))

    def digest(*parts):
        h = hashlib.sha256()
        for x in parts:
            h.update(x.encode() if isinstance(x, str)
                     else x.cpu().numpy().tobytes())
        return h.hexdigest()

    so = _build.build(force=True)
    shown = False       # ptxas lines of costrows, pyramid, aggregate
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            shown = bool(re.search(
                r"costrows_kernel|pyramid_kernel|aggregate_", m.group(1)))
        if shown:
            print("  " + line.strip())
    got = {}
    for fn, lines in (sass(so, "fused_kernel") or {}).items():
        m = re.search(r"fused_kernelILi(\d+)ELb([01])E(?:Lb([01])E)?", fn)
        bf16 = ", bf16" if m.group(3) == "1" else ""
        got[f"SASS fused_kernel<{m.group(1)}, {m.group(2)}{bf16}>"] = digest(
            "\n".join(lines))
    print(f"fused_kernel SASS {_build.SRC_DIR}: "
          f"{ {k: v[:12] for k, v in got.items()} }", flush=True)
    timed = ("K4 kitti D=128", "K4 kitti D=256", "K3 bench", "K3 bench bf16")
    levels_of = {f"K4 {small_name(*t)}": t[3] for t in SMALL_TILES}
    cases = [(seed, name, kind, shape, "float32")
             for seed, (name, kind, shape) in enumerate(rows_cases())
             if kind != "K5"]
    cases += [(seed, f"{name} bf16", kind, shape, "bfloat16")
              for seed, name, kind, shape, _ in cases if kind == "K3"]
    for seed, (name, kind, shape) in enumerate(rows_cases()):
        if kind == "K5":
            k5_rows(torch, got, digest, seed, name, shape)
    for seed, name, kind, shape, dtype in cases:
        inputs = rows_inputs(torch, kind, shape, seed)
        out = rows_launch(kind, shape, inputs, name, dtype=dtype)
        torch.cuda.synchronize()
        if name in levels_of:
            k1, off = k1_witness(shape, levels_of[name], inputs, out)
            got["K1 " + name[3:]] = digest(*k1)
            print(f"  K1 {name[3:]}: scores vs K4's volume at K1's "
                  f"disparities: {off} of {k1[1].numel()} differ")
        outs = out if isinstance(out, tuple) else (out,)
        got[name] = digest(*outs)
        for k, x in enumerate(outs):
            key = f"{name} {k}"
            if writing and x.numel() <= small:
                earlier[key] = x.cpu().numpy()
                for m, y in enumerate(inputs):
                    if y.numel() <= small:
                        earlier[f"{name} input {m}"] = y.cpu().numpy()
            elif key in earlier and got[name] != want.get(name):
                was = torch.from_numpy(earlier[key]).to(x.device)
                print(f"  {key} differs at {int((x != was).sum())} of "
                      f"{x.numel()}: max |diff| "
                      f"{float((x.double() - was.double()).abs().max()):.3e}")
        if name in timed:     # K3's volume rounded once, outside the timing
            tin = (tuple(x.to(getattr(torch, dtype)) for x in inputs)
                   if kind == "K3" else inputs)
            ms = _median_launch_ms(torch, lambda: rows_launch(
                kind, shape, tin, name, dtype=dtype))
            print(f"{name} {shape} {_build.SRC_DIR}: ms per call, 5 x 20 "
                  f"launches: " + " ".join(f"{x:.4f}" for x in ms)
                  + f"; median {float(np.median(ms)):.4f}", flush=True)
        del inputs, out
    if writing:
        hashes.write_text(json.dumps(got, indent=1))
        np.savez(kept, **earlier)
        print(f"rows: {len(got)} hashes written to {hashes}")
        return 0
    new = sorted(k for k in got if k not in want)
    differ = sorted(k for k in got if k in want and want[k] != got[k])
    print(f"rows: {len(got) - len(new) - len(differ)} of "
          f"{len(got) - len(new)} hashes equal to {hashes}; differ: "
          f"{differ}; new, not compared: {new}", flush=True)
    return 1 if differ else 0


def k5_rows(torch, got, digest, seed, name, shape):
    """--rows for one K5 case: a hash of (top, every level's offsets) in
    each mode and dtype, on real-valued and on tie-heavy volumes; at the
    KITTI shapes the event and device times of a call in each dtype and
    mode (fast: the fused route's; exact: the exact route's)."""
    from deepmatching_stereo_matching_tpu_torch.ops import _build, pyramid_cuda

    flat = rows_inputs(torch, "K5", shape, seed)
    for dtype in ("float32", "bfloat16"):
        tag = "" if dtype == "float32" else " bf16"
        for fast in (True, False):
            mode = "fast" if fast else "exact"
            for real, x in zip(("", " ties"), flat):
                out = k5_launch(shape, k5_volume(shape, x, dtype), fast)
                torch.cuda.synchronize()
                got[f"{name}{real} {mode}{tag}"] = digest(*(
                    t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                    for t in out))   # numpy has no bf16: hash the bits
                del out
        if name.startswith("K5 kitti"):
            vol = k5_volume(shape, flat[0], dtype)
            for fast in (True, False):
                def call(vol=vol, fast=fast):
                    return pyramid_cuda.aggregate_dmajor(vol, shape[4], 1.4,
                                                         fast)
                ms = _median_launch_ms(torch, call)
                dev = device_ms(torch, call, "aggregate")
                print(f"{name}{tag} {'fast' if fast else 'exact'} "
                      f"{shape[:5]} {_build.SRC_DIR}: ms per call, 5 x 20 "
                      f"launches: " + " ".join(f"{x:.4f}" for x in ms)
                      + f"; median {float(np.median(ms)):.4f}; device "
                      f"{dev:.4f} ms per call (profiler)", flush=True)
            if name == "K5 kitti D=128":
                # Where the time goes: the same volume aggregated to depth
                # 1 and 2 (level 0, then level 1 too, no level warp), and
                # one read of the volume by torch (a max over D).
                for lv in (1, 2):
                    ms_l = _median_launch_ms(
                        torch, lambda lv=lv, vol=vol:
                        pyramid_cuda.aggregate_dmajor(vol, lv, 1.4, True))
                    print(f"  {name}{tag} to depth {lv}: median "
                          f"{float(np.median(ms_l)):.4f} ms", flush=True)
                ms_r = _median_launch_ms(torch, lambda vol=vol:
                                         vol.amax(dim=1))
                print(f"  {name}{tag} read yardstick (torch amax over D): "
                      f"median {float(np.median(ms_r)):.4f} ms", flush=True)
            del vol
    del flat


def device_ms(torch, fn, kernel, calls=20):
    """Device time per call of fn() in the kernels whose name holds
    `kernel` (torch.profiler's CUDA rows), over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if kernel in e.key) / calls / 1e3


# Kernel instances matched across checkouts for --sass-diff: a pattern on
# the mangled name -> the instance's template arguments.  An instance whose
# checkout did not template its kernel yet (pyramid_kernel, float32
# costvol_kernel) matches its float32 instance.
SASS_KERNELS = {
    "fused_kernel": r"fused_kernelILi(\d+)ELb([01])ELb([01])E",
    "costvol_kernel": r"costvol_kernelILb([01])ELb([01])E(f|13__nv_bfloat16|)E",
    "costrows_kernel": r"costrows_kernelILi(\d+)E(f|13__nv_bfloat16)E",
    "costrows_magbin_kernel":
        r"costrows_magbin_kernelILi(\d+)E(f|13__nv_bfloat16)E",
    "pyramid_kernel": r"pyramid_kernel(?:ILb([01])E)?",
    "aggregate_kernel": r"aggregate_kernelILb([01])ELb([01])ELb([01])E",
    "stream_kernel": r"stream_kernelILi(\d+)E",
}


def _instance(fn):
    """(kernel, template arguments) of a mangled SASS function name."""
    import re

    for kernel, pattern in SASS_KERNELS.items():
        m = re.search(pattern, fn)
        if m:
            args = tuple({"": "f", None: "0"}.get(g, g) for g in m.groups())
            return kernel, tuple("bf16" if a == "13__nv_bfloat16" else a
                                 for a in args)
    return None


def sass_bodies(root: Path):
    """{(kernel, template arguments): its SASS lines} of the library built
    from the port package under `root` (in a process of its own)."""
    import re
    import subprocess

    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from deepmatching_stereo_matching_tpu_torch.ops import _build; "
            "print(_build.build(force=True))")
    so = subprocess.run([sys.executable, "-c", code, str(root)],
                        capture_output=True, text=True, check=True
                        ).stdout.strip().splitlines()[-1]
    out = {}
    for kernel in SASS_KERNELS:
        for fn, lines in (sass(so, kernel) or {}).items():
            key = _instance(fn)
            if key is None:
                continue
            while lines and not lines[-1].strip(" \t."):
                lines = lines[:-1]  # the separator after the last one differs
            # cuobjdump pads every line of a cubin to its longest
            # instruction, which a new instance in the same source moves.
            out[key] = [" ".join(re.sub(r"\.L_x_\d+", ".L_x", x).split())
                        for x in lines]
    return out


def sass_diff(other: Path) -> int:
    """--sass-diff: the instruction bodies of every kernel instance of this
    checkout against those of `other`'s, matched by template arguments;
    exit 1 if an instance both have differs."""
    here = sass_bodies(Path(__file__).resolve().parent.parent)
    there = sass_bodies(other)
    differ = []
    for key in sorted(here.keys() | there.keys()):
        if key not in here or key not in there:
            print(f"{key}: only in {'this checkout' if key in here else other}")
            continue
        same = here[key] == there[key]
        print(f"{key}: {len(here[key])} SASS lines, "
              f"{'equal' if same else 'DIFFER'}")
        if not same:
            differ.append(key)
    print(f"sass-diff against {other}: {len(differ)} instances differ: "
          f"{differ}", flush=True)
    return 1 if differ else 0


# chip_smoke.py's dataset-evaluation pairs (phase 4e): KITTI image sizes
# (padded 384x1536, a 96x384 patch grid), fields below 128, seeds 7-10;
# Middlebury-size scenes (450x375), fields below 64, seeds 100-101.
EVAL_KITTI_HW = ((375, 1242), (376, 1241), (370, 1224), (370, 1226))
EVAL_MB_HW, EVAL_MB_SEEDS, EVAL_KITTI_SEED = (375, 450), (100, 101), 7


def eval_pairs():
    """[(layout, name, left, right, gt)] of chip_smoke's
    phase 4e: 8-bit images as they are written to disk and read back; gt
    in pixels, -1 where the pair has none."""
    from deepmatching_stereo_matching_tpu_torch.data import synthetic

    def u8(a):
        return np.clip(a * 255.0, 0, 255).astype(np.uint8)

    out = []
    for layout, sizes, seeds, max_d in (
            ("kitti", EVAL_KITTI_HW,
             range(EVAL_KITTI_SEED, EVAL_KITTI_SEED + len(EVAL_KITTI_HW)),
             128),
            ("middlebury", [EVAL_MB_HW] * len(EVAL_MB_SEEDS), EVAL_MB_SEEDS,
             64)):
        for i, ((h, w), seed) in enumerate(zip(sizes, seeds)):
            field = synthetic.block_disparity_field(
                h, w, max_d, np.random.default_rng(seed), block=48)
            left, right, gt = synthetic.make_pair(h, w, field, seed=seed)
            name = f"{i:06d}_10" if layout == "kitti" else f"scene{seed}"
            out.append((layout, name, u8(left), u8(right), gt))
    return out


def _median_launch_ms(torch, fn):
    """Five samples of the mean time of 20 calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / 20)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--routes", default="fused,exact")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    help="Config.dtype of the profiled steps: float32, "
                         "bfloat16, or both comma-separated")
    ap.add_argument("--strategies", default="",
                    help=f"sharded strategies to profile (or with "
                         f"--step-times time) too, of "
                         f"{','.join(STRATEGIES)}")
    ap.add_argument("--k1", action="store_true",
                    help="time K1 and K1b alone at the bench shapes")
    ap.add_argument("--costvol", action="store_true",
                    help="time K2/K6 and hash their volumes on every "
                         "chip_smoke shape")
    ap.add_argument("--rows", action="store_true",
                    help="time K4/K3 and hash their outputs on every "
                         "chip_smoke shape")
    ap.add_argument("--stages", action="store_true",
                    help="profile the stream's and the API's stages on the "
                         "--cells")
    ap.add_argument("--step-times", action="store_true",
                    help="time the --cells steps per --dtype and --routes "
                         "(7 samples, median, range, peak memory)")
    ap.add_argument("--sass-diff", type=Path, metavar="ROOT",
                    help="compare every kernel instance's SASS with the "
                         "build of the checkout at ROOT")
    ap.add_argument("--hashes", type=Path,
                    help="--costvol/--rows: the hash file to write, or to "
                         "compare with where it exists")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="checkout whose port package --k1/--costvol/--rows "
                         "times")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import deepmatching_stereo_matching_tpu_torch as pkg

    if not torch.cuda.is_available():
        print("profile_steps: needs a CUDA device", file=sys.stderr)
        return 2
    if not Path(pkg.__file__).resolve().is_relative_to(root):
        print(f"profile_steps: the port package came from {pkg.__file__}, "
              f"not {root}: run this file as a script", file=sys.stderr)
        return 2
    if args.k1:
        time_k1()
        return 0
    if args.sass_diff:
        return sass_diff(args.sass_diff.resolve())
    if args.costvol or args.rows:
        if args.hashes is None:
            ap.error("--costvol and --rows need --hashes")
        run = time_costvol if args.costvol else time_rows
        return run(args.hashes.resolve())
    cells = args.cells.split(",")
    routes = [r for r in args.routes.split(",") if r]
    strategies = [s for s in args.strategies.split(",") if s]
    dtypes = [d for d in args.dtype.split(",") if d]

    def run():
        if args.stages:
            profile_stages(cells, args.steps)
        elif args.step_times:
            time_steps(cells, routes, dtypes, strategies)
        else:
            profile_cells(cells, routes, args.steps, strategies, dtypes)
    if not strategies and not args.stages:
        run()
        return 0
    import tempfile

    import torch.distributed as dist

    from deepmatching_stereo_matching_tpu_torch.parallel import launch

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as rdzv:
        launch.init("nccl", 0, 1, str(Path(rdzv) / "rendezvous"))
        try:
            run()
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
