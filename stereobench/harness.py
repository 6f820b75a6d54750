"""One run of one cell, assembled from the files that `BENCHMARK.json`
names: nothing here depends on which cell runs but through them.

  configs/<config>.json   the deployment: sizes, the `Config` fields, the
                          route, the pair recipe, the control's dtype;
  traffic/<mix>.json      the name of its driver and the driver's
                          parameters (drive.py);
  drivers/<driver>.py     a traffic driver: `run(ctx)` drives the program
                          and returns its `drive.Outcome`;
  limits/<cell>.json      the limit of each number `check.py` compares,
                          with the readings it was set from;
  metrics/<metric>.py     a per-layer metric's reader: `read(rec)` returns
                          a number, or None where it finds nothing to read
                          (the metric is then left out of the line).

A cell named `<config>.<mix>` in `BENCHMARK.json` takes the files of its
`config` and `traffic`; a later cell, configuration, mix, driver or metric
comes with new files and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
import types
from typing import Any, Dict, List, Optional

from . import check, drive, reference, tracing

PACKAGE = "deepmatching_stereo_matching_tpu_torch"
# What no run may load: JAX, its libraries and the JAX package, compared
# by whole top-level names (the port's name begins with the last one).
FORBIDDEN = ("jax", "jaxlib", "flax", "deepmatching_stereo_matching_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the cell's files, the reference's
    configuration and geometry (for the work model), the traced window,
    the program's own JSONL records, and the driver's own measurements
    of the run (`drive.Outcome.values`)."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    cfg: reference.Config
    geom: reference.Geometry
    batch: int
    trace: tracing.Trace
    logs: List[dict]
    values: Dict[str, float]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: str

    def _load(self, folder: str, name: str):
        """The module `stereobench/<folder>/<name>.py` of this root."""
        path = os.path.join(self.root, "stereobench", folder, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"stereobench_{folder}_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        return self._load("metrics", metric).read

    def driver(self):
        return self._load("drivers", self.traffic["driver"]).run


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json and its files; KeyError
    if the manifest has no such cell."""
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    sb = os.path.join(root, "stereobench")
    return Cell(name=name, chips=w["chips"],
                config=_json(os.path.join(root, conf["file"])),
                traffic=_json(os.path.join(sb, "traffic",
                                           w["traffic"] + ".json")),
                limits=_json(os.path.join(sb, "limits", name + ".json")),
                end_to_end=e2e, per_layer=per_layer, root=root)


def port_modules():
    """The program's modules that the drivers call."""
    from importlib import import_module
    names = {"api": "api", "pipeline": "models.pipeline",
             "runner": "parallel.runner", "sharded": "parallel.sharded",
             "launch": "parallel.launch", "mesh": "parallel.mesh",
             "logging": "utils.logging", "config": "config"}
    mods = {k: import_module(f"{PACKAGE}.{v}") for k, v in names.items()}
    mods["JsonlLogger"] = mods["logging"].JsonlLogger
    return types.SimpleNamespace(**mods)


def device_info(device, trace: Optional[tracing.Trace]) -> Dict[str, Any]:
    import torch
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": None}
    else:
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
                "power_limit": power_limit()}
    if trace is not None and device.type == "cuda":
        info["busy_s"] = tracing.busy_seconds(trace)
        info["window_s"] = trace.window_s
    return info


def power_limit() -> Optional[str]:
    """The card's `nvidia-smi` name and power limit, as it prints them."""
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, control: bool = False,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)
             ) -> Dict[str, Any]:
    """One run: set-up, the window, the check.  Returns the result line
    as a dict, with the check's lines under `_check_lines`."""
    conf, traffic = cell.config, cell.traffic
    port = port_modules()
    fields = dict(conf["config"])
    if control:
        fields.update(conf["control"])
    cfg = port.config.Config(**fields)
    ref_cfg = reference.Config(**conf["config"])
    tracer = tracing.Tracer(trace, device.type == "cuda",
                            traffic.get("trace_seconds"))
    ctx = drive.Context(
        port=port, device=device, cfg=cfg, ref_cfg=ref_cfg,
        height=conf["height"], width=conf["width"], route=conf["route"],
        recipe=conf["recipe"], traffic=traffic, seed=seed, seconds=seconds,
        tracer=tracer)
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    out = cell.driver()(ctx)
    setup_s = out.window_start - t_process
    dev = device_info(device, tracer.read())
    for line in out.notes:
        log(line)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {bad}")

    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if trace:
        rec = Record(cell=cell.name, config=conf, traffic=traffic,
                     cfg=ref_cfg,
                     geom=ref_cfg.geometry(conf["height"], conf["width"]),
                     batch=out.batch, trace=tracer.trace, logs=out.logs,
                     values=out.values)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if device.type == "cuda":
            breakdown = tracing.breakdown(tracer.trace)
    else:
        values = dict(out.values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # The check runs once the window has closed, the peak has been read
    # and the driver's device state is gone.
    t0 = time.perf_counter()
    numbers, missing = check.compare(out.samples, ref_cfg)
    correct, lines = check.judge(numbers, missing, cell.limits)
    log(f"reference over {len(out.samples)} pairs took "
        f"{time.perf_counter() - t0!r} s")
    result: Dict[str, Any] = {
        "correct": correct, "attempted": out.attempted,
        "failed": out.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                        for k in check.NUMBERS}
    result["checks"]["missing_answers"] = {"value": missing, "limit": 0}
    result["_check_lines"] = lines
    return result
