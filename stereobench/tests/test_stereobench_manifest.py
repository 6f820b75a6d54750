"""BENCHMARK.json against the contract it is written to, and each name in
it against the files the harness finds by that name."""

import json
import os
import re

import pytest

from stereobench import check, reference

from .conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_keys_and_sizes(manifest):
    assert list(manifest) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    n = len(manifest["workloads"])
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= n <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16
    assert 1 <= len(manifest["per_layer"]) <= 128


def test_names_units_and_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    setup = [m for m in manifest["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] == 0.25


def _reports(manifest, cell):
    e2e = {m["name"] for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e)]
    return e2e, layer


def test_every_cell_reports_what_its_metrics_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e_names = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e_names
    for cell in cells:
        e2e, layer = _reports(manifest, cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])


def test_metrics_of_one_layer_name_it_alike(manifest):
    by_prefix = {}
    for m in manifest["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_every_name_has_its_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in
                                          manifest["paths"]))
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        cfg = reference.Config(**conf["config"])
        geom = cfg.geometry(conf["height"], conf["width"])
        assert {k: getattr(geom, k) for k in conf["geometry"]} \
            == conf["geometry"]
        reference.Config(**{**conf["config"], **conf["control"]})
    for w in manifest["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        with open(os.path.join(BENCH, "traffic",
                               w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           driver + ".py"))
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        assert all(0 < limits[k] < 1 for k in check.NUMBERS)
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_check_cost_fits_the_day(manifest):
    """The driver's full check with 24 cells: 2 + 14 x 24 runs of
    run_seconds + 60 s, 2 x 90 s a cell to compile, 1200 s spare."""
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
