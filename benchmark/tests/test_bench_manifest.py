"""BENCHMARK.json and every file it names load by name, and the manifest
keeps to the limits the benchmark's contract sets on names, units, keys
and sizes."""

import json
import os
import re

import pytest

from benchmark import harness, loader

ROOT = harness.ROOT
MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                     "per_layer") else set())
        assert KEYS[section] <= set(e)
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(w["name"], MAN, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(w["name"], MAN, True)
        assert w["chips"] == 1


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert used == {c["name"] for c in MAN["configs"]}
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and key in cfg["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_load_by_name(cell):
    w = harness.find_cell(cell, MAN)
    config, traffic, limits = harness.cell_files(w, MAN)
    assert {"operator", "options", "control"} <= set(config)
    assert {"entry", "options", "pool", "samples"} <= set(traffic)
    op = loader.load("operators", config["operator"])
    assert callable(op.program) and callable(op.reference)
    entry = loader.load("entries", traffic["entry"])
    for fn in ("prepare", "call", "numbers"):
        assert callable(getattr(entry, fn))
    spec = traffic.get("reference")
    if spec is not None:
        assert callable(loader.load("reference/solvers",
                                    spec["solver"]).solve)
        assert callable(loader.load("reference/precons",
                                    spec["precon"]).make)
    assert limits["not_success"] == 0 and "x_err" in limits


def test_loader_names_a_missing_file():
    with pytest.raises(KeyError, match="operators/no_such_operator.py"):
        loader.load("operators", "no_such_operator")


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["end_to_end"]
                                    + MAN["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))
