"""Every file the harness finds by name loads, and BENCHMARK.json keeps the
contract's shape."""

import json
import re

import pytest

from benchmark import harness, trace

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in metrics])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["source"] == cfg["source"]
    assert cfg["reduced"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_workload_file_loads_and_builds(cell):
    wl, cfg = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert set(wl["limits"]) == {"loss_gap", "grad_gap", "update_gap"}
    _, solver = harness.build_program(cfg, wl, "cpu")
    harness.check_layout(solver, cfg, solver.jump_diff)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    per = harness.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    assert all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    assert callable(harness.load_metric(metric["name"]))


def test_layer_files_load():
    layers = trace.load_layers(harness.HERE / "layers")
    assert layers == {"rollout_fwd": ["FusedRollout"],
                      "rollout_bwd": ["FusedRolloutBackward"],
                      "sweep_fwd": ["FusedSweep"],
                      "sweep_bwd": ["FusedSweepBackward"]}
