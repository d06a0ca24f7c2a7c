"""BENCHMARK.json against the contract it is written to, and the files
it names found by name."""

import json
import re

import pytest

from perfbench import harness, inputs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.spec()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [e["name"] for table in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[table]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"} and m["workloads"]
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_harness_finds_every_file_a_cell_names(workload):
    files = harness.cell_files(BENCH, workload)
    for key in ("config", "mix", "limits"):
        assert files[key].is_file(), files[key]
    cfg = harness.load_json(files["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == files["cell"]["config"])
    assert set(entry) == {"name", "source", "file", "reduced", "why"} and entry["file"].startswith("perfbench/")
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert cfg["precision"]["allow_tf32"] is False
    assert callable(inputs.resolve(harness.load_json(files["mix"])["generator"]))
    assert set(cfg["sides"]) == {"program", "reference", "control"}
    for path in cfg["sides"].values():
        assert callable(inputs.resolve(path))
    for part in cfg["parts"]:
        assert {"program", "reference", "args"} <= set(cfg[part])
    assert harness.load_json(files["limits"])["limits"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(harness.reader(metric))
    assert harness.reader(metric)({"spans": {}, "profile": None, "window": {}}) is None
    for workload in entry["workloads"]:
        moved = [m["name"] for m in harness.reported(BENCH, workload, "end_to_end")]
        assert entry["moves"] in moved, (workload, entry["moves"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.reported(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.reported(BENCH, w["name"], "per_layer")


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    json.dumps(BENCH)
