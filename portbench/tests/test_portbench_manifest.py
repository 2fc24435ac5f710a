"""BENCHMARK.json against the rules of its format, and every file it names
found by name."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["source"].startswith("https://")
    assert entry["file"].startswith("portbench/configs/")
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert entry["reduced"] == [] and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and _line(entry["why"])
    cell = harness.load_cell(entry["name"], 1, 1, False)
    assert cell.config["name"] == entry["config"]
    assert harness.driver(cell).KIND in ("train", "predict")
    # Its limits name readings its driver takes.
    assert cell.limits and set(cell.limits) <= set(harness.driver(cell).READINGS)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    reader = harness.metric_reader(metric["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"])
    assert _line(metric["layer"])
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", CELLS)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_pending_entries_keep_the_format(key):
    """pending.json's entries are BENCHMARK.json entries, names not taken
    there, every file they name found."""
    with open(os.path.join(harness.HERE, "pending.json")) as f:
        pending = json.load(f)
    taken = {e["name"] for e in BENCH[key]}
    for entry in pending[key]:
        assert NAME.match(entry["name"]) and entry["name"] not in taken
        if key == "workloads":
            cell = harness.load_cell(entry["name"], 1, 1, False)
            assert set(cell.limits) <= set(harness.driver(cell).READINGS)
        if key == "per_layer":
            reader = harness.metric_reader(entry["name"])
            assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
                entry["layer"], entry["unit"], entry["source"], entry["moves"])


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.for_cell(BENCH["end_to_end"], cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.for_cell(BENCH["per_layer"], cell)


def test_layers_agree():
    """Metrics of one layer name it letter for letter as PERF.md's list of
    layers does."""
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in BENCH["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


def test_files_named_from_names():
    for root, _, files in os.walk(harness.HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            if "__pycache__" not in rel:
                assert PATH.match(rel), rel
