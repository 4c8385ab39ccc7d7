"""``BENCHMARK.json`` against the contract's limits, and each file the
harness finds by a name in it."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    n = len(SPEC["workloads"])
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (harness.REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"]) and w["config"] in names
        names.append(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= METRIC_KEYS and set(m) >= METRIC_KEYS - {"workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        names.append(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) <= PER_LAYER_KEYS and set(m) >= PER_LAYER_KEYS - {"workloads"}
        assert _line(m["layer"]) and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", [])) <= cells
        names.append(m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_and_has_its_files(workload):
    cell = harness.Cell(workload, SPEC)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:  # each per-layer metric moves a metric the cell reports
        assert m["moves"] in e2e
    assert cell.cell["config"] == cell.workload["config"]
    assert cell.cell["traffic"] == cell.workload["traffic"]
    harness.driver_class(cell.traffic["kind"])
    for name, lim in cell.cell["limits"].items():
        assert lim["limit"] > lim["lower"] and (lim["upper"] is None or lim["limit"] < lim["upper"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_file_declares_what_the_entry_says(metric):
    module = harness.metric_reader(metric["name"])
    assert (module.UNIT, module.BETTER, module.SOURCE) == (metric["unit"], metric["better"],
                                                           metric["source"])
    if "workloads" in metric:
        assert module.WORKLOADS == metric["workloads"]
    if "layer" in metric:
        assert (module.LAYER, module.MOVES) == (metric["layer"], metric["moves"])
