"""Every cell at a tiny size on the CPU, the program's plain versions against
the reference: set-up, window, trace, comparison and the result line.

The limits are set at the cells' sizes on the card; a tiny scene's few
rays and huge voxels swing the sound readings by orders of magnitude, so
here a sound run's numbers are held far below what the faults read, and
the control and every fault must come out not correct."""

import json
import math

import pytest
import torch

from benchmark import faults, harness, run
from benchmark.tests.tiny import tiny_cell

CELLS = [w["name"] for w in harness.load_json(harness.REPO / "BENCHMARK.json")["workloads"]]
SEED = 2 ** 31 + 12345


def _quiet(msg):
    pass


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, trace):
    cell = tiny_cell(name)
    r = harness.run_cell(cell, SEED, 0.2, trace, device="cpu", log=_quiet)
    assert list(r)[-1] == "checks" and set(r) >= {"correct", "attempted", "failed", "metrics",
                                                   "device"}
    assert isinstance(r["correct"], bool)
    assert all(0 <= c["value"] < 1e-2 for c in r["checks"].values()), r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:  # the CPU gives every host-clock metric; the device's are not measured here
        assert set(r["metrics"]) == want
        assert all(v["value"] > 0 and math.isfinite(v["value"]) for v in r["metrics"].values())
    else:
        assert r["device"]["window_s"] > 0 and "breakdown" in r
    assert set(r["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    cell = tiny_cell(name)
    Driver = harness.driver_class(cell.traffic["kind"])
    a = Driver(cell.config, cell.traffic, SEED, "cpu")
    b = Driver(cell.config, cell.traffic, SEED, "cpu")
    c = Driver(cell.config, cell.traffic, SEED + 1, "cpu")
    assert torch.equal(a.inputs.hu, b.inputs.hu) and not torch.equal(a.inputs.hu, c.inputs.hu)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control: the program with its bf16 density copy."""
    r = harness.run_cell(tiny_cell(name), SEED, 0.2, False, device="cpu", storage="bf16",
                         log=_quiet)
    assert not r["correct"], r["checks"]


def _applies(name, fault):
    kind = tiny_cell(name).traffic["kind"]
    return not (fault == "frozen" and kind == "render") and not (
        fault == "altered" and kind != "render") and not (
        fault == "reversed" and kind != "registration")


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    """A step that leaves its state unchanged (training cells), half of a
    batch left out, an answer altered where it is made (render cells), the
    pose gradient reversed where it is made (registration cells)."""
    if not _applies(name, fault):
        pytest.skip(f"a {tiny_cell(name).traffic['kind']} cell cannot have the {fault} fault")
    with faults.planted(fault):
        r = harness.run_cell(tiny_cell(name), SEED, 0.2, False, device="cpu", log=_quiet)
    assert not r["correct"], r["checks"]


def test_run_prints_a_well_formed_last_line(monkeypatch, capsys):
    real = harness.run_cell
    cell = tiny_cell(CELLS[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "Cell", lambda name: cell)
    monkeypatch.setattr(harness, "run_cell",
                        lambda cell, seed, seconds, trace, **kw: real(cell, seed, seconds, trace,
                                                                      device="cpu", **kw))
    assert run.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "0.2",
                     "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and "setup_s" in line["metrics"]
    assert err.strip().splitlines()[-1] == f"correct {line['correct']}"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
