"""``yardstick/spans.py`` on hand-built traces, and the DRR dispatch's span
metrics of every tiny cell traced on the CPU."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell
from benchmark.yardstick import readers, spans
from benchmark.yardstick.trace import STEP_SPAN, WINDOW_SPAN, DeviceTrace

SEED = 2 ** 31 + 4242


def _ctx(ops, host, steps=2):
    return SimpleNamespace(trace=DeviceTrace(ops, host, 0.0, 10.0, steps))


# The device busy over [1, 2], [4, 5], [8, 9] of a window [0, 10]: idle 7 s.
OPS = [("siddon_fwd_kernel", 1.0, 2.0), ("siddon_fwd_kernel", 4.0, 5.0),
       ("joseph_fwd_kernel", 8.0, 9.0)]
HOST = [
    (WINDOW_SPAN, 0.0, 10.0, 0),
    ("drr.render", -1.0, 0.3, 0),  # opened before the window
    ("drr.sync", -0.5, 0.2, 1),  # as is its sync: not the window's
    (STEP_SPAN, 0.4, 5.2, 1),
    ("drr.pose", 0.5, 1.5, 2),
    ("drr.render", 1.5, 3.0, 2),
    ("aten::mm", 1.6, 1.7, 3),
    ("drr.sync", 2.5, 3.0, 3),
    ("drr.pose", 5.5, 6.0, 2),
    ("drr.render", 6.0, 7.5, 2),
    ("drr.pose", 6.5, 6.8, 0),  # a second thread's, opened inside the render
    ("drr.sync", 7.0, 7.2, 3),
    ("drr.render", 9.5, 11.0, 2),  # runs past the window's end
    ("drr.sync", 9.8, 10.5, 3),  # starts inside it: the window's
]


def test_idle_goes_to_the_most_recently_opened_span():
    parts = spans.idle_by_span(_ctx(OPS, HOST))
    # pose [0.5, 1], [5.5, 6], the second thread's [6.5, 6.8]; sync [0, 0.2],
    # [2.5, 3], [7, 7.2], [9.8, 10]; render the rest of the renders' idle.
    assert parts == pytest.approx({"drr.pose": 13.0, "drr.render": 19.0, "drr.sync": 11.0,
                                   "outside": 27.0})
    assert sum(parts.values()) == pytest.approx(readers.idle_pct(_ctx(OPS, HOST)))
    assert spans.dispatch_idle_pct(_ctx(OPS, HOST)) == pytest.approx(43.0)


def test_syncs_count_those_that_start_inside_the_window():
    assert spans.syncs_per_step(_ctx(OPS, HOST)) == pytest.approx(1.5)
    assert spans.syncs_per_step(_ctx(OPS, HOST, steps=3)) == pytest.approx(1.0)


def test_overlapping_spans_count_their_union_once():
    host = [(WINDOW_SPAN, 0.0, 10.0, 0), ("drr.render", 2.5, 3.5, 0),
            ("drr.render", 3.0, 4.5, 0), ("drr.pose", 2.2, 3.2, 1)]
    parts = spans.idle_by_span(_ctx(OPS, host))
    assert parts == pytest.approx({"drr.pose": 3.0, "drr.render": 15.0, "drr.sync": 0.0,
                                   "outside": 52.0})
    assert spans.dispatch_idle_pct(_ctx(OPS, host)) == pytest.approx(18.0)
    assert spans.syncs_per_step(_ctx(OPS, host)) == 0.0


def test_nothing_to_read():
    assert spans.syncs_per_step(SimpleNamespace(trace=None)) is None
    assert spans.idle_by_span(SimpleNamespace(trace=None)) is None
    assert spans.dispatch_idle_pct(SimpleNamespace(trace=None)) is None
    # A program without the spans: its idle is all outside, and neither metric reads.
    bare = _ctx(OPS, [(WINDOW_SPAN, 0.0, 10.0, 0), (STEP_SPAN, 0.4, 5.2, 1)])
    assert spans.syncs_per_step(bare) is None and spans.dispatch_idle_pct(bare) is None
    assert spans.idle_by_span(bare) == pytest.approx({"drr.pose": 0.0, "drr.render": 0.0,
                                                      "drr.sync": 0.0, "outside": 70.0})
    # No device operations (the CPU): the syncs count, the idle shares do not.
    cpu = _ctx([], HOST)
    assert spans.syncs_per_step(cpu) == pytest.approx(1.5)
    assert spans.idle_by_span(cpu) is None and spans.dispatch_idle_pct(cpu) is None


CELLS = [w["name"] for w in harness.load_json(harness.REPO / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_reads_one_sync_a_step(name):
    cell = tiny_cell(name)
    r = harness.run_cell(cell, SEED, 0.2, True, device="cpu", log=lambda m: None)
    syncs = [m for m in r["metrics"] if m.startswith("host_syncs_per_step.")]
    assert len(syncs) == 1 and r["metrics"][syncs[0]] == {"value": 1.0, "unit": "syncs"}
    assert not any(m.startswith("dispatch_idle_pct.") for m in r["metrics"])  # no device here
