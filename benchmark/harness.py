"""The benchmark's harness: a cell by its name in ``BENCHMARK.json``, run.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name:

* ``BENCHMARK.json``: the cells (``workloads``), their configurations and
  metrics;
* ``configs/<config>.json``: the configuration as it is run (CT, detector,
  renderer, pose, precision), the entry's ``file``;
* ``traffic/<traffic>.json``: the traffic mix's parameters; its ``kind``
  names the driver ``drivers/<kind>.py`` that runs it;
* ``cells/<workload>.json``: the cell's limits on the numbers that decide
  ``correct``, with the readings each was set from;
* ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``, which
  returns the number or None when the run has nothing to read.

A run: set-up (the program's objects, its build and first calls, the
first steps the reference follows), then the measured window of
``seconds`` on the host clock (``--trace 0``) or a traced stretch of the
traffic's ``trace_steps`` steps (``--trace 1``), then the device's peak
memory, the program's state freed, and the reference's comparison.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "diffdrr_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, spec: dict = None, root: Path = HERE):
        spec = load_json(root.parent / "BENCHMARK.json") if spec is None else spec
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, found[0]
        cfg = [c for c in spec["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(root.parent / cfg["file"])
        self.traffic = load_json(root / "traffic" / f"{self.workload['traffic']}.json")
        self.cell = load_json(root / "cells" / f"{name}.json")
        self.limits = {k: v["limit"] for k, v in self.cell["limits"].items()}
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in spec["end_to_end"] if _listed(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        self.root = root


def _listed(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def driver_class(kind: str, root: Path = HERE):
    return importlib.import_module(f"{root.name}.drivers.{kind}").Driver


def metric_reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{root.name}.metrics.{name}", path,
                                                  submodule_search_locations=None)
    module = importlib.util.module_from_spec(spec)
    module.__package__ = f"{root.name}.metrics"
    spec.loader.exec_module(module)
    return module


def card_record(torch, chips: int) -> dict:
    """The device fields of the result line, on a card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        out = f"not read: {type(e).__name__}"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()), "nvidia_smi": out}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             storage=None, t_start=None, log=print) -> dict:
    """Run one cell and return the result line's object (without the
    import check, which the caller makes once the process is done)."""
    import torch

    from .yardstick import trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    log(f"torch_s {time.perf_counter() - t_start:.3f}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()  # the card's start
        log(f"card_s {time.perf_counter() - t_start:.3f}")
    Driver = driver_class(cell.traffic["kind"], cell.root)
    log(f"imports_s {time.perf_counter() - t_start:.3f}")
    drv = Driver(cell.config, cell.traffic, seed, device, storage)
    drv.sync()
    log(f"objects_s {time.perf_counter() - t_start:.3f}")
    drv.setup()
    drv.sync()
    ctx = SimpleNamespace(trace=None, setup_s=time.perf_counter() - t_start)
    log(f"setup_s {ctx.setup_s:.3f}")

    attempted = 0
    if not trace:
        step_s, work = [], 0
        t0 = last = time.perf_counter()
        while True:
            work += drv.step()
            now = time.perf_counter()
            step_s.append(now - last)
            last, attempted = now, attempted + 1
            if now - t0 >= seconds:
                break
        drv.sync()
        window_s = time.perf_counter() - t0
        ctx.window_s, ctx.steps, ctx.step_s, ctx.work = window_s, attempted, step_s, work
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        for _ in range(2):  # steady state before the trace
            drv.step()
        drv.sync()
        drv.mark_trace()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        n = cell.traffic["trace_steps"]
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW_SPAN):
                for _ in range(n):
                    with record_function(trace_mod.STEP_SPAN):
                        drv.step()
                drv.sync()
        attempted = n
        ctx.trace = trace_mod.from_profiler(prof, n)
        del prof
    device_rec = card_record(torch, cell.chips) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        device_rec["busy_s"] = ctx.trace.busy_s
        device_rec["window_s"] = ctx.trace.window_s
        ctx.trace.costs = drv.costs()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], cell.root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    drv.release()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = drv.compare(device)
    log(f"reference_s {time.perf_counter() - t_ref:.3f}")
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in checks.items()}
    failed = drv.failed
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    return result
