"""A configuration, traffic mix, cell and metric dropped into their folders
are found by name, with no other file edited."""

import json
import shutil

from benchmark import harness
from benchmark.tests.tiny import tiny_cell


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    base = tiny_cell("render-b8-chest512-trilinear")
    (root / "configs" / "chest24-trilinear-16.json").write_text(
        json.dumps(dict(base.config, name="chest24-trilinear-16")))
    (root / "traffic" / "render-b2.json").write_text(json.dumps(base.traffic))
    (root / "cells" / "render-b2-chest24-trilinear.json").write_text(json.dumps(
        {"config": "chest24-trilinear-16", "traffic": "render-b2",
         "limits": {"image_gap": {"limit": 1e-4, "lower": 1e-6, "upper": 1e-3}}}))
    (root / "metrics" / "render_ms.render.py").write_text(
        'UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"\n\n\n'
        "def read(ctx):\n    return 1e3 * ctx.window_s / ctx.steps\n")
    spec["configs"].append({"name": "chest24-trilinear-16", "source": "test",
                            "file": "benchmark/configs/chest24-trilinear-16.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "render-b2-chest24-trilinear",
                              "config": "chest24-trilinear-16", "traffic": "render-b2",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "render_ms.render", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["render-b2-chest24-trilinear"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.Cell("render-b2-chest24-trilinear", root=root)
    assert cell.config["ct"]["shape"] == [23, 25, 21]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "render_ms.render"}
    r = harness.run_cell(cell, 99, 0.2, False, device="cpu", log=lambda m: None)
    assert r["correct"] and r["metrics"]["render_ms.render"]["value"] > 0
