"""Tiny versions of the cells, for the CPU: the same files, shrunk."""

from __future__ import annotations

import copy

from benchmark import harness

# Odd, unequal sizes: no ray of the tiny scenes runs along a voxel face.
SCALE_CT = {"chest512-trilinear-512": [23, 25, 21], "chest133-siddon-200": [47, 49, 13]}
PIXELS = 31
TRAFFIC = {
    "registration": dict(starts=2, pool=4, n_iters=4, trace_steps=3),
    "reconstruction": dict(views=4, n_iters=4, trace_steps=3),
    "render": dict(batch=2, pool=8, kept=2, trace_steps=3),
}


def tiny_cell(name: str, n_points: int = 20) -> harness.Cell:
    """The cell ``name`` at a size the CPU runs in seconds: its CT and
    detector shrunk with their fields of view kept, its traffic cut."""
    cell = harness.Cell(name)
    cfg = copy.deepcopy(cell.config)
    shape = SCALE_CT[cfg["name"]]
    cfg["ct"]["spacing"] = [sp * n / m for sp, n, m in
                            zip(cfg["ct"]["spacing"], cfg["ct"]["shape"], shape)]
    cfg["ct"]["shape"] = shape
    det = cfg["detector"]
    for k in ("delx", "dely"):
        det[k] = det[k] * det["height"] / PIXELS
    det["height"] = det["width"] = PIXELS
    if "n_points" in cfg.get("render_options", {}):
        cfg["render_options"]["n_points"] = n_points
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **TRAFFIC[cell.traffic["kind"]])
    return cell
