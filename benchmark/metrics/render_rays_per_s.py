"""Rays rendered: all the window's rays over all its time."""

from benchmark.yardstick.window import rate

UNIT, BETTER, SOURCE = "rays/s", "higher", "host_clock"
WORKLOADS = ["render-b32-chest133-siddon", "render-b8-chest512-trilinear"]


def read(ctx):
    return rate(ctx.work, ctx.window_s)
