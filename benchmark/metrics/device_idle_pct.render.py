"""The traced window's share in which no operation ran on the device, renders."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "render_rays_per_s"
WORKLOADS = ["render-b32-chest133-siddon", "render-b8-chest512-trilinear"]


def read(ctx):
    return readers.idle_pct(ctx)
