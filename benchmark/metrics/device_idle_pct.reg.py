"""The traced window's share in which no operation ran on the device, registration."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "reg_step_ms"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return readers.idle_pct(ctx)
