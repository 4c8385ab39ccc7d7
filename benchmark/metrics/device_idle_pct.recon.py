"""The traced window's share in which no operation ran on the device, reconstruction."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "recon_step_ms"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return readers.idle_pct(ctx)
