"""Device kernels a registration step, counted in the trace."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "launches", "lower", "device_trace"
LAYER = "registration loop"
MOVES = "reg_step_ms"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return readers.launches(ctx)
