"""Device kernels a reconstruction step, counted in the trace."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "launches", "lower", "device_trace"
LAYER = "reconstruction loop"
MOVES = "recon_step_ms"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return readers.launches(ctx)
