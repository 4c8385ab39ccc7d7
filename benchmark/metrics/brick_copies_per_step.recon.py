"""Bricked copies of the density a reconstruction step (brick_copy_kernel launches in the trace)."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "copies", "lower", "device_trace"
LAYER = "bricked copy"
MOVES = "recon_step_ms"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return readers.launches(ctx, "brick_copy")
