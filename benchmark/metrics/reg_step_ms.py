"""A registration step: the window's seconds over all its steps (each a
batched step and the read of its scores), run starts included."""

from benchmark.yardstick.window import seconds_per_iteration

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return 1e3 * seconds_per_iteration([ctx.window_s], ctx.steps)
