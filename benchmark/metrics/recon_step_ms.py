"""A reconstruction step: the window's seconds over all its steps."""

from benchmark.yardstick.window import seconds_per_iteration

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return 1e3 * seconds_per_iteration([ctx.window_s], ctx.steps)
