"""The 95th percentile of every registration step's time in the window, each
from one read of the scores to the next."""

from benchmark.yardstick.window import percentile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return 1e3 * percentile(ctx.step_s, 95)
