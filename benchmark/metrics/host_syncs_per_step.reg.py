"""drr.sync spans (the DRR's host reads of a device value) a registration step, traced."""

from benchmark.yardstick import spans

UNIT, BETTER, SOURCE = "syncs", "lower", "program_span"
LAYER = "DRR dispatch"
MOVES = "reg_step_ms"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return spans.syncs_per_step(ctx)
