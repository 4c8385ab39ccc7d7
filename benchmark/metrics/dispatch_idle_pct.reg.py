"""The traced window's idle share under drr.pose, drr.render or drr.sync, registration."""

from benchmark.yardstick import spans

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER = "DRR dispatch"
MOVES = "reg_step_ms"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return spans.dispatch_idle_pct(ctx)
