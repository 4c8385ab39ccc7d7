"""The traced window's idle share under drr.pose, drr.render or drr.sync, reconstruction."""

from benchmark.yardstick import spans

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER = "DRR dispatch"
MOVES = "recon_step_ms"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return spans.dispatch_idle_pct(ctx)
