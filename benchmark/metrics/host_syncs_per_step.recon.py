"""drr.sync spans (the DRR's host reads of a device value) a reconstruction step, traced."""

from benchmark.yardstick import spans

UNIT, BETTER, SOURCE = "syncs", "lower", "program_span"
LAYER = "DRR dispatch"
MOVES = "recon_step_ms"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return spans.syncs_per_step(ctx)
