"""drr.sync spans (the DRR's host reads of a device value) a batch of renders, traced."""

from benchmark.yardstick import spans

UNIT, BETTER, SOURCE = "syncs", "lower", "program_span"
LAYER = "DRR dispatch"
MOVES = "render_rays_per_s"
WORKLOADS = ["render-b32-chest133-siddon", "render-b8-chest512-trilinear"]


def read(ctx):
    return spans.syncs_per_step(ctx)
