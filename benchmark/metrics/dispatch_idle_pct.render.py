"""The traced window's idle share under drr.pose, drr.render or drr.sync, renders."""

from benchmark.yardstick import spans

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER = "DRR dispatch"
MOVES = "render_rays_per_s"
WORKLOADS = ["render-b32-chest133-siddon", "render-b8-chest512-trilinear"]


def read(ctx):
    return spans.dispatch_idle_pct(ctx)
