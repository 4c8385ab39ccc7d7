"""joseph_fwd's least possible time over its mean traced time, a batched render."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "render_rays_per_s"
WORKLOADS = ["render-b8-chest512-trilinear"]


def read(ctx):
    return readers.roofline_pct(ctx, "joseph_fwd")
