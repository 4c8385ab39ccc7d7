"""siddon_bwd_vol's least possible time over its mean traced time, a reconstruction step's launch."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "recon_step_ms"
WORKLOADS = ["recon32-chest133-siddon"]


def read(ctx):
    return readers.roofline_pct(ctx, "siddon_bwd_vol")
