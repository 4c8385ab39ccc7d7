"""joseph_fwdgrad's least possible time over its mean traced time, a registration step's launch."""

from benchmark.yardstick import readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "reg_step_ms"
WORKLOADS = ["reg-ms10-ncc-chest512-trilinear"]


def read(ctx):
    return readers.roofline_pct(ctx, "joseph_fwdgrad")
