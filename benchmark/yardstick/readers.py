"""What the per-layer metric files read from a traced run (``ctx.trace``, a
``trace.DeviceTrace``). Each returns None where the trace holds nothing to
read, and the metric is then left out of the result line."""

from __future__ import annotations

from .peaks import bound_s

COPIES = ("Memcpy", "Memset")


def launches(ctx, kernel: str = None):
    """Device kernels (of ``kernel`` alone, when named) a traced step."""
    t = ctx.trace
    if t is None or not t.ops:
        return None
    if kernel is None:
        n = sum(1 for name, _, _ in t.ops if not name.startswith(COPIES))
    else:
        n = len(t.kernel_times(kernel + "_kernel"))
    return n / t.steps


def roofline_pct(ctx, kernel: str):
    """The kernel's least possible time on the card (``peaks.bound_s`` of
    the yardstick's bytes and operations a launch) over its mean traced
    time, in percent."""
    t = ctx.trace
    if t is None or kernel not in t.costs:
        return None
    times = t.kernel_times(kernel + "_kernel")
    if not times:
        return None
    return 100.0 * bound_s(*t.costs[kernel]) / (sum(times) / len(times))


def idle_pct(ctx):
    """The traced window's share in which no operation ran on the device."""
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
