"""What the DRR dispatch's own profiler spans say of a traced window.

The program opens ``drr.pose`` (the pose geometry), ``drr.render`` (one
render: ray packing and the kernels' launch) and ``drr.sync`` (a host read
of a device value inside a render) under a running ``torch.profiler``;
``trace.DeviceTrace.host`` keeps them beside the device's operations, on the
same clock. The names are written here, not imported from the program, so
a program without the spans reads nothing here (None), and the metric is
left out of the result line.
"""

from __future__ import annotations

POSE, RENDER, SYNC = "drr.pose", "drr.render", "drr.sync"
SPANS = (POSE, RENDER, SYNC)
OUTSIDE = "outside"


def _spans(t):
    """The dispatch's spans of the trace, ``(name, start, end)``."""
    return [(name, s, e) for name, s, e, _ in t.host if name in SPANS]


def syncs_per_step(ctx):
    """``drr.sync`` spans that start inside the traced window, a step."""
    t = ctx.trace
    if t is None:
        return None
    spans = _spans(t)
    if not spans:
        return None
    return sum(1 for name, s, _ in spans if name == SYNC and t.start <= s < t.end) / t.steps


def idle_by_span(ctx):
    """The window's idle time, in percent of the window, by the dispatch span
    the host was in: each idle instant goes to the most recently opened of
    the spans open then (on any thread: the trace keeps no thread), and to
    ``"outside"`` where none is open. The parts sum to ``readers.idle_pct``."""
    t = ctx.trace
    if t is None or not t.ops:
        return None
    spans = sorted(_spans(t), key=lambda sp: sp[1])
    parts = dict.fromkeys(SPANS + (OUTSIDE,), 0.0)
    for g0, g1 in t.gaps():
        near = [sp for sp in spans if sp[1] < g1 and sp[2] > g0]
        cuts = sorted({g0, g1} | {x for _, s, e in near for x in (s, e) if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            open_ = [sp for sp in near if sp[1] <= mid < sp[2]]
            owner = max(open_, key=lambda sp: sp[1])[0] if open_ else OUTSIDE
            parts[owner] += b - a
    return {k: 100.0 * v / t.window_s for k, v in parts.items()}


def dispatch_idle_pct(ctx):
    """The part of the window's idle time that the union of ``drr.pose``,
    ``drr.render`` and ``drr.sync`` covers, in percent of the window."""
    parts = idle_by_span(ctx)
    if parts is None or not _spans(ctx.trace):
        return None
    return sum(v for k, v in parts.items() if k != OUTSIDE)
