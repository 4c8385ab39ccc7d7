"""Reduction of a ``torch.profiler`` window to what the per-layer metrics read.

Kept in memory: every device operation (kernels, copies, fills) with its
start and length, and the host's spans and operators. The device's busy
time is the union of its operations' intervals; the idle gaps are the
holes in that union inside the traced window, each named by what the host
was doing at its middle: the benchmark's own span around the call and the
innermost operator then running, ``span>operator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class DeviceTrace:
    ops: List[Tuple[str, float, float]]  # (name, start s, end s), device
    host: List[Tuple[str, float, float, int]]  # (name, start s, end s, depth)
    start: float  # the traced window, on the trace's clock (s)
    end: float
    steps: int
    costs: dict = field(default_factory=dict)  # kernel -> (bytes, flops) a launch

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def intervals(self):
        """The union of the device's operations inside the window, sorted."""
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.ops
                       if e > self.start and s < self.end)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def kernel_times(self, name: str) -> List[float]:
        """Each launch's seconds of the kernels whose name holds ``name`` as a word."""
        return [e - s for n, s, e in self.ops if _is_kernel(n, name)]

    def gaps(self):
        """The idle holes of the window, ``(start, end)``."""
        out, t = [], self.start
        for s, e in self.intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: float) -> str:
        around = [h for h in self.host if h[1] <= t <= h[2] and h[0] != WINDOW_SPAN]
        if not around:
            return "host idle"
        outer = min(around, key=lambda h: h[3])
        inner = max(around, key=lambda h: (h[3], h[1]))
        return outer[0] if inner is outer else f"{outer[0]}>{inner[0]}"

    def breakdown(self, n: int = 10) -> dict:
        totals = {}
        for name, s, e in self.ops:
            totals[name] = totals.get(name, 0.0) + (e - s)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[_short(k), v] for k, v in ops],
                "idle_gaps": [[self.host_at(0.5 * (s + e)), e - s] for s, e in gaps]}


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit]


def _is_kernel(op: str, name: str) -> bool:
    i = op.find(name)
    while i >= 0:
        before = op[i - 1] if i > 0 else " "
        after = op[i + len(name)] if i + len(name) < len(op) else " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = op.find(name, i + 1)
    return False


WINDOW_SPAN = "bench.window"
STEP_SPAN = "bench.step"


def from_profiler(prof, steps: int) -> DeviceTrace:
    """A :class:`DeviceTrace` of a finished ``torch.profiler.profile``; the
    window is the host span ``bench.window``, which ends after a device
    synchronisation. The host's spans that the profiler mirrors onto the
    device's timeline (user annotations) are no device operations."""
    ops, host, window = [], [], None
    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type.name != "CUDA"}
    depth = {}
    for e in sorted(events, key=lambda e: (e.time_range.start, -e.time_range.end)):
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type.name == "CUDA":
            if not getattr(e, "is_user_annotation", False) and e.name not in host_names:
                ops.append((e.name, start, end))
            continue
        if e.name == WINDOW_SPAN:
            window = (start, end)
        d = 0 if e.cpu_parent is None else depth.get(id(e.cpu_parent), 0) + 1
        depth[id(e)] = d
        host.append((e.name, start, end, d))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    return DeviceTrace(ops, host, window[0], window[1], steps)
