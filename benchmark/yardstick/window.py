"""Window arithmetic, frozen from ``diffdrr_tpu_torch/bench.py::window``:
a figure is all the work of a window over all its time, never a median of
chunks. ``benchmark/tests`` holds this copy to its source on the CPU.

A tail is Python's ``statistics.quantiles`` with the ``inclusive`` method.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def seconds_per_iteration(window_seconds: Sequence[float], iterations: int) -> float:
    """All the windows' seconds over all their iterations."""
    return sum(window_seconds) / iterations


def rate(work: float, seconds: float) -> float:
    """Work a second over the whole window."""
    return work / seconds


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of ``values``."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
