"""Command-line experiments of the port (``python -m diffdrr_tpu_torch.experiments.<name>``)."""

import time

import torch

__all__ = ["StepClock"]


class StepClock:
    """Per-step times of a loop: CUDA events on the card (read once, by
    ``ms``), the host clock on the CPU. ``begin = clock.start()`` before a
    step, ``clock.stop(begin)`` after it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if not self.cuda:
            return time.perf_counter()
        begin = torch.cuda.Event(enable_timing=True)
        begin.record()
        return begin

    def stop(self, begin) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = time.perf_counter()
        self.marks.append((begin, end))

    def ms(self) -> list:
        """Each step's milliseconds (on the card this waits for the device)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [b.elapsed_time(e) for b, e in self.marks]
        return [(e - b) * 1e3 for b, e in self.marks]
