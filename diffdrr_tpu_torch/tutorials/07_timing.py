"""Timing DRRs honestly: how to measure a render on the card.

The reference's ``timing.ipynb`` analog, for CUDA: PyTorch returns before
the device finishes, so a host clock around a render measures the enqueue,
not the work. The rule:

1. warm up first (the first call builds the kernels with nvcc and makes the
   density's bricked copy);
2. time many renders back to back between two CUDA events, synchronise,
   and divide the elapsed time by the count;
3. name the card and its power limit beside every number, and compare a
   render with its least possible time (``profiling.render_cost``: the
   bytes it must move and the operations it must do, over the card's peak
   rates).

``profiling.trace`` then records which kernels ran and for how long. With
``--cpu`` the same code times the kernels' plain versions with the host
clock; those numbers describe the CPU, not the card.

Run:  python diffdrr_tpu_torch/tutorials/07_timing.py [--cpu]
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from diffdrr_tpu_torch import DRR, convert, load_example_ct
from diffdrr_tpu_torch.profiling import render_cost, trace

DEVICE = "cpu" if "--cpu" in sys.argv else None
# The H100 SXM's published peaks at its 700 W limit: HBM bytes/s and float32
# (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

subject = load_example_ct(shape=(64, 64, 32), device=DEVICE)
# A 48x48 detector whose field of view (1.2 mm pixels, ~48 mm at the
# isocentre) holds the 45 x 45 x 80 mm volume: every ray does work.
H, DELX = 48, 1.2
probe = DRR(subject, sdd=1020.0, height=H, delx=DELX, device=DEVICE)
dev = probe.device
if dev.type == "cuda":
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
else:
    card = "the CPU (host clock; plain versions of the kernels)"
print(f"timing on {card}")

trans = torch.tensor([[0.0, 850.0, 0.0]], device=dev)
rot0 = torch.tensor([[0.01, np.pi / 2, -0.01]], device=dev)
KW = dict(parameterization="euler_angles", convention="ZXY")


def per_render_ms(drr, iters=20, **kw):
    """Mean ms of ``iters`` renders back to back, after a warm-up."""
    with torch.no_grad():
        drr(rot0, trans, **kw, **KW)  # builds the kernels and the bricked copy
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                drr(rot0, trans, **kw, **KW)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            drr(rot0, trans, **kw, **KW)
        return (time.perf_counter() - t0) / iters * 1e3


pose = convert(rot0, trans, **KW)
rows = []
for name, kw in [("siddon", {}), ("joseph", {}), ("trilinear", {"n_points": 100})]:
    drr = DRR(subject, sdd=1020.0, height=H, delx=DELX, renderer=name, device=DEVICE, **kw)
    ms = per_render_ms(drr)
    cost = render_cost(drr, pose=pose)
    bound_ms = max(cost.bytes / HBM_BYTES_PER_S, cost.flops / F32_FLOPS) * 1e3
    rows.append((name, ms))
    print(f"{name:10s} {ms:8.3f} ms/render  {H * H / (ms * 1e-3) / 1e6:7.2f} M rays/s  "
          f"(H100 bound {bound_ms:.6f} ms: {cost})")
assert all(ms > 0 for _, ms in rows)

# What a host clock without a synchronise measures: the enqueue. A render
# this small is paced by the host on the card too (each render's launches
# cost more host time than its kernels take), so here the two agree; once
# the device's work outgrows the host's, the host clock reads too little
# and only the events (or a synchronise) give the render's time.
drr = DRR(subject, sdd=1020.0, height=H, delx=DELX, renderer="joseph", device=DEVICE)
with torch.no_grad():
    drr(rot0, trans, **KW)
    t0 = time.perf_counter()
    for _ in range(20):
        drr(rot0, trans, **KW)
    naive_ms = (time.perf_counter() - t0) / 20 * 1e3
print(f"host clock without a synchronise: {naive_ms:.3f} ms/render (the enqueue on a card)")
if dev.type == "cuda":
    torch.cuda.synchronize()

# The profiler: which kernels ran, and their device time.
with tempfile.TemporaryDirectory() as td:
    with trace(td) as prof, torch.no_grad():
        for _ in range(5):
            drr(rot0, trans, **KW)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    files = list(Path(td).glob("*.json"))
assert files, "the profiler wrote no trace"
kernels = sorted(n for n in names if "_kernel" in n)
print(f"profiled 5 renders: {len(names)} operators; CUDA kernels {kernels or 'none (CPU)'}")
if dev.type == "cuda":
    assert any("joseph_fwd" in n for n in kernels), kernels

print("tutorial 07: all checks passed")
