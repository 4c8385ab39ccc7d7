"""Benchmark harness of the port: the JAX package's metric set on the card.

Counterpart of the root ``bench.py``. Thirteen metrics on the reference's
headline CT (the 512x512x133 example chest CT, ``sdd=1020``, the pose
``rot=[0.01, pi/2 + 0.02, -0.01]``, ``trans=[0, 850, 0]``, Euler ZXY,
march axis 2), each under the JAX harness's name, shape and render options:

  * Siddon, Joseph and trilinear (``n_points=500``, capped at one sample a
    plane, and ``allow_oversample=True``) renders at 200x200, and the pose
    backwards of the first three; Joseph with ``p_subsample=0.1``;
  * Siddon at 1000x1000, and Siddon and Joseph on a 512^3 isotropic cube;
  * registration steps per second (multiscale NCC and Adam, 200x200);
  * ``scaling``: a ray-sharded render on N ranks against one
    (``bench_scaling.py``), skipped on one card.

Each metric is timed as the JAX harness times it: K renders whose poses
depend on the previous output (``render_loop``, ``fwdbwd_loop``,
``reg_loop``), the per-iteration time from the difference between K + 1
and 1 iterations (``per_iter``), over fresh inputs, on the host clock
around work that ends in a device sync (``float`` of the result). The
steps are host-bound (every render reads its axis choice back to the host),
so the host clock is what a user pays. ``per_iter``'s median of a few short
differences is the JAX harness's figure and its fields (``ms``,
``rays_per_s``, ``ms_per_iter``); it leaves out whatever stalls fall outside
the median's samples, so beside it each metric also has a window time
(``window``): all the iterations of whole windows of about a second over all
their time, on the host clock and by CUDA events, with each window's figure
to show the spread between them. Before a metric is timed its first
output is held against the plain version of the same render on the same
device (``plain_reference``: the same DRR and autograd with every kernel
replaced by its plain PyTorch version): values within 1e-4 * max, pose
gradients within 1e-3 * max. The timed iterations' launches are counted
and must be the metric's own, exactly (``Metric.launches``, per iteration;
none on the CPU, which runs the plain versions). nvcc's build and each
DRR's first calls are excluded from every time. The windows' launches are
held to the same counts.

``vs_baseline`` is taken only from the reference's RTX 2080 Ti figures
(``BASELINE.md``): 24.6 ms for Siddon at 200x200, 341 ms at 1000x1000, and
7.63 ms for trilinear at ``n_points=500``.

    python -m diffdrr_tpu_torch.bench            # on the CUDA card
    python -m diffdrr_tpu_torch.bench --smoke    # tiny shapes on the CPU

The second-to-last line of its output is the detail record (``extra``: the
13 metrics; the device, by name, count and ``nvidia-smi``'s power limit),
also written to ``--detail`` (default ``bench_torch_detail.json``); the last
line is the compact headline, Siddon rays/s at 200x200. Without a card and
without ``--smoke`` it exits non-zero and measures nothing. A metric that
fails (an error, a gate, a launch count, its watchdog) is recorded under
``errors`` and the exit code is non-zero. ``run()`` is the in-process entry
(``chip_smoke.py`` phase 15).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from ._device import resolve_device
from .data import load_example_ct
from .drr import DRR
from .ops import kernels
from .ops.kernels import brick, no_other_launches

__all__ = ["METRICS", "Metric", "Shapes", "FULL", "SMOKE", "render_loop", "fwdbwd_loop",
           "reg_loop", "per_iter", "window", "plain_reference", "make_drr", "first_output", "run",
           "main"]

HEADLINE = "siddon_render_rays_per_s_200x200_512ct"
# The reference's RTX 2080 Ti times (BASELINE.md:13,18; bench.py:292,313).
SIDDON_200_S = 24.6e-3
SIDDON_1000_S = 341e-3
TRILINEAR_N500_S = 7.63e-3
ROT0 = [[0.01, math.pi / 2 + 0.02, -0.01]]
TRANS = [[0.0, 850.0, 0.0]]
KW = dict(parameterization="euler_angles", convention="ZXY")
SDD = 1020.0
CUBE_SPACING = (0.703125,) * 3
# No metric starts past this (the JAX harness's global budget).
DEADLINE_S = 45 * 60


@dataclass(frozen=True)
class Shapes:
    """The sizes of one run: the main CT, the two detectors (pixels, mm a
    pixel), the cube, ``per_iter``'s (iterations, repetitions) for the
    200x200 metrics and registration and for the 1000x1000 and cube
    metrics, and ``window``'s (seconds a window, windows)."""

    volume: tuple
    h200: int
    delx200: float
    h1000: int
    delx1000: float
    cube: tuple
    timing: tuple = (6, 3)
    timing_long: tuple = (4, 3)
    window: tuple = (1.0, 4)


FULL = Shapes((512, 512, 133), 200, 2.0, 1000, 0.4, (512,) * 3)
# bench.py:131-134's smoke shapes.
SMOKE = Shapes((96, 96, 48), 48, 800.0 / 48, 96, 400.0 / 96, (64,) * 3, (2, 1), (2, 1),
               (0.0, 1))
# No window runs more iterations than this.
WINDOW_MAX_ITERS = 2000


@dataclass(frozen=True)
class Metric:
    """One render metric: the JAX harness's name, renderer and options, and
    the kernels each timed iteration launches on the card."""

    name: str
    renderer: str
    launches: Dict[str, int]
    posebwd: bool = False
    size: int = 200
    cube: bool = False
    kw: dict = field(default_factory=dict)
    p_subsample: Optional[float] = None
    baseline_s: Optional[float] = None
    note: Optional[str] = None


_CUBE_NOTE = "512^3 isotropic cube (0.703125 mm), the JAX harness's streaming regime"
METRICS = (
    Metric("siddon_fwd_200", "siddon", {"siddon_fwd": 1}, baseline_s=SIDDON_200_S),
    Metric("siddon_fwd_posebwd_200", "siddon", {"siddon_fwdgrad": 1}, posebwd=True),
    Metric("joseph_fwd_200", "joseph", {"joseph_fwd": 1}),
    Metric("joseph_fwd_posebwd_200", "joseph", {"joseph_fwdgrad": 1}, posebwd=True),
    Metric("joseph_sparse_p10_200", "joseph", {"joseph_fwd": 1}, p_subsample=0.1,
           note="p_subsample=0.1: rays/s over the sampled rays"),
    Metric("trilinear_kernel_fwd_200_n500", "trilinear", {"joseph_fwd": 1},
           kw=dict(n_points=500), baseline_s=TRILINEAR_N500_S,
           note="n_points=500 capped at one sample a plane"),
    Metric("trilinear_fwd_posebwd_200_n500", "trilinear", {"joseph_fwdgrad": 1}, posebwd=True,
           kw=dict(n_points=500)),
    Metric("trilinear_fwd_200_n500_literal", "trilinear", {"joseph_fwd": 1},
           kw=dict(n_points=500, allow_oversample=True), baseline_s=TRILINEAR_N500_S,
           note="all 500 samples a ray (allow_oversample, the reference's semantics)"),
    Metric("siddon_fwd_1000", "siddon", {"siddon_fwd": 1}, size=1000, baseline_s=SIDDON_1000_S),
    Metric("siddon_fwd_200_512cube", "siddon", {"siddon_fwd": 1}, cube=True, note=_CUBE_NOTE),
    Metric("joseph_fwd_200_512cube", "joseph", {"joseph_fwd": 1}, cube=True, note=_CUBE_NOTE),
)
# A registration step on the Siddon DRR: the fused pose kernel, no forward.
REG_LAUNCHES = {"siddon_fwdgrad": 1}
REG_NAME = "registration_iters_per_s_200"


# -----------------------------------------------------------------------------
# The timed loops
# -----------------------------------------------------------------------------


def render_loop(drr, rot0: torch.Tensor, trans: torch.Tensor, iters: int, **kw) -> torch.Tensor:
    """``iters`` renders, each pose moved by the previous image's mean (no
    two renders alike, each after the last); the summed means, 0-d."""
    rot, acc = rot0, torch.zeros((), device=rot0.device)
    with torch.no_grad():
        for _ in range(iters):
            m = drr(rot, trans, **KW, **kw).mean()
            rot = rot + 1e-6 * m
            acc = acc + m
    return acc


def fwdbwd_loop(drr, rot0: torch.Tensor, trans: torch.Tensor, iters: int, **kw) -> torch.Tensor:
    """``iters`` values and rotation gradients of the image mean, both
    consumed by the next pose; the summed values, 0-d."""
    rot, acc = rot0, torch.zeros((), device=rot0.device)
    for _ in range(iters):
        r = rot.detach().requires_grad_(True)
        val = drr(r, trans, **KW, **kw).mean()
        (g,) = torch.autograd.grad(val, r)
        rot = r.detach() + 1e-6 * val.detach() + 1e-9 * g
        acc = acc + val.detach()
    return acc


def reg_loop(init_fn, step_fn, rot_start: torch.Tensor, trans_start: torch.Tensor,
             iters: int) -> torch.Tensor:
    """``iters`` registration steps from a fresh optimizer; the summed
    scores plus the summed rotation, 0-d."""
    params, opt = init_fn(rot_start, trans_start)
    scores = []
    for _ in range(iters):
        params, opt, score = step_fn(params, opt)
        scores.append(score)
    return torch.stack(scores).sum() + params["rotation"].detach().sum()


def per_iter(run: Callable, rot0: torch.Tensor, iters: int = 6, reps: int = 3) -> dict:
    """Seconds an iteration of ``run(rot, k)`` from the K-vs-1 difference.

    ``run(rot0, 1)`` and ``run(rot0, 1 + iters)`` warm up first (a DRR's
    first calls, the bricked copy). Then each of ``reps`` samples times one
    call of 1 and one of ``1 + iters`` iterations on fresh poses, on the
    host clock around ``float()`` of the result (a device sync), and takes
    the difference over ``iters``. Returns the median sample (``s``), the
    sample count, the lowest and highest, the iterations timed and the
    kernels they launched (counters zeroed after the warm-up). A median
    that is not positive is taken again on fresh poses, twice at most, then
    raises: no invalid number is returned.
    """
    float(run(rot0, 1))
    float(run(rot0, 1 + iters))
    kernels.reset_launch_counts()
    n_iter = 0
    for attempt in range(3):
        base = rot0 + 0.01 * attempt
        samples = []
        for i in range(reps):
            t0 = time.perf_counter()
            float(run(base + 1e-4 * (i + 1), 1))
            t1 = time.perf_counter()
            float(run(base + 1e-4 * (i + 11), 1 + iters))
            t2 = time.perf_counter()
            samples.append(((t2 - t1) - (t1 - t0)) / iters)
            n_iter += 2 + iters
        med = statistics.median(samples)
        if med > 0:
            return {"s": med, "n": len(samples), "min_s": min(samples), "max_s": max(samples),
                    "iterations": n_iter, "launches": kernels.launch_counts()}
    raise RuntimeError(f"unmeasurable: K-vs-1 difference {med * 1e3:.4f} ms an iteration after "
                       f"3 attempts on fresh poses")


def window(run: Callable, rot0: torch.Tensor, iters: int, windows: int = 4) -> dict:
    """Seconds an iteration over whole windows: ``windows`` calls of
    ``run(rot, iters)`` on fresh poses, each from a synced start to
    ``float()`` of its result (every stall inside counted), on the host
    clock and, on a card, by CUDA events around the same work. Returns the
    totals over all the iterations (``s``, ``device_s``; None on the CPU),
    each window's host seconds an iteration, the iterations and the kernels
    they launched. Call it warm (after ``per_iter``)."""
    cuda = rot0.device.type == "cuda"
    kernels.reset_launch_counts()
    host, device = [], []
    for w in range(windows):
        if cuda:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = run(rot0 + 1e-4 * (w + 21), iters)
        if cuda:
            end.record()
        float(out)
        host.append(time.perf_counter() - t0)
        if cuda:
            device.append(start.elapsed_time(end) * 1e-3)
    n = iters * windows
    return {"s": sum(host) / n, "device_s": sum(device) / n if cuda else None,
            "windows_s": [t / iters for t in host], "iterations": n,
            "launches": kernels.launch_counts()}


def launches_per_iter(timing: dict, want: Dict[str, int], name: str) -> Dict[str, int]:
    """The timed iterations' launches, per iteration; raises unless they are
    ``want`` exactly and none of any other kernel."""
    n = timing["iterations"]
    no_other_launches(f"{name}, {n} timed iterations", timing["launches"],
                      {k: c * n for k, c in want.items()})
    return dict(want)


def timed(run: Callable, rot0: torch.Tensor, shapes: "Shapes", long: bool,
          want: Dict[str, int], name: str) -> dict:
    """``per_iter`` and then ``window`` of ``run``, both held to ``want``
    launches an iteration; the entry's timing fields, the seconds an
    iteration (``per_iter``'s) first."""
    iters, reps = shapes.timing_long if long else shapes.timing
    timing = per_iter(run, rot0, iters, reps)
    launches = launches_per_iter(timing, want, name)
    seconds, windows = shapes.window
    k = max(iters, min(WINDOW_MAX_ITERS, math.ceil(seconds / timing["s"])))
    win = window(run, rot0, k, windows)
    launches_per_iter(win, want, f"{name} window")
    each = [t * 1e3 for t in win["windows_s"]]
    return {"s": timing["s"], "ms_min": timing["min_s"] * 1e3, "ms_max": timing["max_s"] * 1e3,
            "n": timing["n"], "launches_per_iter": launches,
            "window": {"ms": win["s"] * 1e3,
                       "device_ms": None if win["device_s"] is None else win["device_s"] * 1e3,
                       "iterations": win["iterations"], "ms_each": each,
                       "spread": (max(each) - min(each)) / (sum(each) / len(each))}}


# -----------------------------------------------------------------------------
# The gates: each first output against the plain version of the same render
# -----------------------------------------------------------------------------


@contextmanager
def plain_reference():
    """Inside the block every kernel wrapper's name in ``ops.kernels.siddon``
    and ``ops.kernels.joseph`` is its plain version, so a render runs the
    same DRR, rays and autograd with the kernels' arithmetic in PyTorch, on
    whatever device the tensors are (the gate's reference; no launch is
    counted). Not thread-safe: it rebinds module attributes."""
    from .ops.kernels import joseph, siddon

    saved = [(mod, fn) for mod in (siddon, joseph) for fn in mod.KERNELS]
    try:
        for mod, fn in saved:
            setattr(mod, fn.__name__, getattr(mod, fn.__name__ + "_plain"))
        yield
    finally:
        for mod, fn in saved:
            setattr(mod, fn.__name__, fn)


def make_drr(metric: Metric, subject, shapes: Shapes, device):
    h, delx = ((shapes.h1000, shapes.delx1000) if metric.size == 1000
               else (shapes.h200, shapes.delx200))
    return DRR(subject, sdd=SDD, height=h, delx=delx, renderer=metric.renderer,
               p_subsample=metric.p_subsample, device=device)


def first_output(drr, metric: Metric, rot: torch.Tensor, trans: torch.Tensor):
    """The metric's render at the pose (``(B, 1, H, W)``), and for a pose
    backward the gradient of its mean with respect to the rotation (else
    None)."""
    if not metric.posebwd:
        with torch.no_grad():
            return drr(rot, trans, axis=2, **KW, **metric.kw), None
    r = rot.detach().clone().requires_grad_(True)
    img = drr(r, trans, axis=2, **KW, **metric.kw)
    (g,) = torch.autograd.grad(img.mean(), r)
    return img.detach(), g


def _err(got: torch.Tensor, ref: torch.Tensor, rel: float, what: str) -> float:
    """Max abs difference; raises above ``rel`` * max|ref| or where not finite."""
    err = float(torch.max(torch.abs(got - ref)))
    tol = rel * float(torch.max(torch.abs(ref)))
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError(f"{what}: max abs err {err:.3e} > {tol:.3e} (plain version)")
    return err


def _against_plain(fn, want: Dict[str, int], name: str):
    """``fn()`` on the kernels, then inside ``plain_reference``; raises
    unless the first launched each kernel of ``want`` that many times (the
    bricked copy aside) and the second launched nothing."""
    before = kernels.launch_counts()
    got = fn()
    mid = kernels.launch_counts()
    with plain_reference():
        ref = fn()
    if kernels.launch_counts() != mid:
        raise AssertionError(f"{name}: the plain reference launched a kernel")
    ran = {k: mid[k] - before[k] for k in want}
    if ran != want:
        raise AssertionError(f"{name}: the first output launched {ran}, want {want}")
    return got, ref


def check_metric(drr, metric: Metric, rot, trans, want: Dict[str, int]) -> dict:
    """Hold the metric's first output against ``plain_reference``; its
    kernels are ``want`` (none on the CPU)."""
    (img, g), (ref, ref_g) = _against_plain(lambda: first_output(drr, metric, rot, trans),
                                            want, metric.name)
    out = {"max_abs_err": _err(img, ref, 1e-4, f"{metric.name} image")}
    if g is not None:
        out["grad_max_abs_err"] = _err(g, ref_g, 1e-3, f"{metric.name} pose gradient")
    return out


def check_registration(step_fn, params, want: Dict[str, int]) -> dict:
    """The first step's loss and pose gradient against ``plain_reference``."""

    def loss_and_grads():
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss = step_fn.loss(p)
        return loss.detach(), torch.autograd.grad(loss, [p["rotation"], p["translation"]])

    (loss, grads), (ref_loss, ref_grads) = _against_plain(loss_and_grads, want, REG_NAME)
    return {"loss_abs_err": _err(loss, ref_loss, 1e-4, "registration loss"),
            "grad_max_abs_err": max(_err(a, b, 1e-3, "registration pose gradient")
                                    for a, b in zip(grads, ref_grads))}


# -----------------------------------------------------------------------------
# The run
# -----------------------------------------------------------------------------


class _MetricTimeout(Exception):
    pass


def _with_timeout(fn, seconds: int, errors: dict, name: str):
    """``fn()``, or None with the failure recorded in ``errors``; under a
    SIGALRM watchdog when called from the main thread."""
    watchdog = threading.current_thread() is threading.main_thread()

    def _raise(signum, frame):
        raise _MetricTimeout(name)

    if watchdog:
        prev = signal.signal(signal.SIGALRM, _raise)
        signal.alarm(seconds)
    try:
        try:
            return fn()
        finally:
            if watchdog:
                signal.alarm(0)
    except _MetricTimeout:
        errors[name] = f"timeout after {seconds} s"
    except Exception as e:  # a failed metric is recorded, and the run goes on
        errors[name] = f"{type(e).__name__}: {e}"
    finally:
        if watchdog:
            signal.signal(signal.SIGALRM, prev)
    return None


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_record(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"name": "cpu", "count": 1}
    try:
        smi = card_line()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"not read: {type(e).__name__}: {e}"
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": smi}


def _entry(timing: dict, n_rays: int, metric: Metric, gate: dict) -> dict:
    t = timing.pop("s")
    out = {"ms": t * 1e3, "rays_per_s": n_rays / t}
    if metric.baseline_s is not None:
        out["vs_baseline"] = metric.baseline_s / t
    if metric.note is not None:
        out["note"] = metric.note
    timing["window"]["rays_per_s"] = n_rays / (timing["window"]["ms"] * 1e-3)
    return dict(out, **timing, **gate)


def _headline(extra: dict, errors: dict, smoke: bool) -> dict:
    head = extra.get("siddon_fwd_200", {})
    rays = head.get("rays_per_s", 0.0)
    out = {"metric": HEADLINE, "value": rays, "unit": "rays/s",
           "vs_baseline": rays * SIDDON_200_S / 40_000}
    eff = extra.get("scaling", {}).get("scaling_efficiency")
    if eff is not None:
        out["scaling_efficiency"] = eff
    if smoke:
        out["smoke"] = True
    if errors:
        out["errors"] = errors
    return out


def run(smoke: bool = False, device=None, *, extra: Optional[dict] = None,
        errors: Optional[dict] = None):
    """Measure every metric; returns ``(detail, headline)``.

    ``device`` defaults to the CUDA card (``"cpu"`` with ``smoke``); with no
    card it raises. ``extra`` and ``errors`` (filled as the run goes) may be
    the caller's, to read while it runs. A failed metric is recorded in
    ``errors`` and the run goes on; no metric starts after ``DEADLINE_S``.
    """
    shapes = SMOKE if smoke else FULL
    dev = resolve_device("cpu" if smoke and device is None else device)
    extra = {} if extra is None else extra
    errors = {} if errors is None else errors
    detail = {"device": device_record(dev)}
    deadline = time.monotonic() + DEADLINE_S
    if dev.type == "cuda":
        from .ops.kernels import build

        t0 = time.perf_counter()
        build.build_all()
        detail["build_s"] = time.perf_counter() - t0

    def measure(name, fn, seconds=600):
        if time.monotonic() > deadline:
            errors[name] = "skipped: the run's deadline was reached"
            return None
        return _with_timeout(fn, seconds, errors, name)

    rot0 = torch.tensor(ROT0, dtype=torch.float32, device=dev)
    trans = torch.tensor(TRANS, dtype=torch.float32, device=dev)
    subjects, drrs = {}, {}

    def subject(cube):
        key = "cube" if cube else "main"
        if key not in subjects:
            subjects[key] = (load_example_ct(shape=shapes.cube, spacing=CUBE_SPACING, device=dev)
                             if cube else load_example_ct(shape=shapes.volume, device=dev))
        return subjects[key]

    def drr_of(m):
        key = (m.cube, m.renderer, m.size, m.p_subsample)
        if key not in drrs:
            drrs[key] = make_drr(m, subject(m.cube), shapes, dev)
        return drrs[key]

    def kernels_of(launches):  # the CPU runs the plain versions: no launch
        return launches if dev.type == "cuda" else {}

    def render_metric(m):
        drr = drr_of(m)
        gate = check_metric(drr, m, rot0, trans, kernels_of(m.launches))
        loop = fwdbwd_loop if m.posebwd else render_loop
        timing = timed(lambda r, k: loop(drr, r, trans, k, axis=2, **m.kw), rot0, shapes,
                       m.size == 1000 or m.cube, kernels_of(m.launches), m.name)
        n_rays = (len(drr.detector.subsamples[-1]) if m.p_subsample is not None
                  else drr.detector.height * drr.detector.width)
        return _entry(timing, n_rays, m, gate)

    for i, m in enumerate(METRICS):
        res = measure(m.name, lambda: render_metric(m))
        if res is not None:
            extra[m.name] = res
        if m.cube and not any(n.cube for n in METRICS[i + 1:]):
            # The cube and its bricked copy (537 MB each) go before the rest.
            for key in [key for key in drrs if key[0]]:
                del drrs[key]
            subjects.pop("cube", None)
            brick.clear_cache()

    def reg_metric():
        from .registration import make_registration_step

        drr = drr_of(METRICS[0])
        with torch.no_grad():
            target = drr(rot0, trans, axis=2, **KW)
        init_fn, step_fn = make_registration_step(drr, target, "euler_angles", "ZXY",
                                                  lr_rotation=1e-3, lr_translation=1e-1, axis=2)
        trans_start = trans + 5.0
        gate = check_registration(step_fn, init_fn(rot0 + 0.03, trans_start)[0],
                                  kernels_of(REG_LAUNCHES))
        timing = timed(lambda r, k: reg_loop(init_fn, step_fn, r, trans_start, k), rot0 + 0.03,
                       shapes, False, kernels_of(REG_LAUNCHES), REG_NAME)
        t = timing.pop("s")
        timing["window"]["iters_per_s"] = 1e3 / timing["window"]["ms"]
        return {"ms_per_iter": t * 1e3, "iters_per_s": 1.0 / t, **timing, **gate}

    res = measure(REG_NAME, reg_metric)
    if res is not None:
        extra[REG_NAME] = res
    drrs.clear()
    subjects.clear()
    brick.clear_cache()

    def scaling_metric():
        from . import bench_scaling

        # On the cards, its own defaults: the harness's CT and detectors.
        return bench_scaling.scaling(dev.type, **(bench_scaling.SMOKE if smoke else {}))

    res = measure("scaling", scaling_metric)
    if res is not None:
        extra["scaling"] = res
    headline = _headline(extra, errors, smoke)
    detail = dict(headline, **detail, extra=extra)
    return detail, headline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The port's benchmark harness: the JAX bench.py's 13 metrics on the card.")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes on the CPU (the plain versions); numbers meaningless")
    parser.add_argument("--detail", default="bench_torch_detail.json",
                        help="where the detail record is written (default: %(default)s)")
    args = parser.parse_args(argv)
    if not args.smoke and not torch.cuda.is_available():
        print("bench: no CUDA device is available; the harness measures the card "
              "(--smoke runs its tiny shapes on the CPU)", file=sys.stderr)
        return 2
    extra, errors = {}, {}
    done = threading.Event()

    def reaper():
        # SIGALRM cannot interrupt a call stuck inside native code: past the
        # last metric's own budget, print what was measured and exit.
        if done.wait(timeout=55 * 60):
            return
        errors["__global__"] = "hard deadline: the bench was stopped mid-metric"
        print(json.dumps(_headline(extra, errors, args.smoke)), flush=True)
        os._exit(2)

    threading.Thread(target=reaper, daemon=True).start()
    detail, headline = run(args.smoke, extra=extra, errors=errors)
    done.set()
    try:
        with open(args.detail, "w") as f:
            json.dump(detail, f, indent=1)
    except OSError as e:
        errors["detail_file"] = f"{type(e).__name__}: {e}"
        headline["errors"] = detail["errors"] = errors
    print(json.dumps(detail), flush=True)
    print(json.dumps(headline), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
