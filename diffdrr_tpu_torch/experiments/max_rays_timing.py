#!/usr/bin/env python3
"""Time joseph_fwd_max and siddon_bwd_rays of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/max_rays_timing.py [--root DIR] [--no-probes]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrappers ``joseph_fwd_max`` and
``siddon_bwd_rays``, which every commit of the port has; the probes need a
checkout whose ``csrc/siddon.cuh`` has the two-pass backward's lanes
(``kBwdLanes``) and are skipped in one without it.

Cases, on the 512x512x133 example CT, a 200x200 detector (sdd 1020 mm, 2 mm
pixels): the main pose (``chip_smoke.py``'s phases 4b and 7c: march axis 2,
133 planes) and the lateral pose ``rot = [pi/2 + 0.02, 0.01, -0.01]``,
``trans = [0, 850, 0]`` (axis 0, 512 planes); ``joseph_fwd_max`` at the
trilinear renderer's stride (n_points 500: h = 1 and 1.024),
``siddon_bwd_rays`` on the slab march with a random cotangent, in sum mode
and in MIP mode (the argmax of ``siddon_fwd_max`` at the same rays). For
each, median CUDA-event times (``scatter_timing.events_ms``):

  * ``kernel``: one wrapper call, as ``chip_smoke.py`` times it (the device
    time from the start event on, so the host's enqueue counts when it is
    later than the kernel), with the density's bricked copy already made
    (as a render's two-pass backward, or a render of a CT rendered before,
    finds it);
  * ``burst``: the same over BURST calls back to back, per call (median of
    REPS bursts);
  * ``with_copy`` and ``burst_with_copy``: the same with the copy made anew
    in each call, as a MIP render of a new density pays. A checkout whose
    kernel reads no copy makes none: there they equal ``kernel`` and
    ``burst``.

Probes (built from ``max_rays_probes.cu`` next to this file, once for each
march axis, all nvcc processes at once; C entry points called directly, so
no launch counter moves), each named by its G lanes a ray and U steps or
slabs in flight a lane. ``joseph_fwd_max``: the parent kernel (one thread
per ray on the strided density, U = 1); one thread per ray strided at U =
2, 4 and bricked at U = 1, 2, 4; the lanes bricked and strided at G = 2, 4,
8, 16, 32 (U = 1) and at each layout with the package's G and U = 2, 4; the
march without loads at the package's G and U. ``siddon_bwd_rays`` sum
mode: the parent (one thread per ray, strided) and one thread per ray
bricked; the lanes as for ``joseph_fwd_max``; the march without loads
likewise; MIP mode: one thread per ray strided (the parent's kernel, which
the package keeps) and bricked. Each variant but the march without loads
is held against the package's kernel (``equal``: the same bits, and for
``joseph_fwd_max`` the same argmax).

Prints one line per case and, last, one JSON object with every number and
the card (``nvidia-smi`` name and power limit). Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
MAIN_ROT = [[0.01, math.pi / 2 + 0.02, -0.01]]
LATERAL_ROT = [[math.pi / 2 + 0.02, 0.01, -0.01]]
TRANS = [[0.0, 850.0, 0.0]]
KW = dict(parameterization="euler_angles", convention="ZXY")
LANES = (2, 4, 8, 16, 32)
UNROLLS = (1, 2, 4)


def load_probes(axes):
    """max_rays_probes.cu built once for each march axis in ``axes``; the
    loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "max_rays_probes.cu", [[f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    head = [i32] * 4 + [v, i64, v, i64, i64, i64, v] + [i32] * 7
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_fwd_max.argtypes = head + [f32, i32, i32, v, v, v]
        lib.probe_bwd_rays.argtypes = head + [v, v, v, v]
        lib.probe_fwd_max.restype = lib.probe_bwd_rays.restype = i32
        libs[axis] = lib
    return libs


def _bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def _const(header, name):
    """An int constant of a header of the package timed (``constexpr int``)."""
    import re

    from diffdrr_tpu_torch.ops.kernels import build

    text = (build.CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _prober(lib_fn, head, tail, check, events_ms):
    """(timed, res, equal): ``timed(name, kind, layout, G, U, check=True)``
    times ``lib_fn(kind, layout, G, U, *head, *tail, stream)`` into ``res``
    by name and, with ``check``, runs it once more and puts ``check()``
    (whether it gave the kernel's output) into ``equal``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    res, equal = {}, {}

    def run(kind, layout, n_lanes, unroll):
        rc = lib_fn(kind, layout, n_lanes, unroll, *head, *tail, stream)
        if rc != 0:
            raise RuntimeError(f"probe {lib_fn.__name__} kind {kind} layout {layout} "
                               f"G {n_lanes} U {unroll}: {rc}")

    def timed(name, *variant, check_it=True):
        res[name] = events_ms(lambda: run(*variant))
        if check_it:
            equal[name] = check(lambda: run(*variant))

    return timed, res, equal


def _head(rows, density, axis):
    """The probes' leading arguments after (kind, layout, G, U): the rows,
    the strided density and the bricked copy with their C arguments."""
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import strides_extents

    bv = brick.brick_density(density)
    return [rows.data_ptr(), rows.shape[1], density.data_ptr(),
            *strides_extents(density, axis)[:3], bv.data.data_ptr(), *bv.args(axis)], bv


def _lane_probes(timed, G, U):
    """The lanes probes common to both kernels (kind 5 lanes, 1 no loads)."""
    for layout, name in ((1, "bricked"), (0, "strided")):
        for g in LANES:
            timed(f"lanes_{name}_g{g}_u1", 5, layout, g, 1)
        for u in UNROLLS[1:]:
            timed(f"lanes_{name}_g{G}_u{u}", 5, layout, G, u)
    timed(f"march_only_g{G}_u{U}", 1, 1, G, U, check_it=False)


def probe_fwd_max(lib, rows, density, axis, march, ref, events_ms):
    """Time the joseph_fwd_max probes (see the module docstring); ms by name
    and, by name, whether each gives the kernel's value bits and argmax
    ``ref``."""
    import torch

    rows = rows.contiguous()
    n = rows.shape[1]
    val = torch.empty(n, dtype=torch.float32, device=rows.device)
    arg = torch.empty(n, dtype=torch.int32, device=rows.device)
    head, _bv = _head(rows, density, axis)
    G, U = _const("joseph.cuh", "kMaxLanes"), _const("joseph.cuh", "kMaxSteps")

    def check(run):
        val.fill_(float("nan"))
        arg.fill_(-2)
        run()
        return bool(torch.equal(_bits(val), _bits(ref[0])) and torch.equal(arg, ref[1]))

    timed, res, equal = _prober(lib.probe_fwd_max, head,
                                [*march, val.data_ptr(), arg.data_ptr()], check, events_ms)
    timed("parent", 0, 0, 1, 1)
    for u in UNROLLS[1:]:
        timed(f"thread_strided_u{u}", 0, 0, 1, u)
    for u in UNROLLS:
        timed(f"thread_bricked_u{u}", 0, 1, 1, u)
    _lane_probes(timed, G, U)
    return res, equal, f"lanes_bricked_g{G}_u{U}"


def probe_bwd_rays(lib, rows, density, axis, g, arg, ref, events_ms):
    """Time the siddon_bwd_rays probes, sum mode (``arg`` None: every probe)
    or MIP (one thread per ray strided and bricked); ms by name and, by
    name, whether each gives the kernel's bits ``ref``."""
    import torch

    rows = rows.contiguous()
    out = torch.empty((9, rows.shape[1]), dtype=torch.float32, device=rows.device)
    head, _bv = _head(rows, density, axis)
    G, U = _const("siddon.cuh", "kBwdLanes"), _const("siddon.cuh", "kBwdSlabs")

    def check(run):
        out.fill_(float("nan"))
        run()
        return bool(torch.equal(_bits(out), _bits(ref)))

    timed, res, equal = _prober(lib.probe_bwd_rays, head,
                                [g.data_ptr(), None if arg is None else arg.data_ptr(),
                                 out.data_ptr()], check, events_ms)
    timed("parent", 0, 0, 1, 1)
    timed("thread_bricked_u1", 0, 1, 1, 1)
    if arg is not None:
        return res, equal, "parent"
    _lane_probes(timed, G, U)
    return res, equal, f"lanes_bricked_g{G}_u{U}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE.parents[1],
                        help="checkout whose diffdrr_tpu_torch is timed")
    parser.add_argument("--no-probes", action="store_true", help="time the cases only")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("max_rays_timing: no CUDA device", file=sys.stderr)
        return 2

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.experiments.scatter_timing import events_ms
    from diffdrr_tpu_torch.ops.kernels import brick, build
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    label = args.root.resolve().name
    print(f"[max_rays_timing] {label}: package {Path(T.__file__).parent}; {card}", flush=True)
    build.build_all()
    has_lanes = "kBwdLanes" in (build.CSRC / "siddon.cuh").read_text()
    libs = None if args.no_probes or not has_lanes else load_probes((2, 0))
    dev = torch.device("cuda")
    trans = torch.tensor(TRANS, device=dev)
    drr = T.DRR(T.load_example_ct(), sdd=1020.0, height=200, delx=2.0, renderer="trilinear")
    density = drr.density
    rng = np.random.default_rng(0)
    cases = {}

    def timings(fn):
        def fresh():
            brick.clear_cache()
            return fn()

        return {"kernel": events_ms(fn), "burst": burst_ms(fn),
                "with_copy": events_ms(fn, brick.clear_cache), "burst_with_copy": burst_ms(fresh)}

    for pose, rot in (("main", MAIN_ROT), ("lateral", LATERAL_ROT)):
        src, tgt = drr.detector(T.convert(torch.tensor(rot, device=dev), trans, **KW))
        sv, tv = drr.affine_inverse(src), drr.affine_inverse(tgt)
        axis = int(torch.argmin(drr.worst_ratios(sv, tv)))
        wt = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
        h, n = raymarch_steps(density.shape[axis], 500)
        march = (h, n, int(J.is_blend(h)))
        jrows = prep_rays(sv, tv, wt, axis, density.shape, quadrature="joseph", h=h)
        srows = prep_rays(sv, tv, wt, axis, density.shape)
        R = jrows.shape[1]
        g = torch.tensor(rng.normal(size=R), dtype=torch.float32, device=dev)
        arg = K.siddon_fwd_max(srows, density, axis)[1]

        def fwd_max():
            return J.joseph_fwd_max(jrows, density, axis, h, n)

        def bwd_sum():
            return K.siddon_bwd_rays(srows, density, axis, g)

        def bwd_mip():
            return K.siddon_bwd_rays(srows, density, axis, g, arg)

        for name, fn, head in (
                ("joseph_fwd_max", fwd_max, {"h": h, "steps": n}),
                ("siddon_bwd_rays sum", bwd_sum, {"slabs": density.shape[axis]}),
                ("siddon_bwd_rays mip", bwd_mip, {"slabs": density.shape[axis]})):
            c = dict(head, rays=R, axis=axis, **timings(fn))
            if libs is not None:
                ref = fn()
                if name == "joseph_fwd_max":
                    c["probes"], c["equal"], c["shipped"] = probe_fwd_max(
                        libs[axis], jrows, density, axis, march, ref, events_ms)
                else:
                    c["probes"], c["equal"], c["shipped"] = probe_bwd_rays(
                        libs[axis], srows, density, axis, g, arg if "mip" in name else None,
                        ref, events_ms)
            cases[f"{name} {pose}"] = c
            print(f"[max_rays_timing] {label} {name} {pose} ({R} rays, axis {axis}): "
                  + ", ".join(f"{k} {c[k]:.4f}" for k in ("kernel", "burst", "with_copy",
                                                          "burst_with_copy")) + " ms", flush=True)
            for k, v in c.get("probes", {}).items():
                e = c["equal"].get(k)
                print(f"[max_rays_timing] {label} probe {name} {pose} {k} {v:.4f} ms"
                      + ("" if e is None else f" (equal {e})"), flush=True)
    print(json.dumps({"label": label, "card": card, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
