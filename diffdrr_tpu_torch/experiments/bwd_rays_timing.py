#!/usr/bin/env python3
"""Time joseph_bwd_rays of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/bwd_rays_timing.py [--root DIR] [--no-probes]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrapper ``joseph_bwd_rays``, which every
commit of the port has; the probes need a checkout whose
``csrc/joseph.cuh`` has the two-pass backward's lanes (``kBwdLanes``) and
are skipped in one without it.

Cases, on the 512x512x133 example CT, a 200x200 detector (sdd 1020 mm, 2 mm
pixels), at the trilinear renderer's stride (n_points 500): the main pose
(``chip_smoke.py``'s phase 7c: march axis 2, 133 planes, h = 1) and the
lateral pose ``rot = [pi/2 + 0.02, 0.01, -0.01]``, ``trans = [0, 850, 0]``
(axis 0, 512 planes, h = 1.024); ``joseph_bwd_rays`` with a random
cotangent in sum mode and in MIP mode (the argmax of ``joseph_fwd_max`` at
the same rays). For each, median CUDA-event times
(``scatter_timing.events_ms``):

  * ``kernel``: one wrapper call, as ``chip_smoke.py`` times it (the device
    time from the start event on, so the host's enqueue counts when it is
    later than the kernel), with the density's bricked copy already made
    (as a render's two-pass backward finds it);
  * ``burst``: the same over BURST calls back to back, per call (median of
    REPS bursts);
  * ``with_copy`` and ``burst_with_copy``: the same with the copy made anew
    in each call, as a direct call on a density that no forward rendered
    pays. A checkout or a mode whose kernel reads no copy makes none: there
    they equal ``kernel`` and ``burst``.

Probes (built from ``bwd_rays_probes.cu`` next to this file, once for each
march axis, both nvcc processes at once; C entry points called directly,
so no launch counter moves), each named by its G lanes a ray and U steps in
flight a lane. Sum mode: the parent (one thread per ray, strided) and one
thread per ray bricked; the lanes bricked and strided at G = 2, 4, 8, 16,
32 (U = 1) and at each layout with the package's G and U = 2, 4; the march
without loads at the package's G and U. MIP mode: one thread per ray
strided (the parent's kernel, which the package keeps) and bricked. Each
variant but the march without loads is held against the package's kernel
(``equal``: the same bits). Then ``wrapper_*``: the package's lanes (sum)
or one thread per ray (MIP) on each layout, back to back through a copy of
the wrapper's host path (its checks, the output's allocation, on the
bricked layout the copy's cache lookup), per call.

Prints one line per case and, last, one JSON object with every number and
the card (``nvidia-smi`` name and power limit). Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_probes(axes):
    """bwd_rays_probes.cu built once for each march axis in ``axes``; the
    loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "bwd_rays_probes.cu", [[f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    head = [i32] * 4 + [v, i64, v, i64, i64, i64, v] + [i32] * 7
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_bwd_rays.argtypes = head + [f32, i32, i32, v, v, v, v]
        lib.probe_bwd_rays.restype = i32
        libs[axis] = lib
    return libs


def wrapper_ms(lib, variant, rows, density, axis, march, g, arg):
    """Per-call ms, back to back, of the probe ``variant`` (kind, layout, G,
    U) behind a copy of ``joseph_bwd_rays``' host path: its checks, the
    output's allocation, the rows' strides and, on the bricked layout, the
    copy's cache lookup."""
    import torch

    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import (check, check_cotangent, runs_plain,
                                                       strides_extents)

    kind, layout, n_lanes, unroll = variant
    fixed = brick.brick_density(density)  # the strided layout passes it unread

    def call():
        check("joseph", rows, density, axis)
        gc = check_cotangent(rows, g, arg)
        runs_plain("joseph_bwd_rays", rows)
        r = rows.contiguous()
        out = torch.empty((7, r.shape[1]), dtype=torch.float32, device=r.device)
        bv = brick.bricked(density) if layout == 1 else fixed
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            rc = lib.probe_bwd_rays(kind, layout, n_lanes, unroll, r.data_ptr(), r.shape[1],
                                    density.data_ptr(), *strides_extents(density, axis)[:3],
                                    bv.data.data_ptr(), *bv.args(axis), *march, gc.data_ptr(),
                                    None if arg is None else arg.data_ptr(), out.data_ptr(),
                                    stream)
        if rc != 0:
            raise RuntimeError(f"probe {variant}: {rc}")
        return out

    return burst_ms(call)


def probe_bwd_rays(lib, rows, density, axis, march, g, arg, ref, events_ms):
    """Time the joseph_bwd_rays probes, sum mode (``arg`` None) or MIP (one
    thread per ray strided and bricked); ms by name and, by name, whether
    each gives the kernel's bits ``ref``."""
    import torch

    from diffdrr_tpu_torch.experiments.max_rays_timing import _bits, _const, _head, _lane_probes
    from diffdrr_tpu_torch.experiments.max_rays_timing import _prober

    rows = rows.contiguous()
    out = torch.empty((7, rows.shape[1]), dtype=torch.float32, device=rows.device)
    head, _bv = _head(rows, density, axis)
    G, U = _const("joseph.cuh", "kBwdLanes"), _const("joseph.cuh", "kBwdSteps")

    def check(run):
        out.fill_(float("nan"))
        run()
        return bool(torch.equal(_bits(out), _bits(ref)))

    timed, res, equal = _prober(lib.probe_bwd_rays, head,
                                [*march, g.data_ptr(), None if arg is None else arg.data_ptr(),
                                 out.data_ptr()], check, events_ms)
    timed("parent", 0, 0, 1, 1)
    timed("thread_bricked_u1", 0, 1, 1, 1)
    if arg is None:
        _lane_probes(timed, G, U)
        shipped = f"lanes_bricked_g{G}_u{U}"
        wrapped = {"bricked": (5, 1, G, U), "strided": (5, 0, G, U)}
    else:
        shipped = "parent"
        wrapped = {"bricked": (0, 1, 1, 1), "strided": (0, 0, 1, 1)}
    for name, variant in wrapped.items():
        res[f"wrapper_{name}"] = wrapper_ms(lib, variant, rows, density, axis, march, g, arg)
    return res, equal, shipped


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
        print("bwd_rays_timing: no CUDA device", file=sys.stderr)
        return 2

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.experiments.max_rays_timing import KW, LATERAL_ROT, MAIN_ROT, TRANS
    from diffdrr_tpu_torch.experiments.scatter_timing import events_ms
    from diffdrr_tpu_torch.ops.kernels import brick, build
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    label = args.root.resolve().name
    print(f"[bwd_rays_timing] {label}: package {Path(T.__file__).parent}; {card}", flush=True)
    build.build_all()
    has_lanes = "kBwdLanes" in (build.CSRC / "joseph.cuh").read_text()
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
        rows = prep_rays(sv, tv, wt, axis, density.shape, quadrature="joseph", h=h)
        R = rows.shape[1]
        g = torch.tensor(rng.normal(size=R), dtype=torch.float32, device=dev)
        arg = J.joseph_fwd_max(rows, density, axis, h, n)[1]
        for mode, a in (("sum", None), ("mip", arg)):
            def fn():
                return J.joseph_bwd_rays(rows, density, axis, h, n, g, a)

            c = dict(h=h, steps=n, rays=R, axis=axis, **timings(fn))
            if libs is not None:
                c["probes"], c["equal"], c["shipped"] = probe_bwd_rays(
                    libs[axis], rows, density, axis, march, g, a, fn(), events_ms)
            name = f"joseph_bwd_rays {mode} {pose}"
            cases[name] = c
            print(f"[bwd_rays_timing] {label} {name} ({R} rays, axis {axis}, h {h:g}): "
                  + ", ".join(f"{k} {c[k]:.4f}" for k in ("kernel", "burst", "with_copy",
                                                          "burst_with_copy")) + " ms", flush=True)
            for k, v in c.get("probes", {}).items():
                e = c["equal"].get(k)
                print(f"[bwd_rays_timing] {label} probe {name} {k} {v:.4f} ms"
                      + ("" if e is None else f" (equal {e})"), flush=True)
    print(json.dumps({"label": label, "card": card, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
