#!/usr/bin/env python3
"""Time the two fused pose kernels of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/fwdgrad_timing.py [--root DIR] [--no-probes]
        [--storage f32|bf16]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrappers ``siddon_fwdgrad`` and
``joseph_fwdgrad``, which every commit of the port since the Joseph kernels
has; the probes need a checkout whose headers have the lanes' march
(``csrc/lanes.cuh``) and are skipped in one without it.

Cases, on the 512x512x133 example CT with a 200x200 detector (sdd 1020 mm,
2 mm pixels): the main pose (``chip_smoke.py``'s, march axis 2, 133 slabs)
and the lateral pose ``rot = [pi/2 + 0.02, 0.01, -0.01]``, ``trans = [0,
850, 0]`` (march axis 0, 512 slabs). ``siddon_fwdgrad`` at each;
``joseph_fwdgrad`` at each with the trilinear renderer's stride (n_points
500: h = 1 at the main pose, h = 511 / 499, a fractional stride, at the
lateral one), at the lateral pose also at h = 1 (512 steps), and at the
main pose also in max mode. ``--storage bf16`` times the same cases on the
density's bf16 copy (the wrappers' ``storage="bf16"``: the kernels'
``*_bf16`` instantiations). For each, median CUDA-event times
(``scatter_timing.events_ms``):

  * ``kernel``: the wrapper with the density's bricked copy already made
    (as a registration reads it), CUDA events around one call, as
    ``chip_smoke.py`` times it: the device time from the start event on,
    so a launch that the host enqueues later than the kernel takes counts
    the host's delay too;
  * ``burst``: the same over BURST calls back to back, per call (median of
    REPS bursts): the host's enqueue overlaps the previous call's kernel;
  * ``with_copy``: the wrapper with the copy made anew in each call.

Beside each sum-mode case, the two-pass pose backward's sum mode
(``siddon_bwd_rays``, ``joseph_bwd_rays``: the same lanes on the same copy,
rows times a cotangent g drawn from a seed), ``kernel`` and ``burst``.

Probes (built from ``fwdgrad_probes.cu`` next to this file, once for each
march axis, all nvcc processes at once; C entry points called directly, so
no launch counter moves). Under ``--storage bf16`` (the file's build with
-DPROBE_BF16), in sum and max mode: at G = 4, 8 and 16 lanes a ray and
U = 1, 2 and 4 slabs (steps) in flight a lane, the package's march on the
bf16 copy (``raw``: its reads kept raw until the sums), the parent's
(``widened``: each read widened where it lands), the raw loads only (sum
mode) and the march without loads; each variant's registers and local
memory a thread, static shared memory a block and resident blocks an SM
(``attributes``); the two marches held against the package's kernel
(``max_rel_err``, below, and in max mode the argmax steps exact). In
float32, sum mode: the parent kernel (one thread per ray
on the strided density); the lanes' march at G = 1, 2, 4, 8, 16 and 32
lanes a ray on the strided and the bricked layout, and the design first
tried (``tree``: each lane's own partial sums, met in a tree of shuffles)
at each G on the bricked one; at the best bricked G, U = 1, 2 and 4 slabs
(steps) in flight a lane; the march without loads and the loads only
(strided and bricked; Joseph at an integer h only), each at G = 1 and at
the best G. Every probe of the fused march is held against the package's
kernel (``max_rel_err``: the largest error over the rows, each relative
to its row's largest value; 0 for every variant that keeps the serial
order of sums).

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
LANES = (1, 2, 4, 8, 16, 32)
BURST = 20
REPS = 5
UNROLLS = (1, 2, 4)
# fwdgrad_probes.cu's bf16 variants, by its numbering, and their G and U.
BF16_VARIANTS = ("raw", "widened", "loads_only", "march_only")
BF16_LANES = (4, 8, 16)


def load_probes(axes):
    """fwdgrad_probes.cu built once for each march axis in ``axes``; the
    loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "fwdgrad_probes.cu", [[f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    head = [i32] * 4 + [v, i64, v, i64, i64, i64, v] + [i32] * 7
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_siddon_fwdgrad.argtypes = head + [v, v]
        lib.probe_joseph_fwdgrad.argtypes = head + [ctypes.c_float, i32, i32, v, v, v]
        lib.probe_siddon_fwdgrad.restype = lib.probe_joseph_fwdgrad.restype = i32
        libs[axis] = lib
    return libs


def load_bf16_probes(axes):
    """fwdgrad_probes.cu's bf16 build (-DPROBE_BF16) once for each march
    axis in ``axes``; the loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "fwdgrad_probes.cu",
                         [["-DPROBE_BF16", f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    head = [i32] * 3 + [v, i64, v] + [i32] * 7
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_siddon_fwdgrad_bf16.argtypes = head + [v, v]
        lib.probe_joseph_fwdgrad_bf16.argtypes = head + [ctypes.c_float, i32, i32, v, v, v]
        lib.probe_fwdgrad_bf16_attributes.argtypes = [i32] * 4 + [v]
        for fn in (lib.probe_siddon_fwdgrad_bf16, lib.probe_joseph_fwdgrad_bf16,
                   lib.probe_fwdgrad_bf16_attributes):
            fn.restype = i32
        libs[axis] = lib
    return libs


def bf16_attributes(lib):
    """{family: {"<variant>_g<G>_u<U>": {registers, local_bytes,
    shared_bytes, blocks_per_sm}}} of the bf16 probes."""
    res = (ctypes.c_int * 4)()
    out = {}
    for f, family in enumerate(("siddon", "joseph")):
        for k, name in enumerate(BF16_VARIANTS):
            for g in BF16_LANES:
                for u in UNROLLS:
                    rc = lib.probe_fwdgrad_bf16_attributes(f, k, g, u, res)
                    if rc != 0:
                        raise RuntimeError(f"attributes {family} {name} G {g} U {u}: {rc}")
                    out.setdefault(family, {})[f"{name}_g{g}_u{u}"] = dict(
                        zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), res))
    return out


def bf16_probe_case(lib, family, reduce, rows, density, axis, march, ref, events_ms):
    """Time the bf16 probe variants (see the module docstring) on
    ``density``'s bf16 copy; ms by ``<variant>_g<G>_u<U>``, and the two
    marches' ``max_rel_err`` against the kernel's output ``ref`` (rows, or
    in max mode (rows, argmax): the argmax steps must be equal)."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick

    rows = rows.contiguous()
    n = rows.shape[1]
    ref_rows = ref[0] if reduce == "max" else ref
    out = torch.empty((ref_rows.shape[0], n), dtype=torch.float32, device=rows.device)
    arg = torch.empty(n, dtype=torch.int32, device=rows.device) if reduce == "max" else None
    bv = brick.brick_density(density, "bf16")
    stream = torch.cuda.current_stream().cuda_stream

    def run(k, g, u):
        head = [k, g, u, rows.data_ptr(), n, bv.data.data_ptr(), *bv.args(axis)]
        if family == "siddon":
            rc = lib.probe_siddon_fwdgrad_bf16(*head, out.data_ptr(), stream)
        else:
            rc = lib.probe_joseph_fwdgrad_bf16(*head, *march, out.data_ptr(),
                                               None if arg is None else arg.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bf16 probe {family} {BF16_VARIANTS[k]} G {g} U {u}: {rc}")

    res, err = {}, {}
    for k, name in enumerate(BF16_VARIANTS):
        if name == "loads_only" and reduce == "max":
            continue
        for g in BF16_LANES:
            for u in UNROLLS:
                key = f"{name}_g{g}_u{u}"
                res[key] = events_ms(lambda: run(k, g, u))
                if name in ("raw", "widened"):
                    run(k, g, u)
                    err[key] = max_rel_err(out, ref_rows)
                    if arg is not None and not torch.equal(arg, ref[1]):
                        raise AssertionError(f"bf16 probe {key}: argmax steps differ")
    return res, err


def burst_ms(fn):
    """Median over REPS bursts of CUDA-event ms per call of BURST calls of
    ``fn`` back to back."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return statistics.median(times)


def max_rel_err(got, ref):
    """The largest error over the rows, each relative to its row's largest |value|."""
    import torch

    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    return float(torch.max(torch.abs(got - ref) / scale))


def probe_case(lib, family, rows, density, axis, march, ref, events_ms):
    """Time the probe variants (see the module docstring); ms by name, and
    each fused variant's ``max_rel_err`` against the kernel's rows ``ref``."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import strides_extents

    rows = rows.contiguous()
    n = rows.shape[1]
    out = torch.empty((ref.shape[0], n), dtype=torch.float32, device=rows.device)
    strided = strides_extents(density, axis)[:3]
    bv = brick.brick_density(density)
    stream = torch.cuda.current_stream().cuda_stream

    def run(layout, kind, g, u=1):
        args = [layout, kind, g, u, rows.data_ptr(), n, density.data_ptr(), *strided,
                bv.data.data_ptr(), *bv.args(axis)]
        if family == "siddon":
            rc = lib.probe_siddon_fwdgrad(*args, out.data_ptr(), stream)
        else:
            rc = lib.probe_joseph_fwdgrad(*args, *march, out.data_ptr(), None, stream)
        if rc != 0:
            raise RuntimeError(f"probe {family} layout {layout} kind {kind} G {g} U {u}: {rc}")

    res, err = {}, {}

    def fused(name, *variant):
        res[name] = events_ms(lambda: run(*variant))
        run(*variant)
        err[name] = max_rel_err(out, ref)

    fused("parent", 0, 3, 1)
    for g in LANES:
        fused(f"strided_g{g}", 0, 0, g)
        fused(f"bricked_g{g}", 1, 0, g)
        fused(f"tree_g{g}", 1, 4, g)
    best = min(LANES, key=lambda g: res[f"bricked_g{g}"])
    for u in UNROLLS[1:]:
        fused(f"bricked_g{best}_u{u}", 1, 0, best, u)
    for g in sorted({1, best}):
        res[f"march_only_g{g}"] = events_ms(lambda: run(1, 1, g))
        if family == "siddon" or not march[2]:
            res[f"loads_only_strided_g{g}"] = events_ms(lambda: run(0, 2, g))
            res[f"loads_only_bricked_g{g}"] = events_ms(lambda: run(1, 2, g))
    return res, err, best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE.parents[1],
                        help="checkout whose diffdrr_tpu_torch is timed")
    parser.add_argument("--no-probes", action="store_true", help="time the cases only")
    parser.add_argument("--storage", choices=("f32", "bf16"), default="f32",
                        help="the density's copy the kernels read (bf16: storage='bf16')")
    args = parser.parse_args(argv)
    bf16 = args.storage == "bf16"
    storage = ("bf16",) if bf16 else ()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("fwdgrad_timing: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.experiments.scatter_timing import events_ms
    from diffdrr_tpu_torch.ops.kernels import build
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps
    try:
        from diffdrr_tpu_torch.ops.kernels import brick
    except ImportError:
        brick = None

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    label = args.root.resolve().name
    print(f"[fwdgrad_timing] {label} ({args.storage}): package {Path(T.__file__).parent}; "
          f"{card}", flush=True)
    build.build_all()
    has_lanes = (build.CSRC / "lanes.cuh").exists()
    libs = (None if args.no_probes or not has_lanes
            else (load_bf16_probes if bf16 else load_probes)((2, 0)))
    attributes = bf16_attributes(libs[2]) if bf16 and libs is not None else None
    dev = torch.device("cuda")
    trans = torch.tensor(TRANS, device=dev)
    drr = T.DRR(T.load_example_ct(), sdd=1020.0, height=200, delx=2.0)
    density = drr.density
    cases = {}

    for pose, rot in (("main", MAIN_ROT), ("lateral", LATERAL_ROT)):
        src, tgt = drr.detector(T.convert(torch.tensor(rot, device=dev), trans, **KW))
        sv, tv = drr.affine_inverse(src), drr.affine_inverse(tgt)
        axis = int(torch.argmin(drr.worst_ratios(sv, tv)))
        w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
        h, n = raymarch_steps(density.shape[axis], 500)
        march = (h, n, int(J.is_blend(h)))
        runs = [("siddon", "sum", prep_rays(sv, tv, w, axis, density.shape), march, "")]
        jrows = prep_rays(sv, tv, w, axis, density.shape, quadrature="joseph", h=h)
        runs += [("joseph", reduce, jrows, march, "") for reduce in (
            ("sum", "max") if pose == "main" else ("sum",))]
        if pose == "lateral":  # Joseph at an integer h there too: no blend
            n1 = density.shape[axis]
            runs.append(("joseph", "sum", prep_rays(sv, tv, w, axis, density.shape,
                                                    quadrature="joseph", h=1.0),
                         (1.0, n1, 0), " h1"))
        for family, reduce, rows, mch, tag in runs:
            def fwdgrad(rows=rows, mch=mch, family=family, reduce=reduce):
                if family == "siddon":
                    return K.siddon_fwdgrad(rows, density, axis, *storage)
                out = J.joseph_fwdgrad(rows, density, axis, *mch[:2], reduce, *storage)
                return out if reduce == "max" else out[0]

            name = f"{family}_fwdgrad{'' if reduce == 'sum' else '[max]'} {pose}{tag}"
            c = {"rays": rows.shape[1], "axis": axis, "h": mch[0], "steps": mch[1],
                 "storage": args.storage, "kernel": events_ms(fwdgrad),
                 "burst": burst_ms(fwdgrad)}
            if brick is not None:
                c["with_copy"] = events_ms(fwdgrad, brick.clear_cache)
            if libs is not None and bf16:
                c["probes"], c["max_rel_err"] = bf16_probe_case(
                    libs[axis], family, reduce, rows, density, axis, mch, fwdgrad(), events_ms)
            elif libs is not None and reduce == "sum":
                ref = fwdgrad()
                c["probes"], c["max_rel_err"], c["best_g"] = probe_case(
                    libs[axis], family, rows, density, axis, mch, ref, events_ms)
            cases[name] = c
            keys = [name]
            if reduce == "sum":  # the two-pass backward's sum mode runs the same lanes
                g = torch.tensor(np.random.default_rng(19).normal(size=rows.shape[1]),
                                 dtype=torch.float32, device=dev)

                def bwd_rays(rows=rows, mch=mch, family=family, g=g):
                    if family == "siddon":
                        return K.siddon_bwd_rays(rows, density, axis, g, None, *storage)
                    return J.joseph_bwd_rays(rows, density, axis, *mch[:2], g, None, *storage)

                keys.append(f"{family}_bwd_rays {pose}{tag}")
                cases[keys[-1]] = {
                    "rays": rows.shape[1], "axis": axis, "h": mch[0], "steps": mch[1],
                    "storage": args.storage, "kernel": events_ms(bwd_rays),
                    "burst": burst_ms(bwd_rays)}
            for key in keys:
                c = cases[key]
                extra = f", with_copy {c['with_copy']:.4f}" if "with_copy" in c else ""
                print(f"[fwdgrad_timing] {label} {key} ({c['rays']} rays, axis {axis}, "
                      f"h {mch[0]:.6f}, {args.storage}): kernel {c['kernel']:.4f} ms, burst "
                      f"{c['burst']:.4f}{extra}", flush=True)
            for k, v in cases[name].get("probes", {}).items():
                e = cases[name]["max_rel_err"].get(k)
                print(f"[fwdgrad_timing] {label} probe {name} {k} {v:.4f} ms"
                      + ("" if e is None else f" (max rel err {e:.2e})"), flush=True)
    for family, variants in (attributes or {}).items():
        for k, a in variants.items():
            print(f"[fwdgrad_timing] {label} bf16 probe {family} {k}: {a}", flush=True)
    print(json.dumps({"label": label, "card": card, "storage": args.storage, "cases": cases,
                      "bf16_attributes": attributes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
