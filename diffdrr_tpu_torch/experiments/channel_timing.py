#!/usr/bin/env python3
"""Time the three channel kernels of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/channel_timing.py [--root DIR] [--no-probes]
        [--storage f32|bf16]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrappers ``joseph_fwd_ch``,
``joseph_bwd_rays_ch`` and ``joseph_bwd_vol_ch`` and the C entry point of
``joseph_bwd_vol_ch``, which every commit of the port since the channel
kernels has; the probes need a checkout whose ``csrc/joseph.cuh`` has the
channel lanes (``bwd_rays_ch_lanes``) and are skipped in one without it.

Cases, on the 512x512x133 example CT with its 7 labels (7 channels), a
200x200 detector (sdd 1020 mm, 2 mm pixels) and the trilinear renderer's
stride (n_points 500): the main pose (``chip_smoke.py``'s phase 8e: march
axis 2, 133 planes, h = 1) and the lateral pose ``rot = [pi/2 + 0.02, 0.01,
-0.01]``, ``trans = [0, 850, 0]`` (axis 0, 512 planes, h = 1.024). Each
with two cotangents: ``random`` (normal, as phase 8e) and ``own`` (phase
8b's, 2 w img for the channel render img and weights w). For each kernel,
median CUDA-event times (``scatter_timing.events_ms``):

  * ``kernel``: one wrapper call, as ``chip_smoke.py`` times it (the
    device time from the start event on, so the host's enqueue counts when
    it is later than the kernel); the ray backward with the bricked copies
    of the density and the labelmap already made (as pose backwards on one
    CT read them), the scatter with its zero fill;
  * ``burst``: the same over BURST calls back to back, per call (median
    of REPS bursts);
  * ``with_copy`` (``joseph_bwd_rays_ch``): the wrapper with its two copies
    (the density's and the labelmap's) made anew in each call;
  * ``alone`` (``joseph_bwd_vol_ch``): one launch of the C entry point into
    a preallocated gradient, zeroed before each launch outside the events.

Probes (built from ``channel_probes.cu`` next to this file, once for each
march axis, all nvcc processes at once; C entry points called directly, so
no launch counter moves; the random cotangent): for the ray backward the
parent kernel (one thread per ray on the strided density and labelmap); the lanes at
G = 1, 2, 4, 8, 16 and 32 lanes a ray on the strided and the bricked
density and labelmap (``bricked``: both, as the package's kernel reads
them; the labelmap's copy holds its int32 bits); at the best bricked G,
U = 2 and 4 steps in flight a lane, and the labelmap strided; the march
without loads at G = 1 and at the best G. Each is held against the package's
kernel (``max_rel_err``: the largest error over the rows, each relative to
its row's largest value; 0 for every variant, which keep the serial order
of sums). For the scatter: the parent (one thread per ray) and the warp
per ray's march without its scatter (``march_only``: no shared memory, no
atomics); the parent is held against the kernel (``max_rel_err``: the
largest error relative to the gradient's largest value).

``--storage bf16`` times ``joseph_bwd_rays_ch`` alone on the density's
bf16 copy (the wrapper's ``storage="bf16"``: ``joseph_bwd_rays_ch_bf16``;
the two other channel kernels read no bf16 copy), at the main pose, the
lateral pose at h = 1.024 and the lateral pose at h = 1 (512 steps, no
blend), with both cotangents, each with the float32 kernel's
``kernel_f32`` and ``burst_f32`` from the same process beside it. Its
probes are the file's build with -DPROBE_BF16 (the random cotangent): at
G = 4, 8 and 16 lanes a ray and U = 1, 2 and 4 steps in flight a lane, the
package's lanes on the bf16 copy (``raw``: its windows kept raw until the
terms), the parent's (``widened``: each read widened where it lands) and
the march without loads, each variant's registers and local memory a
thread, static shared memory a block and resident blocks an SM
(``attributes``); the two marches held against the package's kernel
(``max_rel_err`` as above: 0, the same rows).

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
UNROLLS = (2, 4)
N_CHANNELS = 7
# channel_probes.cu's bf16 variants, by its numbering, and their G and U.
BF16_VARIANTS = ("raw", "widened", "march_only")
BF16_LANES = (4, 8, 16)
BF16_UNROLLS = (1, 2, 4)


def load_probes(axes):
    """channel_probes.cu built once for each march axis in ``axes``; the
    loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "channel_probes.cu", [[f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_bwd_rays_ch.argtypes = ([i32] * 5 + [v, i64, v, i64, i64, i64, v] + [i32] * 7
                                          + [v, i64, i64, i64, v, f32, i32, i32, i32, v, v, v])
        lib.probe_bwd_vol_ch.argtypes = ([i32, v, i64, v, i64, i64, i64, v, i64, i64, i64]
                                         + [i32] * 3 + [f32, i32, i32, i32, v, v, v])
        lib.probe_bwd_rays_ch.restype = lib.probe_bwd_vol_ch.restype = i32
        libs[axis] = lib
    return libs


def load_bf16_probes(axes):
    """channel_probes.cu's bf16 build (-DPROBE_BF16) once for each march axis
    in ``axes``; the loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "channel_probes.cu",
                         [["-DPROBE_BF16", f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_bwd_rays_ch_bf16.argtypes = ([i32] * 3 + [v, i64, v] + [i32] * 7
                                               + [v, f32, i32, i32, i32, v, v, v])
        lib.probe_bwd_rays_ch_bf16_attributes.argtypes = [i32] * 3 + [v]
        lib.probe_bwd_rays_ch_bf16.restype = i32
        lib.probe_bwd_rays_ch_bf16_attributes.restype = i32
        libs[axis] = lib
    return libs


def bf16_attributes(lib):
    """{"<variant>_g<G>_u<U>": {registers, local_bytes, shared_bytes,
    blocks_per_sm}} of the bf16 probes."""
    res = (ctypes.c_int * 4)()
    out = {}
    for k, name in enumerate(BF16_VARIANTS):
        for gl in BF16_LANES:
            for u in BF16_UNROLLS:
                rc = lib.probe_bwd_rays_ch_bf16_attributes(k, gl, u, res)
                if rc != 0:
                    raise RuntimeError(f"attributes {name} G {gl} U {u}: {rc}")
                out[f"{name}_g{gl}_u{u}"] = dict(
                    zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), res))
    return out


def bf16_probe_case(lib, rows, density, labels, axis, march, g, ref_rows, events_ms):
    """Time the bf16 probes of joseph_bwd_rays_ch (see the module docstring)
    on ``density``'s bf16 copy; ms by ``<variant>_g<G>_u<U>``, and the two
    marches' ``max_rel_err`` against the kernel's rows ``ref_rows``."""
    import torch

    from diffdrr_tpu_torch.experiments.fwdgrad_timing import max_rel_err
    from diffdrr_tpu_torch.ops.kernels import brick

    rows = rows.contiguous()
    n = rows.shape[1]
    out = torch.empty((ref_rows.shape[0], n), dtype=torch.float32, device=rows.device)
    bv, bl = brick.brick_density(density, "bf16"), brick.brick_density(labels)
    stream = torch.cuda.current_stream().cuda_stream

    def run(k, gl, u):
        rc = lib.probe_bwd_rays_ch_bf16(k, gl, u, rows.data_ptr(), n, bv.data.data_ptr(),
                                        *bv.args(axis), bl.data.data_ptr(), *march, N_CHANNELS,
                                        g.data_ptr(), out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bf16 probe rays {BF16_VARIANTS[k]} G {gl} U {u}: {rc}")

    res, err = {}, {}
    for k, name in enumerate(BF16_VARIANTS):
        for gl in BF16_LANES:
            for u in BF16_UNROLLS:
                key = f"{name}_g{gl}_u{u}"
                res[key] = events_ms(lambda: run(k, gl, u))
                if name != "march_only":
                    run(k, gl, u)
                    err[key] = max_rel_err(out, ref_rows)
    return res, err


def probe_case(lib, rows, density, labels, axis, march, g, ref_rows, ref_grad, events_ms):
    """Time the probe variants (see the module docstring); ms by name, and
    each variant's ``max_rel_err`` against the kernels' ``ref_rows`` and
    ``ref_grad``."""
    import torch

    from diffdrr_tpu_torch.experiments.fwdgrad_timing import max_rel_err
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import strides_extents

    rows = rows.contiguous()
    n = rows.shape[1]
    out = torch.empty((ref_rows.shape[0], n), dtype=torch.float32, device=rows.device)
    strided = strides_extents(density, axis)[:3]
    lab_strided = strides_extents(labels, axis)[:3]
    bv = brick.brick_density(density)
    bl = brick.brick_density(labels)
    stream = torch.cuda.current_stream().cuda_stream

    def rays(kind, layout, lab_layout, g_lanes, u=1):
        rc = lib.probe_bwd_rays_ch(kind, layout, lab_layout, g_lanes, u, rows.data_ptr(), n,
                                   density.data_ptr(), *strided, bv.data.data_ptr(),
                                   *bv.args(axis), labels.data_ptr(), *lab_strided,
                                   bl.data.data_ptr(), *march, N_CHANNELS, g.data_ptr(),
                                   out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"probe rays kind {kind} layout {layout}/{lab_layout} "
                               f"G {g_lanes} U {u}: {rc}")

    res, err = {}, {}

    def lanes(name, *variant):
        res[name] = events_ms(lambda: rays(*variant))
        rays(*variant)
        err[name] = max_rel_err(out, ref_rows)

    lanes("rays_parent", 3, 0, 0, 1)
    for gl in LANES:
        lanes(f"rays_strided_g{gl}", 0, 0, 0, gl)
        lanes(f"rays_bricked_g{gl}", 0, 1, 1, gl)
    best = min(LANES, key=lambda gl: res[f"rays_bricked_g{gl}"])
    for u in UNROLLS:
        lanes(f"rays_bricked_g{best}_u{u}", 0, 1, 1, best, u)
    lanes(f"rays_bricked_labels_strided_g{best}", 0, 1, 0, best)
    for gl in sorted({1, best}):
        res[f"rays_march_only_g{gl}"] = events_ms(lambda: rays(1, 1, 1, gl))

    grad = torch.zeros(density.shape, dtype=torch.float32, device=rows.device)
    sums = torch.empty(n, dtype=torch.float32, device=rows.device)

    def vol(kind):
        rc = lib.probe_bwd_vol_ch(kind, rows.data_ptr(), n, labels.data_ptr(), *lab_strided,
                                  grad.data_ptr(), *strides_extents(grad, axis), *march,
                                  N_CHANNELS, g.data_ptr(), sums.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"probe vol kind {kind}: {rc}")

    res["vol_parent"] = events_ms(lambda: vol(3), grad.zero_)
    grad.zero_()
    vol(3)
    err["vol_parent"] = float((grad - ref_grad).abs().max() / ref_grad.abs().max())
    res["vol_march_only"] = events_ms(lambda: vol(1))
    return res, err, best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE.parents[1],
                        help="checkout whose diffdrr_tpu_torch is timed")
    parser.add_argument("--no-probes", action="store_true", help="time the cases only")
    parser.add_argument("--storage", choices=("f32", "bf16"), default="f32",
                        help="the density's copy joseph_bwd_rays_ch reads (bf16: "
                             "storage='bf16', that kernel alone, float32 beside it)")
    args = parser.parse_args(argv)
    bf16 = args.storage == "bf16"
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("channel_timing: no CUDA device", file=sys.stderr)
        return 2

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.experiments.scatter_timing import events_ms
    from diffdrr_tpu_torch.ops.kernels import brick, build
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels._launch import call, strides_extents
    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    label = args.root.resolve().name
    print(f"[channel_timing] {label} ({args.storage}): package {Path(T.__file__).parent}; "
          f"{card}", flush=True)
    build.build_all()
    has_lanes = "bwd_rays_ch_lanes" in (build.CSRC / "joseph.cuh").read_text()
    libs = (None if args.no_probes or not has_lanes
            else (load_bf16_probes if bf16 else load_probes)((2, 0)))
    attributes = bf16_attributes(libs[2]) if bf16 and libs is not None else None
    dev = torch.device("cuda")
    trans = torch.tensor(TRANS, device=dev)
    drr = T.DRR(T.load_example_ct(), sdd=1020.0, height=200, delx=2.0, renderer="trilinear")
    density, labels = drr.density, drr.mask
    w = torch.tensor(np.random.default_rng(4).uniform(0.5, 1.5, N_CHANNELS),
                     dtype=torch.float32, device=dev)
    cases = {}

    poses = [("main", MAIN_ROT, None), ("lateral", LATERAL_ROT, None)]
    if bf16:  # the lateral pose at h = 1 too: 512 steps, no blend
        poses.append(("lateral h1", LATERAL_ROT, 1.0))
    for pose, rot, h_pose in poses:
        src, tgt = drr.detector(T.convert(torch.tensor(rot, device=dev), trans, **KW))
        sv, tv = drr.affine_inverse(src), drr.affine_inverse(tgt)
        axis = int(torch.argmin(drr.worst_ratios(sv, tv)))
        wt = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
        h, n = raymarch_steps(density.shape[axis], 500)
        if h_pose is not None:
            h, n = h_pose, density.shape[axis]
        march = (h, n, int(J.is_blend(h)))
        rows = prep_rays(sv, tv, wt, axis, density.shape, quadrature="joseph", h=h)
        R = rows.shape[1]
        img = J.joseph_fwd_ch(rows, density, labels, axis, h, n, N_CHANNELS)
        cots = {"random": torch.tensor(np.random.default_rng(5).normal(size=(N_CHANNELS, R)),
                                       dtype=torch.float32, device=dev),
                "own": 2 * w[:, None] * img}

        def fwd():
            return J.joseph_fwd_ch(rows, density, labels, axis, h, n, N_CHANNELS)

        head = {"rays": R, "axis": axis, "h": h, "steps": n, "storage": args.storage}
        if not bf16:
            c = dict(head, kernel=events_ms(fwd), burst=burst_ms(fwd))
            cases[f"joseph_fwd_ch {pose}"] = c
            print(f"[channel_timing] {label} joseph_fwd_ch {pose} ({R} rays, axis {axis}, "
                  f"h {h:.6f}): kernel {c['kernel']:.4f} ms, burst {c['burst']:.4f}", flush=True)
        grad = torch.zeros(density.shape, dtype=torch.float32, device=dev)
        for cot, g in cots.items():
            def rays_bwd(*storage):
                return J.joseph_bwd_rays_ch(rows, density, labels, axis, h, n, g, *storage)

            if bf16:
                def bf16_bwd():
                    return rays_bwd("bf16")

                cr = dict(head, kernel=events_ms(bf16_bwd), burst=burst_ms(bf16_bwd),
                          with_copy=events_ms(bf16_bwd, brick.clear_cache),
                          kernel_f32=events_ms(rays_bwd), burst_f32=burst_ms(rays_bwd))
                if libs is not None and cot == "random":
                    cr["probes"], cr["max_rel_err"] = bf16_probe_case(
                        libs[axis], rows, density, labels, axis, march, g, bf16_bwd(), events_ms)
                cases[f"joseph_bwd_rays_ch {pose} {cot}"] = cr
                print(f"[channel_timing] {label} joseph_bwd_rays_ch {pose} {cot} ({R} rays, "
                      f"axis {axis}, h {h:.6f}, bf16): kernel {cr['kernel']:.4f} ms, burst "
                      f"{cr['burst']:.4f}, with_copy {cr['with_copy']:.4f}, float32 kernel "
                      f"{cr['kernel_f32']:.4f}, burst {cr['burst_f32']:.4f}", flush=True)
                for k, v in cr.get("probes", {}).items():
                    e = cr["max_rel_err"].get(k)
                    print(f"[channel_timing] {label} bf16 probe {pose} {k} {v:.4f} ms"
                          + ("" if e is None else f" (max rel err {e:.2e})"), flush=True)
                continue

            def vol_bwd():
                return J.joseph_bwd_vol_ch(rows, g, labels, density.shape, axis, h, n)

            def vol_alone():
                call("joseph", "joseph_bwd_vol_ch", dev, rows.data_ptr(), R, g.data_ptr(),
                     labels.data_ptr(), *strides_extents(labels, axis)[:3], grad.data_ptr(),
                     *strides_extents(grad, axis), *march, N_CHANNELS)

            cr = dict(head, kernel=events_ms(rays_bwd), burst=burst_ms(rays_bwd),
                      with_copy=events_ms(rays_bwd, brick.clear_cache))
            cv = dict(head, kernel=events_ms(vol_bwd), burst=burst_ms(vol_bwd),
                      alone=events_ms(vol_alone, grad.zero_),
                      zero_rays=int((g == 0).all(0).sum()))
            if libs is not None and cot == "random":
                cr["probes"], cr["max_rel_err"], cr["best_g"] = probe_case(
                    libs[axis], rows, density, labels, axis, march, g, rays_bwd(), vol_bwd(),
                    events_ms)
            cases[f"joseph_bwd_rays_ch {pose} {cot}"] = cr
            cases[f"joseph_bwd_vol_ch {pose} {cot}"] = cv
            print(f"[channel_timing] {label} joseph_bwd_rays_ch {pose} {cot}: kernel "
                  f"{cr['kernel']:.4f} ms, burst {cr['burst']:.4f}, with_copy "
                  f"{cr['with_copy']:.4f}", flush=True)
            print(f"[channel_timing] {label} joseph_bwd_vol_ch {pose} {cot}: kernel "
                  f"{cv['kernel']:.4f} ms (with its zero fill), burst {cv['burst']:.4f}, alone "
                  f"{cv['alone']:.4f} ({cv['zero_rays']} rays with g = 0)", flush=True)
            for k, v in cr.get("probes", {}).items():
                e = cr["max_rel_err"].get(k)
                print(f"[channel_timing] {label} probe {pose} {k} {v:.4f} ms"
                      + ("" if e is None else f" (max rel err {e:.2e})"), flush=True)
    for k, a in (attributes or {}).items():
        print(f"[channel_timing] {label} bf16 probe joseph_bwd_rays_ch {k}: {a}", flush=True)
    print(json.dumps({"label": label, "card": card, "storage": args.storage, "cases": cases,
                      "bf16_attributes": attributes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
