#!/usr/bin/env python3
"""Time joseph_fwd_ch and siddon_fwd_max of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/max_channel_timing.py [--root DIR] [--no-probes]
        [--storage f32|bf16]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrappers ``joseph_fwd_ch`` and
``siddon_fwd_max``, which every commit of the port since the channel
kernels has; the probes need a checkout whose ``csrc/joseph.cuh`` has the
channel forward's lanes (``fwd_ch_lanes``) and are skipped in one without it.

Cases, on the 512x512x133 example CT with its 7 labels (7 channels), a
200x200 detector (sdd 1020 mm, 2 mm pixels): the main pose (``chip_smoke.py``'s
phases 4b and 8e: march axis 2, 133 planes) and the lateral pose ``rot =
[pi/2 + 0.02, 0.01, -0.01]``, ``trans = [0, 850, 0]`` (axis 0, 512 planes);
``joseph_fwd_ch`` at the trilinear renderer's stride (n_points 500: h = 1 and
1.024), ``siddon_fwd_max`` on the slab march. For each, median CUDA-event
times (``scatter_timing.events_ms``):

  * ``kernel``: one wrapper call, as ``chip_smoke.py`` times it (the device
    time from the start event on, so the host's enqueue counts when it is
    later than the kernel), with the bricked copies already made (as every
    render and backward of one CT reads them);
  * ``burst``: the same over BURST calls back to back, per call (median of
    REPS bursts);
  * ``with_copy`` and ``burst_with_copy``: the same with the copies (the
    density's, and for ``joseph_fwd_ch`` the labelmap's) made anew in each
    call, as a render of a new density pays. A checkout whose kernels read
    no copy makes none: there they equal ``kernel`` and ``burst``.

Probes (built from ``max_channel_probes.cu`` next to this file, once for
each march axis, all nvcc processes at once; C entry points called
directly, so no launch counter moves), each named by its G lanes a ray and
U steps or slabs in flight a lane. ``joseph_fwd_ch``: the parent kernel
(one thread per ray on the strided density and labelmap, sums in global
memory); one thread per ray (G = 1, the sums in shared memory and the last
sample's in a register) strided at U = 4 and bricked at U = 1, 2, 4, and
bricked at U = 4 with the sums in global memory or in shared memory
without the register; the package's lanes bricked at G = 1, 2, 4, 8, 16,
32 (U = 1) and at its own G with U = 2, 4, and strided at its own G and U;
the march without loads one thread per ray and at the package's G and U.
``siddon_fwd_max``: the parent (one thread per ray, strided, U = 1); one
thread per ray bricked at U = 1, 2, 4; the lanes as for
``joseph_fwd_ch``; the march without loads likewise. Each variant but the
march without loads is held against the package's kernel (``equal``: the
same bits, and for ``siddon_fwd_max`` the same argmax).

``--storage bf16`` times ``joseph_fwd_ch`` alone on the density's bf16
copy (the wrapper's ``storage="bf16"``: ``joseph_fwd_ch_bf16``), at the
main pose, the lateral pose at h = 1.024 and the lateral pose at h = 1 (512
steps, no blend), each with the float32 kernel's ``kernel_f32`` and
``burst_f32`` from the same process beside it. Its probes are the file's
build with -DPROBE_BF16: at G = 4, 8 and 16 lanes a ray and U = 1, 2 and 4
steps in flight a lane, the package's lanes on the bf16 copy (``raw``:
its windows kept raw until the samples), the parent's (``widened``: each
read widened where it lands) and the march without loads, each variant's
registers and local memory a thread, static shared memory a block and
resident blocks an SM at 7 channels (``attributes``); the two marches
held against the package's kernel (``equal``: the same bits).

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
UNROLLS = (1, 2, 4)
N_CHANNELS = 7
# max_channel_probes.cu's bf16 variants, by its numbering, and their G.
BF16_VARIANTS = ("raw", "widened", "march_only")
BF16_LANES = (4, 8, 16)


def load_probes(axes):
    """max_channel_probes.cu built once for each march axis in ``axes``; the
    loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "max_channel_probes.cu",
                         [[f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    head = [i32] * 4 + [v, i64, v, i64, i64, i64, v] + [i32] * 7
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_fwd_ch.argtypes = head + [v, i64, i64, i64, v, f32, i32, i32, i32, v, v]
        lib.probe_fwd_max.argtypes = head + [v, v, v]
        lib.probe_fwd_ch.restype = lib.probe_fwd_max.restype = i32
        libs[axis] = lib
    return libs


def load_bf16_probes(axes):
    """max_channel_probes.cu's bf16 build (-DPROBE_BF16) once for each march
    axis in ``axes``; the loaded libraries by axis."""
    from diffdrr_tpu_torch.experiments.fwd_timing import build_sources

    outs = build_sources(HERE / "max_channel_probes.cu",
                         [["-DPROBE_BF16", f"-DPROBE_AXIS={a}"] for a in axes])
    v, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    libs = {}
    for axis, out in zip(axes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_fwd_ch_bf16.argtypes = ([i32] * 3 + [v, i64, v] + [i32] * 7
                                          + [v, f32, i32, i32, i32, v, v])
        lib.probe_fwd_ch_bf16_attributes.argtypes = [i32] * 4 + [v]
        lib.probe_fwd_ch_bf16.restype = lib.probe_fwd_ch_bf16_attributes.restype = i32
        libs[axis] = lib
    return libs


def bf16_attributes(lib):
    """{"<variant>_g<G>_u<U>": {registers, local_bytes, shared_bytes,
    blocks_per_sm}} of the bf16 probes at N_CHANNELS channels."""
    res = (ctypes.c_int * 4)()
    out = {}
    for k, name in enumerate(BF16_VARIANTS):
        for g in BF16_LANES:
            for u in UNROLLS:
                rc = lib.probe_fwd_ch_bf16_attributes(k, g, u, N_CHANNELS, res)
                if rc != 0:
                    raise RuntimeError(f"attributes {name} G {g} U {u}: {rc}")
                out[f"{name}_g{g}_u{u}"] = dict(
                    zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), res))
    return out


def bf16_probe_fwd_ch(lib, rows, density, labels, axis, march, ref, events_ms):
    """Time the bf16 probes of joseph_fwd_ch (see the module docstring) on
    ``density``'s bf16 copy; ms by ``<variant>_g<G>_u<U>`` and, for the two
    marches, whether each gives the kernel's bits ``ref``."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick

    rows = rows.contiguous()
    n = rows.shape[1]
    out = torch.empty((N_CHANNELS, n), dtype=torch.float32, device=rows.device)
    bv, bl = brick.brick_density(density, "bf16"), brick.brick_density(labels)
    stream = torch.cuda.current_stream().cuda_stream

    def run(k, g, u):
        rc = lib.probe_fwd_ch_bf16(k, g, u, rows.data_ptr(), n, bv.data.data_ptr(),
                                   *bv.args(axis), bl.data.data_ptr(), *march, N_CHANNELS,
                                   out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bf16 probe fwd_ch {BF16_VARIANTS[k]} G {g} U {u}: {rc}")

    res, equal = {}, {}
    for k, name in enumerate(BF16_VARIANTS):
        for g in BF16_LANES:
            for u in UNROLLS:
                key = f"{name}_g{g}_u{u}"
                res[key] = events_ms(lambda: run(k, g, u))
                if name != "march_only":
                    out.fill_(float("nan"))
                    run(k, g, u)
                    equal[key] = bool(torch.equal(_bits(out), _bits(ref)))
    return res, equal


def _bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def probe_fwd_ch(lib, rows, density, labels, axis, march, ref, events_ms):
    """Time the joseph_fwd_ch probes (see the module docstring); ms by name
    and, by name, whether each gives the kernel's bits ``ref``."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import strides_extents

    rows = rows.contiguous()
    n = rows.shape[1]
    out = torch.empty((N_CHANNELS, n), dtype=torch.float32, device=rows.device)
    strided = strides_extents(density, axis)[:3]
    lab_strided = strides_extents(labels, axis)[:3]
    bv, bl = brick.brick_density(density), brick.brick_density(labels)
    stream = torch.cuda.current_stream().cuda_stream
    G, U = _const("joseph.cuh", "kFwdChLanes"), _const("joseph.cuh", "kFwdChSteps")

    def run(kind, layout, n_lanes, unroll):
        rc = lib.probe_fwd_ch(kind, layout, n_lanes, unroll, rows.data_ptr(), n,
                              density.data_ptr(), *strided, bv.data.data_ptr(), *bv.args(axis),
                              labels.data_ptr(), *lab_strided, bl.data.data_ptr(), *march,
                              N_CHANNELS, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"probe fwd_ch kind {kind} layout {layout} G {n_lanes} "
                               f"U {unroll}: {rc}")

    res, equal = {}, {}

    def timed(name, *variant, check=True):
        res[name] = events_ms(lambda: run(*variant))
        if check:
            out.fill_(float("nan"))
            run(*variant)
            equal[name] = bool(torch.equal(_bits(out), _bits(ref)))

    timed("parent", 4, 0, 1, 1)
    timed("thread_strided_u4", 0, 0, 1, 4)
    for u in UNROLLS:
        timed(f"thread_bricked_u{u}", 0, 1, 1, u)
    timed("thread_bricked_global_u4", 2, 1, 1, 4)
    timed("thread_bricked_shared_u4", 3, 1, 1, 4)
    for g in LANES:
        timed(f"lanes_bricked_g{g}_u1", 0, 1, g, 1)
    for u in UNROLLS[1:]:
        timed(f"lanes_bricked_g{G}_u{u}", 0, 1, G, u)
    timed(f"lanes_strided_g{G}_u{U}", 0, 0, G, U)
    timed("march_only_thread_u4", 1, 1, 1, 4, check=False)
    timed(f"march_only_g{G}_u{U}", 1, 1, G, U, check=False)
    return res, equal, f"lanes_bricked_g{G}_u{U}"


def probe_fwd_max(lib, rows, density, axis, ref, events_ms):
    """Time the siddon_fwd_max probes; ms by name and, by name, whether each
    gives the kernel's value bits and argmax ``ref``."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import strides_extents

    rows = rows.contiguous()
    n = rows.shape[1]
    val = torch.empty(n, dtype=torch.float32, device=rows.device)
    arg = torch.empty(n, dtype=torch.int32, device=rows.device)
    strided = strides_extents(density, axis)[:3]
    bv = brick.brick_density(density)
    stream = torch.cuda.current_stream().cuda_stream
    G, U = _const("siddon.cuh", "kMaxLanes"), _const("siddon.cuh", "kMaxSlabs")

    def run(kind, layout, n_lanes, unroll):
        rc = lib.probe_fwd_max(kind, layout, n_lanes, unroll, rows.data_ptr(), n,
                               density.data_ptr(), *strided, bv.data.data_ptr(), *bv.args(axis),
                               val.data_ptr(), arg.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"probe fwd_max kind {kind} layout {layout} G {n_lanes} "
                               f"U {unroll}: {rc}")

    res, equal = {}, {}

    def timed(name, *variant, check=True):
        res[name] = events_ms(lambda: run(*variant))
        if check:
            val.fill_(float("nan"))
            arg.fill_(-2)
            run(*variant)
            equal[name] = bool(torch.equal(_bits(val), _bits(ref[0])) and torch.equal(arg, ref[1]))

    timed("parent", 0, 0, 1, 1)
    for u in UNROLLS:
        timed(f"thread_bricked_u{u}", 0, 1, 1, u)
    for g in LANES:
        timed(f"lanes_bricked_g{g}_u1", 5, 1, g, 1)
    for u in UNROLLS[1:]:
        timed(f"lanes_bricked_g{G}_u{u}", 5, 1, G, u)
    timed(f"lanes_strided_g{G}_u{U}", 5, 0, G, U)
    timed("march_only_thread_u4", 1, 1, 1, 4, check=False)
    timed(f"march_only_g{G}_u{U}", 1, 1, G, U, check=False)
    return res, equal, f"lanes_bricked_g{G}_u{U}"


def _const(header, name):
    """An int constant of a header of the package timed (``constexpr int``)."""
    import re

    from diffdrr_tpu_torch.ops.kernels import build

    text = (build.CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE.parents[1],
                        help="checkout whose diffdrr_tpu_torch is timed")
    parser.add_argument("--no-probes", action="store_true", help="time the cases only")
    parser.add_argument("--storage", choices=("f32", "bf16"), default="f32",
                        help="the density's copy joseph_fwd_ch reads (bf16: storage='bf16', "
                             "joseph_fwd_ch alone, float32 beside it)")
    args = parser.parse_args(argv)
    bf16 = args.storage == "bf16"
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("max_channel_timing: no CUDA device", file=sys.stderr)
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
    print(f"[max_channel_timing] {label} ({args.storage}): package {Path(T.__file__).parent}; "
          f"{card}", flush=True)
    build.build_all()
    has_lanes = "fwd_ch_lanes" in (build.CSRC / "joseph.cuh").read_text()
    libs = (None if args.no_probes or not has_lanes
            else (load_bf16_probes if bf16 else load_probes)((2, 0)))
    attributes = bf16_attributes(libs[2]) if bf16 and libs is not None else None
    dev = torch.device("cuda")
    trans = torch.tensor(TRANS, device=dev)
    drr = T.DRR(T.load_example_ct(), sdd=1020.0, height=200, delx=2.0, renderer="trilinear")
    density, labels = drr.density, drr.mask
    cases = {}

    def timings(fn):
        def fresh():
            brick.clear_cache()
            return fn()

        return {"kernel": events_ms(fn), "burst": burst_ms(fn),
                "with_copy": events_ms(fn, brick.clear_cache), "burst_with_copy": burst_ms(fresh)}

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
        jrows = prep_rays(sv, tv, wt, axis, density.shape, quadrature="joseph", h=h)
        srows = prep_rays(sv, tv, wt, axis, density.shape)
        R = jrows.shape[1]

        def fwd_ch(*storage):
            return J.joseph_fwd_ch(jrows, density, labels, axis, h, n, N_CHANNELS, *storage)

        def fwd_max():
            return K.siddon_fwd_max(srows, density, axis)

        runs = [("joseph_fwd_ch", fwd_ch, {"h": h, "steps": n})]
        if bf16:
            runs = [("joseph_fwd_ch", lambda: fwd_ch("bf16"), {"h": h, "steps": n})]
        else:
            runs.append(("siddon_fwd_max", fwd_max, {"slabs": density.shape[axis]}))
        for name, fn, head in runs:
            c = dict(head, rays=R, axis=axis, storage=args.storage, **timings(fn))
            if bf16:
                c.update(kernel_f32=events_ms(fwd_ch), burst_f32=burst_ms(fwd_ch))
            if libs is not None:
                ref = fn()
                if bf16:
                    c["probes"], c["equal"] = bf16_probe_fwd_ch(
                        libs[axis], jrows, density, labels, axis, march, ref, events_ms)
                elif name == "joseph_fwd_ch":
                    c["probes"], c["equal"], c["shipped"] = probe_fwd_ch(
                        libs[axis], jrows, density, labels, axis, march, ref, events_ms)
                else:
                    c["probes"], c["equal"], c["shipped"] = probe_fwd_max(
                        libs[axis], srows, density, axis, ref, events_ms)
            cases[f"{name} {pose}"] = c
            print(f"[max_channel_timing] {label} {name} {pose} ({R} rays, axis {axis}, "
                  f"{args.storage}): "
                  + ", ".join(f"{k} {c[k]:.4f}" for k in ("kernel", "burst", "with_copy",
                                                          "burst_with_copy", "kernel_f32",
                                                          "burst_f32") if k in c) + " ms",
                  flush=True)
            for k, v in c.get("probes", {}).items():
                e = c["equal"].get(k)
                print(f"[max_channel_timing] {label} probe {name} {pose} {k} {v:.4f} ms"
                      + ("" if e is None else f" (equal {e})"), flush=True)
    for k, a in (attributes or {}).items():
        print(f"[max_channel_timing] {label} bf16 probe joseph_fwd_ch {k}: {a}", flush=True)
    print(json.dumps({"label": label, "card": card, "storage": args.storage, "cases": cases,
                      "bf16_attributes": attributes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
