#!/usr/bin/env python3
"""Time the two forward gathers of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/fwd_timing.py [--root DIR] [--no-probes]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrappers ``siddon_fwd`` and
``joseph_fwd``, which every commit of the port since the Joseph kernels
has; the copy and the probes need a checkout with ``ops/kernels/brick.py``
and are skipped in one without it.

Cases, each with the march axis 2: ``siddon_fwd`` at the recon cell's rays
(8 views of 200x200 on the 512x512x133 CT) and at one 200x200 view of the
main pose; ``joseph_fwd`` at the recon-CLI cell's rays (8 views of 200x200,
delx 3, on the CLI's 512x512x128 CT, trilinear h = 1) and at the main pose's
200x200 view (h = 1); both on the 512^3 CT at 200x200 and 1000x1000. For
each, median CUDA-event times (``scatter_timing.events_ms``):

  * ``kernel``: the wrapper with the density's bricked copy already made
    (in a checkout without the copy: the wrapper, which is the kernel);
  * ``with_copy``: the wrapper with the copy made anew in each call;
  * ``copy``: ``brick.brick_density`` alone (the ``brick_copy`` kernel), and
    ``copy_plain``: its plain version (strided PyTorch copies).

Probes (built from ``fwd_probes.cu`` next to this file, on the recon
cells, the main pose and the cube at 1000x1000, C entry points called
directly, so no launch counter moves): the strided kernel the bricked one
replaced, and strided with 2 and 4 slabs (steps) in flight; the bricked
kernel with 1, 2 and 4 in flight on bricks of 4x4x2, 4x4x4, 2x2x8, 2x4x4,
1x4x8 and 8x4x1 (voxels along the density's axes 0, 1, 2; the march runs
along axis 2), each shape a build of its own since the kernels take it at
compile time; the march without loads; the loads only (strided and
bricked); the rays taken in 8x4 detector patches instead of rows of 32; and,
for Joseph at the recon-CLI's rays, ``F.grid_sample`` (trilinear, zero
padding) over the same sample points (``chip_smoke.grid_sample_ms`` of the
checkout that holds this file).

Prints one line per case and, last, one JSON object with every number and
the card (``nvidia-smi`` name and power limit). Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BENCH_ROT = [[0.01, 3.141592653589793 / 2 + 0.02, -0.01]]
BENCH_TRANS = [[0.0, 850.0, 0.0]]
N_VIEWS = 8
KW = dict(parameterization="euler_angles", convention="ZXY")
PROBE_BRICKS = ((4, 4, 2), (4, 4, 4), (2, 2, 8), (2, 4, 4), (1, 4, 8), (8, 4, 1))
HERE = Path(__file__).resolve().parent


def build_sources(src, define_sets):
    """Build the probe source ``src`` with the package's nvcc flags and
    -I csrc once for each list of -D defines in ``define_sets``, all nvcc
    processes at once, into the package's build directory (reused while the
    source, the headers and the defines are unchanged); the libraries'
    paths in the same order."""
    from diffdrr_tpu_torch.ops.kernels import build

    outs, procs = [], []
    for defines in define_sets:
        h = hashlib.sha256(" ".join([*build.NVCC_FLAGS, *defines]).encode() + src.read_bytes())
        for path in sorted(build.CSRC.glob("*.cuh")):
            h.update(path.read_bytes())
        out = build.BUILD_ROOT / f"probes-{h.hexdigest()[:16]}" / f"lib{src.stem}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            procs.append(subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *defines,
                                           f"-I{build.CSRC}", "-o", str(out), str(src)]))
        outs.append(out)
    for p in procs:
        if p.wait(timeout=600) != 0:
            raise RuntimeError(f"nvcc failed on {src}: {p.args}")
    return outs


def build_probes():
    """Build fwd_probes.cu once for each brick shape of PROBE_BRICKS
    (brick.cuh's BRICK_L0..L2 given with -D); the loaded libraries by shape."""
    outs = build_sources(HERE / "fwd_probes.cu",
                         [[f"-DBRICK_L{d}={b.bit_length() - 1}" for d, b in enumerate(shape)]
                          for shape in PROBE_BRICKS])
    libs = {}
    v, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    head = [i32, i32, i32, v, i64, v, i64, i64, i64, v] + [i32] * 7
    for shape, out in zip(PROBE_BRICKS, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_siddon_fwd.argtypes = head + [v, v]
        lib.probe_joseph_fwd.argtypes = head + [ctypes.c_float, i32, i32, v, v]
        lib.probe_siddon_fwd.restype = lib.probe_joseph_fwd.restype = i32
        libs[shape] = lib
    return libs


def brick_copy(density, shape):
    """The bricked copy of ``density`` in bricks of ``shape`` (the layout of
    brick.brick_density_plain, for any shape a probe is built with)."""
    import torch.nn.functional as F

    from diffdrr_tpu_torch.ops.kernels import brick

    pad = [-e % b for e, b in zip(density.shape, shape)]
    padded = F.pad(density, (0, pad[2], 0, pad[1], 0, pad[0]))
    split = [m for e, p, b in zip(density.shape, pad, shape) for m in ((e + p) // b, b)]
    data = padded.reshape(split).permute(0, 2, 4, 1, 3, 5).contiguous()
    return brick.BrickedDensity(data, tuple(density.shape))


def smoke_module():
    """chip_smoke.py of the checkout that holds this file (for its
    yardsticks), loaded without leaving its directory on sys.path, so the
    package timed stays the one under --root."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = saved
    return mod


def patch_order(n_rays, height, width):
    """The permutation that takes each view's rays in 8x4 pixel patches (8
    along a row, 4 rows) instead of row-major order."""
    import torch

    b, i, j = torch.meshgrid(torch.arange(n_rays // (height * width)), torch.arange(height),
                             torch.arange(width), indexing="ij")
    key = (((b * (height // 4) + i // 4) * (width // 8) + j // 8) * 32
           + (i % 4) * 8 + j % 8)
    return torch.argsort(key.reshape(-1))


def probe_case(libs, family, rows, density, axis, march, events_ms, side=200):
    """Time the probe variants (see the module docstring); ms by name."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels._launch import strides_extents

    rows = rows.contiguous()
    n = rows.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=rows.device)
    strided = strides_extents(density, axis)[:3]
    copies = {b: brick_copy(density, b) for b in PROBE_BRICKS}
    stream = torch.cuda.current_stream().cuda_stream

    def run(layout, kind, unroll, b=brick.BRICK, r=rows):
        bv = copies[b]
        lib = libs[b]
        fn = lib.probe_siddon_fwd if family == "siddon" else lib.probe_joseph_fwd
        rc = fn(layout, kind, unroll, r.data_ptr(), n, density.data_ptr(), *strided,
                bv.data.data_ptr(), *bv.args(axis), *march, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"probe {family} {layout}/{kind}/{unroll} failed: {rc}")

    res = {}
    for u in (1, 2, 4):
        res[f"strided_u{u}"] = events_ms(lambda: run(0, 0, u))
        for b in PROBE_BRICKS:
            res[f"bricked_{'x'.join(map(str, b))}_u{u}"] = events_ms(lambda: run(1, 0, u, b))
    res["march_only"] = events_ms(lambda: run(1, 1, 2))
    res["loads_only_strided"] = events_ms(lambda: run(0, 2, 2))
    res["loads_only_bricked"] = events_ms(lambda: run(1, 2, 2))
    if n % (side * side) == 0:
        patched = rows[:, patch_order(n, side, side).to(rows.device)].contiguous()
        res["bricked_patch_order"] = events_ms(lambda: run(1, 0, 2, r=patched))
        res["strided_patch_order"] = events_ms(lambda: run(0, 0, 1, r=patched))
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE.parents[1],
                        help="checkout whose diffdrr_tpu_torch is timed")
    parser.add_argument("--no-probes", action="store_true", help="time the cases only")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("fwd_timing: no CUDA device", file=sys.stderr)
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
    print(f"[fwd_timing] {label}: package {Path(T.__file__).parent}; {card}", flush=True)
    build.build_all()
    libs = None if args.no_probes or brick is None else build_probes()
    grid_sample_ms = smoke_module().grid_sample_ms
    dev = torch.device("cuda")
    thetas = np.linspace(0, np.pi, N_VIEWS, endpoint=False)
    rot_v = torch.tensor(np.stack([thetas, np.full(N_VIEWS, np.pi / 2), np.zeros(N_VIEWS)], 1),
                         dtype=torch.float32, device=dev)
    trans_v = torch.tensor(BENCH_TRANS * N_VIEWS, device=dev)
    rot0 = torch.tensor(BENCH_ROT, device=dev)
    trans0 = torch.tensor(BENCH_TRANS, device=dev)

    def rows_of(drr, rot, trans, **prep):
        src, tgt = drr.detector(T.convert(rot, trans, **KW))
        w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
        return prep_rays(drr.affine_inverse(src), drr.affine_inverse(tgt), w, 2,
                         drr.density.shape, **prep)

    cases = {}

    def case(name, family, rows, density, march=(), probes=False, library=False, side=200):
        def fwd():
            if family == "siddon":
                return K.siddon_fwd(rows, density, 2)
            return J.joseph_fwd(rows, density, 2, *march[:2])

        c = {"rays": rows.shape[1], "kernel": events_ms(fwd)}
        if brick is not None:
            c["with_copy"] = events_ms(fwd, brick.clear_cache)
            c["copy"] = events_ms(lambda: brick.brick_density(density))
            c["copy_plain"] = events_ms(lambda: brick.brick_density_plain(density))
            brick.clear_cache()
        if probes and libs is not None:
            c["probes"] = probe_case(libs, family, rows, density, 2, march, events_ms, side)
        if library:
            c["grid_sample"] = grid_sample_ms(rows, density, 2, *march[:2], events_ms)
        cases[name] = c
        extra = "".join(f", {k} {v:.4f}" for k, v in c.items()
                        if k in ("with_copy", "copy", "copy_plain", "grid_sample"))
        print(f"[fwd_timing] {label} {name} ({c['rays']} rays): kernel {c['kernel']:.4f} ms"
              + extra, flush=True)
        for k, v in c.get("probes", {}).items():
            print(f"[fwd_timing] {label} probe {name} {k} {v:.4f} ms", flush=True)

    main_ct = T.load_example_ct()
    drr = T.DRR(main_ct, sdd=1020.0, height=200, delx=2.0)
    case("siddon_fwd recon", "siddon", rows_of(drr, rot_v, trans_v), drr.density, probes=True)
    case("siddon_fwd 200^2", "siddon", rows_of(drr, rot0, trans0), drr.density, probes=True)
    X = drr.density.shape[2]
    case("joseph_fwd 200^2", "joseph", rows_of(drr, rot0, trans0, quadrature="joseph", h=1.0),
         drr.density, (1.0, X, 0), probes=True)
    del drr, main_ct
    cli_ct = T.load_example_ct(shape=(512, 512, 128))  # the CLI's --volume-size 512
    drr_t = T.DRR(cli_ct, sdd=1020.0, height=200, delx=3.0, renderer="trilinear")
    h, n = raymarch_steps(drr_t.density.shape[2], 500)  # the CLI's trilinear n_points
    case("joseph_fwd recon-CLI", "joseph",
         rows_of(drr_t, rot_v, trans_v, quadrature="joseph", h=h), drr_t.density,
         (h, n, int(J.is_blend(h))), probes=True, library=True)
    del drr_t, cli_ct
    cube = T.load_example_ct(shape=(512, 512, 512), spacing=(0.703125,) * 3)
    for side, delx in ((200, 2.0), (1000, 0.4)):
        drr_c = T.DRR(cube, sdd=1020.0, height=side, delx=delx)
        case(f"siddon_fwd cube {side}^2", "siddon", rows_of(drr_c, rot0, trans0), drr_c.density,
             probes=side == 1000, side=side)
        case(f"joseph_fwd cube {side}^2", "joseph",
             rows_of(drr_c, rot0, trans0, quadrature="joseph", h=1.0), drr_c.density,
             (1.0, 512, 0), probes=side == 1000, side=side)
    print(json.dumps({"label": label, "card": card, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
