#!/usr/bin/env python3
"""Time the two forward gathers of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/fwd_timing.py [--root DIR]
        [--no-probes | --bf16-only | --copy-only] [--case NAME ...]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
The timings go through the public wrappers ``siddon_fwd`` and
``joseph_fwd``, which every commit of the port since the Joseph kernels
has; the copy and the probes need a checkout with ``ops/kernels/brick.py``
and are skipped in one without it.

Cases, each with the march axis 2 but the lateral ones: ``siddon_fwd`` at
the recon cell's rays (8 views of 200x200 on the 512x512x133 CT) and at one
200x200 view of the main pose; ``joseph_fwd`` at the recon-CLI cell's rays
(8 views of 200x200, delx 3, on the CLI's 512x512x128 CT, trilinear h = 1)
and at the main pose's 200x200 view (h = 1); both at the lateral pose's
200x200 view (march axis 0, the CT's 512 planes; Joseph at the trilinear
stride h = 1.024, which blends two planes a sample); both on the 512^3 CT
at 200x200 and 1000x1000; and ``joseph_fwd render-b8``, the benchmark cell
``render-b8-chest512-trilinear``'s render: 8 poses at 512x512 (delx
400/512) on the 512^3 CT, each the main pose plus N(0, 0.1) rad, N(0, 15)
mm (a fixed seed), rendered by a trilinear DRR (n_points 500, h = 511/499),
whose own rows, march axis and stride ``joseph_fwd`` is timed on. For
each, median CUDA-event times (``scatter_timing.events_ms``):

  * ``kernel``: the wrapper with the density's bricked copy already made
    (in a checkout without the copy: the wrapper, which is the kernel);
  * ``with_copy``: the wrapper with the copy made anew in each call;
  * ``copy``: ``brick.brick_density`` alone (the ``brick_copy`` kernel), and
    ``copy_plain``: its plain version (strided PyTorch copies);
  * ``f32_bf16``: in a checkout with bf16 storage, the wrapper on the float32
    copy and on the bf16 one (``storage="bf16"``), in turns f32, bf16, bf16,
    f32, the copies cached.

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

Order probes (the 4x4x4 build, every Joseph case; with the float32 probes;
a checkout whose ``csrc/joseph.cuh`` has ``trace_fwd_raw``): the float32
forward on the bricked copy with its windows loaded raw before any is
lerped (``raw_u<U>``, the kernel's order in blend mode) and in window()'s
order, each plane pair lerped as its loads land (``window_u<U>``, its
order at an integer h), at U = 1, 2 and 4 steps in flight, each also with
the rays taken in 8x4 detector patches (``raw_patch_u<U>``,
``window_patch_u<U>``) where the rays are whole views; ``same_bits``:
every variant's output equal to ``raw_u1``'s bit for bit.

bf16 probes (the 4x4x4 build's ``probe_*_fwd_bf16``, on the bf16 copy, at
every case but the cube at 200x200; ``--bf16-only`` runs these and the
cases without the float32 probes): the forward at 1, 2, 4 and 8 slabs
(steps) in flight as the package builds it (reads kept raw until the
sums), as the first bf16 build had it (each read widened where it lands),
and with its raw reads made by a branch around each load or by a
predicated load in inline PTX; and the raw loads only, where the float32
probe has them.

Copy cases (the bricked copy alone, ``--copy-only`` runs these and
nothing else): a density of uniform random values made on the card from a
seed (a copy's time does not depend on them) at 512x512x133 (the main CT;
the lateral pose renders the same CT), in Fortran order (permuted: the
general path), narrowed along axis 0 to 256 planes (a slab, packed) and
along axis 2 to 128 of its 133 (general), at 512x512x128 (the CLI's CT)
and 512^3 (the cube). For each, in float32 and bf16, through
``brick_probes.cu`` next to this file (C entry points called directly, so
no launch counter moves and no wrapper host work is timed; each output
held bit for bit against the package's): ``abba``, the parent's kernel
(``brick_parent.cu``) and the package's ``brick_copy``
(``brick_copy_bf16``; either path) in turns parent, package, package,
parent; the packed path at other thread counts and loads in flight, its
spans by ``cp.async.bulk`` one block a column and in a persistent block
with two tiles, its reads alone and its writes alone; the general path
(each element loaded through the strides) on every density, consecutive
threads along axis 2 at 128 and 256 threads and 8 and 16 loads in flight,
and along the column's rows. Beside them ``wrapper``, ``brick_density`` (a
call's host work included), and the yardsticks ``torch.Tensor.clone()``
(the same bytes moved) and, at whole-brick extents, the one PyTorch call of
each copy, ``view(n0, 4, n1, 4, n2, 4).permute(0, 2, 4, 1, 3, 5)`` then
``.contiguous()`` or ``.to(torch.bfloat16, memory_format=
torch.contiguous_format)``, each held bit for bit against the package's
copy; the byte bounds (the density read once, the copy written once, at
3.35 TB/s). A checkout without ``brick.packed_path`` (one before the
packed path) is timed through ``brick_density`` alone.

``--case NAME`` (repeatable) times only the cases whose name contains one
of the NAMEs, and no copy cases.

Prints one line per case and, last, one JSON object with every number and
the card (``nvidia-smi`` name and power limit). Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

BENCH_ROT = [[0.01, 3.141592653589793 / 2 + 0.02, -0.01]]
BENCH_TRANS = [[0.0, 850.0, 0.0]]
N_VIEWS = 8
KW = dict(parameterization="euler_angles", convention="ZXY")
PROBE_BRICKS = ((4, 4, 2), (4, 4, 4), (2, 2, 8), (2, 4, 4), (1, 4, 8), (8, 4, 1))
# The lateral pose (chip_smoke.LATERAL_ROT): march axis 0.
LATERAL_ROT = [[3.141592653589793 / 2 + 0.02, 0.01, -0.01]]
# fwd_probes.cu's bf16 variants, by its numbering.
BF16_VARIANTS = ("package", "widened", "raw_branch", "raw_predicated")
BF16_UNROLLS = (1, 2, 4, 8)
# brick_probes.cu's variants, by its numbering.
COPY_VARIANTS = ("parent", "packed", "packed_t256_b4", "packed_t128_b4", "packed_t64_b8",
                 "bulk", "bulk_persistent", "reads_only", "writes_only", "package",
                 "general_z", "general_z_t256", "general_z_b16", "general_rows")
# The variants that need the packed path, and those whose output is the copy
# (the others probe its halves).
COPY_PACKED_ONLY = COPY_VARIANTS[1:9]
COPY_OUTPUTS = tuple(v for v in COPY_VARIANTS if v not in ("reads_only", "writes_only"))
HBM_BYTES_PER_S = 3.35e12
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
        # the headers, and the sources a probe may include (brick_probes.cu:
        # brick_parent.cu, brick.cu)
        for path in sorted(build.CSRC.glob("*.cu*")) + sorted(src.parent.glob("*.cu")):
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


def build_probes(shapes=PROBE_BRICKS):
    """Build fwd_probes.cu once for each brick shape of ``shapes``
    (brick.cuh's BRICK_L0..L2 given with -D); the loaded libraries by shape."""
    outs = build_sources(HERE / "fwd_probes.cu",
                         [[f"-DBRICK_L{d}={b.bit_length() - 1}" for d, b in enumerate(shape)]
                          for shape in shapes])
    libs = {}
    v, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    head = [i32, i32, i32, v, i64, v, i64, i64, i64, v] + [i32] * 7
    for shape, out in zip(shapes, outs):
        lib = ctypes.CDLL(str(out))
        lib.probe_siddon_fwd.argtypes = head + [v, v]
        lib.probe_joseph_fwd.argtypes = head + [ctypes.c_float, i32, i32, v, v]
        lib.probe_siddon_fwd.restype = lib.probe_joseph_fwd.restype = i32
        if shape == (4, 4, 4):  # the kernels' own shape's build has the bf16 probes
            bf = [i32, i32, i32, v, i64, v] + [i32] * 7
            lib.probe_siddon_fwd_bf16.argtypes = bf + [v, v]
            lib.probe_joseph_fwd_bf16.argtypes = bf + [ctypes.c_float, i32, i32, v, v]
            lib.probe_siddon_fwd_bf16.restype = lib.probe_joseph_fwd_bf16.restype = i32
        libs[shape] = lib
    return libs


def build_copy_probes(name="brick_probes"):
    """``name``.cu next to this file (brick_probes.cu, or brick_parent.cu:
    the parent's kernel and the package's copy alone) built and loaded, its
    C entry points typed."""
    lib = ctypes.CDLL(str(build_sources(HERE / f"{name}.cu", [[]])[0]))
    v, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in ("probe_brick_copy", "probe_brick_copy_parent"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [i32, i32, v, i64, i64, i64, i32, i32, i32, v, v]
            getattr(lib, fn).restype = i32
    return lib


def brick_library_calls(density):
    """The one PyTorch call of the float32 copy and of the bf16 copy of
    ``density`` (view, permute, and contiguous or a rounding to contiguous
    bf16), or None where its extents are not whole bricks."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick

    if any(e % b for e, b in zip(density.shape, brick.BRICK)):
        return None
    split = [m for e, b in zip(density.shape, brick.BRICK) for m in (e // b, b)]
    return {"f32": lambda: density.view(split).permute(0, 2, 4, 1, 3, 5).contiguous(),
            "bf16": lambda: density.view(split).permute(0, 2, 4, 1, 3, 5).to(
                torch.bfloat16, memory_format=torch.contiguous_format)}


def copy_densities(seed=18):
    """The copy cases' densities by name (see the module docstring)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ct = torch.rand((512, 512, 133), generator=gen, device="cuda")
    return {"main 512x512x133": ct,
            "permuted": ct.permute(2, 1, 0).contiguous().permute(2, 1, 0),
            "slab axis 0": ct.narrow(0, 128, 256),
            "narrowed axis 2": ct.narrow(2, 0, 128),
            "cli 512x512x128": torch.rand((512, 512, 128), generator=gen, device="cuda"),
            "cube 512^3": torch.rand((512, 512, 512), generator=gen, device="cuda")}


def copy_case(lib, density, events_ms):
    """The copy cases' numbers for one density (see the module docstring);
    ``lib``: the probes, or None (a checkout before the packed path)."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick

    ext = tuple(density.shape)
    n_pad = 1
    for e, b in zip(ext, brick.BRICK):
        n_pad *= -(-e // b) * b
    res = {"packed": None if lib is None else brick.packed_path(density),
           "bound_f32": (4 * density.numel() + 4 * n_pad) / HBM_BYTES_PER_S * 1e3,
           "bound_bf16": (4 * density.numel() + 2 * n_pad) / HBM_BYTES_PER_S * 1e3,
           "clone": events_ms(density.clone)}
    library = brick_library_calls(density)
    stream = torch.cuda.current_stream().cuda_stream
    for storage in (None, "bf16"):
        key = storage or "f32"

        def package():
            return brick.brick_density(density, storage)

        if lib is None:
            res[key] = {"wrapper": events_ms(package)}
            continue
        ref = package().data
        buf = torch.empty_like(ref)
        bits = torch.int16 if storage else torch.int32
        if library is not None:
            if not torch.equal(library[key]().view(bits), ref.view(bits)):
                raise AssertionError(f"the library call's {key} copy differs on {ext}")
            res[f"library_{key}"] = events_ms(library[key])

        def probe(k):
            rc = lib.probe_brick_copy(k, int(storage is not None), density.data_ptr(),
                                      *density.stride(), *ext, buf.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"copy probe {COPY_VARIANTS[k]} failed: {rc}")

        package_k = COPY_VARIANTS.index("package")
        t = {"abba": [events_ms(lambda: probe(0)), events_ms(lambda: probe(package_k)),
                      events_ms(lambda: probe(package_k)), events_ms(lambda: probe(0))],
             "wrapper": events_ms(package)}
        for k, name in enumerate(COPY_VARIANTS):
            if name in COPY_PACKED_ONLY and not res["packed"]:
                continue
            if name.startswith("general_") and ext[2] > 1024:
                continue  # these probes take axis 2 in one chunk
            buf.fill_(-7.0)
            probe(k)
            torch.cuda.synchronize()
            if name in COPY_OUTPUTS and not torch.equal(buf.view(bits), ref.view(bits)):
                raise AssertionError(f"copy probe {name} differs from brick_copy on {ext}")
            t[name] = events_ms(lambda: probe(k))
        res[key] = t
    brick.clear_cache()
    return res


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


def order_probe_case(lib, rows, density, axis, march, events_ms, side):
    """Time the float32 Joseph forward's load orders on the 4x4x4 bricked
    copy (see the module docstring); ms by name, and ``same_bits``."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick

    rows = rows.contiguous()
    n = rows.shape[1]
    bv = brick_copy(density, brick.BRICK)
    orders = {"raw": rows}
    if n % (side * side) == 0:
        orders["patch"] = rows[:, patch_order(n, side, side).to(rows.device)].contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def run(kind, unroll, order):
        out = outs.setdefault((kind, unroll, order),
                              torch.empty(n, dtype=torch.float32, device=rows.device))
        r = orders[order]
        rc = lib.probe_joseph_fwd(1, kind, unroll, r.data_ptr(), n, density.data_ptr(), 0, 0, 0,
                                  bv.data.data_ptr(), *bv.args(axis), *march, out.data_ptr(),
                                  stream)
        if rc != 0:
            raise RuntimeError(f"order probe {kind}/{unroll}/{order} failed: {rc}")

    res = {}
    for u in (1, 2, 4):
        for kind, name in ((3, "raw"), (0, "window")):
            for order in orders:
                key = f"{name}_u{u}" if order == "raw" else f"{name}_patch_u{u}"
                res[key] = events_ms(lambda: run(kind, u, order))
    torch.cuda.synchronize()
    if "patch" in orders:  # back to row order: the patch permutation's inverse
        inv = torch.argsort(patch_order(n, side, side)).to(rows.device)
        for key in [k for k in outs if k[2] == "patch"]:
            outs[key] = outs[key][inv]
    ref = outs[(3, 1, "raw")]
    res["same_bits"] = all(torch.equal(o.view(torch.int32), ref.view(torch.int32))
                           for o in outs.values())
    return res


def bf16_probe_case(lib, family, rows, density, axis, march, events_ms):
    """Time fwd_probes.cu's bf16 probes on ``density``'s bf16 copy (see the
    module docstring); ms by name: ``<variant>_u<U>`` and ``loads_only_u<U>``
    (integer h only), and ``max_abs_diff``, the largest difference of any
    variant's output from the package's at U = 8 (0: the same sums)."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick

    rows = rows.contiguous()
    n = rows.shape[1]
    bv = brick.brick_density(density, "bf16")
    outs = {}
    stream = torch.cuda.current_stream().cuda_stream

    def run(variant, kind, unroll):
        out = outs.setdefault((variant, kind, unroll),
                              torch.empty(n, dtype=torch.float32, device=rows.device))
        fn = lib.probe_siddon_fwd_bf16 if family == "siddon" else lib.probe_joseph_fwd_bf16
        rc = fn(variant, kind, unroll, rows.data_ptr(), n, bv.data.data_ptr(), *bv.args(axis),
                *march, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bf16 probe {family} {variant}/{kind}/{unroll} failed: {rc}")

    res = {}
    for u in BF16_UNROLLS:
        for k, name in enumerate(BF16_VARIANTS):
            res[f"{name}_u{u}"] = events_ms(lambda: run(k, 0, u))
        if family == "siddon" or not march[2]:
            res[f"loads_only_u{u}"] = events_ms(lambda: run(0, 2, u))
    own = outs[(0, 0, BF16_UNROLLS[-1])]
    res["max_abs_diff"] = max(float((out - own).abs().max())
                              for (_, kind, _), out in outs.items() if kind == 0)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE.parents[1],
                        help="checkout whose diffdrr_tpu_torch is timed")
    parser.add_argument("--no-probes", action="store_true", help="time the cases only")
    parser.add_argument("--bf16-only", action="store_true",
                        help="time the cases and the bf16 probes, not the float32 probes")
    parser.add_argument("--copy-only", action="store_true",
                        help="time the copy cases alone, with their probes")
    parser.add_argument("--case", action="append", default=[],
                        help="time only the cases whose name contains this (repeatable)")
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
    copies = {}
    if brick is not None and not args.bf16_only and not args.case:
        copy_lib = (None if args.no_probes or not hasattr(brick, "packed_path")
                    else build_copy_probes())
        for name, density in copy_densities().items():
            c = copies[name] = copy_case(copy_lib, density, events_ms)
            print(f"[fwd_timing] {label} copy {name}: "
                  + "; ".join(f"{k} {v}" for k, v in c.items()), flush=True)
        if args.copy_only:
            print(json.dumps({"label": label, "card": card, "copies": copies}), flush=True)
            return 0
    libs = (None if args.no_probes or brick is None
            else build_probes(((4, 4, 4),) if args.bf16_only else PROBE_BRICKS))
    # bf16 storage: the wrappers take storage= and the 4x4x4 build has the bf16 probes
    bf16 = brick is not None and "storage" in inspect.signature(K.siddon_fwd).parameters
    grid_sample_ms = smoke_module().grid_sample_ms
    dev = torch.device("cuda")
    thetas = np.linspace(0, np.pi, N_VIEWS, endpoint=False)
    rot_v = torch.tensor(np.stack([thetas, np.full(N_VIEWS, np.pi / 2), np.zeros(N_VIEWS)], 1),
                         dtype=torch.float32, device=dev)
    trans_v = torch.tensor(BENCH_TRANS * N_VIEWS, device=dev)
    rot0 = torch.tensor(BENCH_ROT, device=dev)
    trans0 = torch.tensor(BENCH_TRANS, device=dev)

    def rows_of(drr, rot, trans, axis=2, **prep):
        src, tgt = drr.detector(T.convert(rot, trans, **KW))
        w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
        return prep_rays(drr.affine_inverse(src), drr.affine_inverse(tgt), w, axis,
                         drr.density.shape, **prep)

    cases = {}

    def case(name, family, rows, density, march=(), probes=False, library=False, side=200,
             axis=2, bf16_probes=True):
        if args.case and not any(c in name for c in args.case):
            return
        def fwd(*storage):
            if family == "siddon":
                return K.siddon_fwd(rows, density, axis, *storage)
            return J.joseph_fwd(rows, density, axis, *march[:2], *storage)

        c = {"rays": rows.shape[1], "kernel": events_ms(fwd)}
        if brick is not None:
            c["with_copy"] = events_ms(fwd, brick.clear_cache)
            c["copy"] = events_ms(lambda: brick.brick_density(density))
            c["copy_plain"] = events_ms(lambda: brick.brick_density_plain(density))
            brick.clear_cache()
        if bf16:
            c["f32_bf16"] = [events_ms(lambda: fwd(s)) for s in (None, "bf16", "bf16", None)]
        if probes and libs is not None and not args.bf16_only:
            c["probes"] = probe_case(libs, family, rows, density, axis, march, events_ms, side)
        if (family == "joseph" and libs is not None and not args.bf16_only
                and "trace_fwd_raw" in (build.CSRC / "joseph.cuh").read_text()):
            c["order_probes"] = order_probe_case(libs[(4, 4, 4)], rows, density, axis, march,
                                                 events_ms, side)
        if bf16 and bf16_probes and libs is not None:
            c["bf16_probes"] = bf16_probe_case(libs[(4, 4, 4)], family, rows, density, axis,
                                               march, events_ms)
        if library:
            c["grid_sample"] = grid_sample_ms(rows, density, axis, *march[:2], events_ms)
        if brick is not None:
            brick.clear_cache()
        cases[name] = c
        extra = "".join(f", {k} {v:.4f}" for k, v in c.items()
                        if k in ("with_copy", "copy", "copy_plain", "grid_sample"))
        if "f32_bf16" in c:
            extra += ", f32/bf16/bf16/f32 " + " ".join(f"{v:.4f}" for v in c["f32_bf16"])
        print(f"[fwd_timing] {label} {name} ({c['rays']} rays): kernel {c['kernel']:.4f} ms"
              + extra, flush=True)
        for group in ("probes", "order_probes", "bf16_probes"):
            for k, v in c.get(group, {}).items():
                print(f"[fwd_timing] {label} {group[:-1]} {name} {k} {v:.4g}", flush=True)

    main_ct = T.load_example_ct()
    drr = T.DRR(main_ct, sdd=1020.0, height=200, delx=2.0)
    case("siddon_fwd recon", "siddon", rows_of(drr, rot_v, trans_v), drr.density, probes=True)
    case("siddon_fwd 200^2", "siddon", rows_of(drr, rot0, trans0), drr.density, probes=True)
    X = drr.density.shape[2]
    case("joseph_fwd 200^2", "joseph", rows_of(drr, rot0, trans0, quadrature="joseph", h=1.0),
         drr.density, (1.0, X, 0), probes=True)
    rot_l = torch.tensor(LATERAL_ROT, device=dev)
    case("siddon_fwd lateral 200^2", "siddon", rows_of(drr, rot_l, trans0, 0), drr.density,
         axis=0)
    h_l, n_l = raymarch_steps(drr.density.shape[0], 500)  # the trilinear stride, 1.024
    case("joseph_fwd lateral 200^2", "joseph",
         rows_of(drr, rot_l, trans0, 0, quadrature="joseph", h=h_l),
         drr.density, (h_l, n_l, int(J.is_blend(h_l))), axis=0)
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
             probes=side == 1000, side=side, bf16_probes=side == 1000)
        case(f"joseph_fwd cube {side}^2", "joseph",
             rows_of(drr_c, rot0, trans0, quadrature="joseph", h=1.0), drr_c.density,
             (1.0, 512, 0), probes=side == 1000, side=side, bf16_probes=side == 1000)
    render_b8(T, J, dev, case)
    print(json.dumps({"label": label, "card": card, "cases": cases, "copies": copies}),
          flush=True)
    return 0


def render_b8(T, J, dev, case):
    """The ``joseph_fwd render-b8`` case (see the module docstring): the
    rows, march axis and stride that a trilinear DRR's render of the poses
    hands ``joseph_fwd``, caught on the way in."""
    import numpy as np
    import torch

    rng = np.random.default_rng(8)
    rot = torch.tensor(np.array([[0.0, np.pi / 2, 0.0]]) + rng.normal(0.0, 0.1, (8, 3)),
                       dtype=torch.float32, device=dev)
    trans = torch.tensor(np.array(BENCH_TRANS) + rng.normal(0.0, 15.0, (8, 3)),
                         dtype=torch.float32, device=dev)
    cube = T.load_example_ct(shape=(512, 512, 512), spacing=(0.703125,) * 3)
    drr = T.DRR(cube, sdd=1020.0, height=512, delx=400 / 512, renderer="trilinear")
    got, march = {}, J.JosephMarch

    class Spy:  # joseph_march_raycast calls JosephMarch.apply by its module's name
        @staticmethod
        def apply(density, rows, axis, h, n_steps, *rest):
            got.update(rows=rows.detach().clone(), axis=axis, h=h, n=n_steps)
            return march.apply(density, rows, axis, h, n_steps, *rest)

    J.JosephMarch = Spy
    try:
        with torch.no_grad():
            drr(rot, trans, **KW)
    finally:
        J.JosephMarch = march
    case("joseph_fwd render-b8", "joseph", got["rows"], drr.density,
         (got["h"], got["n"], int(J.is_blend(got["h"]))), side=512, axis=got["axis"])


if __name__ == "__main__":
    sys.exit(main())
