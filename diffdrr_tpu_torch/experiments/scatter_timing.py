#!/usr/bin/env python3
"""Time the two density-gradient scatters of a checkout on one CUDA card.

    python3 diffdrr_tpu_torch/experiments/scatter_timing.py [--root DIR]

Imports ``diffdrr_tpu_torch`` from ``DIR`` (default: the checkout that holds
this file), so one card can time two commits in turns: unpack each into a
directory and run this file once per directory, in the order A, B, B, A.
It uses only what every commit of the port since the Joseph kernels has:
the public wrappers, ``ops/kernels/_launch.call`` and the C entry points.

Cases, all on the example CT: ``siddon_bwd_vol`` at the recon cell's rays
(8 views of 200x200 on the 512x512x133 CT, march axis 2), ``joseph_bwd_vol``
at the recon-CLI cell's rays (8 views of 200x200, delx 3, on the CLI's
512x512x128 CT, trilinear h = 1, axis 2), and each at one 200x200 view of
the main pose with the march axis pinned to 0 (Joseph at h = 4). For each:

  * ``alone``: CUDA events around one launch of the C entry point into a
    preallocated gradient, zeroed before each launch outside the events;
  * ``wrapper``: CUDA events around the wrapper call, its zero fill and
    allocation included (what ``chip_smoke.py`` times);
  * ``fill``: CUDA events around ``torch.zeros`` of the gradient alone;
  * ``profiled``: the device time per wrapper call by kernel name, from
    ``torch.profiler`` over a few wrapper calls, and the share of the
    window the device was busy;
  * at axis 0 also ``scratch``: the kernel into a scratch gradient laid out
    with the march axis innermost (unit stride), then one copy back to the
    density's contiguous layout, all inside the events.

The two reconstruction cases are also timed alone on altered rays, to see
what bounds the scatter: ``march`` (each ray moved far outside the volume
across the march: the same march, no atomic), ``parallel`` (each ray held
at its middle transverse position, so all its adds fall in one column),
``shuffled`` (the rays in a random order) and ``tiled`` (the rays ordered
by the 16 x 16 voxel tile their middle lies in, so that the rays of all
views through one region of the volume run together). For the rays as
they are and for the parallel ones it also counts the atomic adds and the
32-byte sectors they fall in per warp instruction (``_requests``), as a
coalescer that merges the lanes of an instruction by sector issues them.

Prints one line per case and, last, one JSON object with every number and
the card (``nvidia-smi`` name and power limit). Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BENCH_ROT = [[0.01, 3.141592653589793 / 2 + 0.02, -0.01]]
BENCH_TRANS = [[0.0, 850.0, 0.0]]
N_VIEWS = 8
REPS = 20
KW = dict(parameterization="euler_angles", convention="ZXY")


def events_ms(fn, before=None):
    """Median CUDA-event time of ``fn`` over REPS calls; ``before`` runs
    ahead of each call, outside the events."""
    import torch

    for _ in range(2):
        if before is not None:
            before()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn, n=5):
    """(device ms per call by kernel name, device busy share of the window)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return by_name, sum(by_name.values()) * n / wall_ms


def _requests(ray, instr, addr, n_sec, order, n_pass):
    """Sector requests of three lane mappings, from every atomic add's ray,
    its instruction ``instr`` (warp, step, slot) one thread per ray, its
    address, its place ``order`` (step, slot) along the ray and its pass
    ``n_pass`` (32 steps) one warp per ray: ``thread_per_ray``;
    ``warp_per_slot``, one instruction per pass and slot; ``warp_path_order``,
    a pass's adds in path order, 32 an instruction (the kernels' mapping)."""
    import torch

    group = ray * 64 + n_pass
    idx = torch.argsort(group * (1 << 27) + order)
    _, counts = torch.unique_consecutive(group[idx], return_counts=True)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.empty_like(idx)
    rank[idx] = torch.arange(idx.numel(), device=idx.device) - starts

    def n_requests(instruction):
        return torch.unique(instruction * n_sec + addr // 8).numel()

    return {"atomics": ray.numel(), "requests_thread_per_ray": n_requests(instr),
            "requests_warp_per_slot": n_requests(group * 64 + order % 8),
            "requests_warp_path_order": n_requests(group * 64 + rank // 32)}


def siddon_requests(rows, g, shape, axis):
    """Sector requests of siddon_bwd_vol's atomic adds on a contiguous
    gradient (``_requests``); a slab's segments are slots 0..2."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    perm = march_perm(axis)
    X, Y, Z = (shape[p] for p in perm)
    strides = _contig_strides(shape)
    ss, sy, sz = (strides[p] for p in perm)
    r = K._rows_dict(rows)
    u0, u1 = (r["amin"] - r["b"]) / r["a"], (r["amax"] - r["b"]) / r["a"]
    lo = torch.clamp(torch.floor(torch.minimum(u0, u1) + 0.5) - 1, 0, X).long()
    ray = torch.arange(rows.shape[1], device=rows.device)
    cols = {k: [] for k in ("ray", "instr", "addr", "order", "pass")}
    for s in range(X):
        sl = K._slab(r, s)
        for j, ((iy, iz), length) in enumerate(zip(sl["sel"], sl["lens"])):
            fy, fz = sl["y0"] + iy, sl["z0"] + iz
            ok = (length > 0) & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z) & (g != 0)
            idx = ray[ok]
            step = s - lo[ok]
            cols["ray"].append(idx)
            cols["instr"].append(((idx // 32) * (X + 2) + step) * 8 + j)
            cols["addr"].append(s * ss + fy[ok].long() * sy + fz[ok].long() * sz)
            cols["order"].append(step * 8 + j)
            cols["pass"].append(step // 32)
    c = {k: torch.cat(v) for k, v in cols.items()}
    return _requests(c["ray"], c["instr"], c["addr"], X * Y * Z // 8 + 1, c["order"], c["pass"])


def joseph_requests(rows, g, shape, axis, h, n_steps):
    """As siddon_requests, for joseph_bwd_vol: a step's 4 (or 8) neighbours
    are slots (m * 2 + n) * 2 + plane."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    perm = march_perm(axis)
    X, Y, Z = (shape[p] for p in perm)
    strides = _contig_strides(shape)
    ss, sy, sz = (strides[p] for p in perm)
    r = dict(zip(("a", "b", "amin", "amax"), rows[[0, 1, 7, 8]]))
    ah = r["a"] * h
    u0, u1 = (r["amin"] - r["b"]) / ah, (r["amax"] - r["b"]) / ah
    lo = torch.clamp(torch.floor(torch.minimum(u0, u1)) - 1, 0, n_steps).long()
    ray = torch.arange(rows.shape[1], device=rows.device)
    cols = {k: [] for k in ("ray", "instr", "addr", "order", "pass")}
    for st in J.march_steps(rows, h, X, n_steps):
        for m, nn, fy, fz in J.corners(st):
            w = st["wy"][m] * g * st["wz"][nn] * st["scale"]
            for q, (k, f) in enumerate(st["planes"]):
                ok = (st["inslab"] & (w * f != 0) & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
                      & (0 <= k) & (k < X))
                idx = ray[ok]
                step = st["p"] - lo[ok]
                slot = (m * 2 + nn) * 2 + q
                cols["ray"].append(idx)
                cols["instr"].append(((idx // 32) * (n_steps + 2) + step) * 8 + slot)
                cols["addr"].append(k * ss + fy[ok].long() * sy + fz[ok].long() * sz)
                cols["order"].append(step * 8 + slot)
                cols["pass"].append(step // 32)
    c = {k: torch.cat(v) for k, v in cols.items()}
    return _requests(c["ray"], c["instr"], c["addr"], X * Y * Z // 8 + 1, c["order"], c["pass"])


def _contig_strides(shape):
    return (shape[1] * shape[2], shape[2], 1)


def probe_rows(rows, kind, seed=0):
    """(rows, order) of a probe: ``order`` permutes the cotangent too."""
    import torch

    rows = rows.clone()
    order = None
    if kind == "march":
        rows[2] += 1e6  # gy: every voxel index out of range, the march unchanged
    elif kind == "parallel":
        mid = 0.5 * (rows[7] + rows[8])
        rows[2] += mid * rows[3]
        rows[4] += mid * rows[5]
        rows[3] = 0.0
        rows[5] = 0.0
    elif kind == "shuffled":
        gen = torch.Generator(device="cpu").manual_seed(seed)
        order = torch.randperm(rows.shape[1], generator=gen).to(rows.device)
        rows = rows[:, order].contiguous()
    elif kind == "tiled":
        mid = 0.5 * (rows[7] + rows[8])
        ty = torch.floor((rows[2] + mid * rows[3]) / 16).long()
        tz = torch.floor((rows[4] + mid * rows[5]) / 16).long()
        key = ((ty + 1024) * 2048 + tz + 1024) * rows.shape[1] + torch.arange(
            rows.shape[1], device=rows.device)
        order = torch.argsort(key)
        rows = rows[:, order].contiguous()
    return rows, order


def scatter_case(lib, fn_name, wrapper, rows, g, shape, axis, march, probes=False):
    import torch

    from diffdrr_tpu_torch.ops.kernels._launch import call, strides_extents

    rows = rows.contiguous()
    grad = torch.zeros(shape, dtype=torch.float32, device=rows.device)

    def launch(into, rows=rows, g=g):
        call(lib, fn_name, rows.device, rows.data_ptr(), rows.shape[1], g.data_ptr(), None,
             into.data_ptr(), *strides_extents(into, axis), *march)

    def requests(rows, g):
        if lib == "siddon":
            return siddon_requests(rows, g, shape, axis)
        return joseph_requests(rows, g, shape, axis, *march[:2])

    out = {"rays": rows.shape[1], "axis": axis,
           "alone": events_ms(lambda: launch(grad), grad.zero_),
           "wrapper": events_ms(lambda: wrapper(rows, g, shape, axis, *march[:-1])),
           "fill": events_ms(lambda: torch.zeros(shape, dtype=torch.float32,
                                                 device=rows.device))}
    out["profiled"], out["profiled_busy"] = profiled(
        lambda: wrapper(rows, g, shape, axis, *march[:-1]))
    if axis != 2:
        # march axis innermost: allocate in (y, z, s) order, view as the density
        perm = [d for d in range(3) if d != axis] + [axis]
        inv = [perm.index(d) for d in range(3)]

        def scratch():
            s = torch.zeros([shape[d] for d in perm], dtype=torch.float32,
                            device=rows.device).permute(inv)
            launch(s)
            return s.contiguous()

        ref = wrapper(rows, g, shape, axis, *march[:-1])
        out["scratch_err"] = float((scratch() - ref).abs().max())
        out["scratch"] = events_ms(scratch)
        s = torch.zeros([shape[d] for d in perm], dtype=torch.float32,
                        device=rows.device).permute(inv)
        out["scratch_alone"] = events_ms(lambda: launch(s), s.zero_)
    if probes:
        out["requests"] = requests(rows, g)
        out["probes"] = {}
        for kind in ("march", "parallel", "shuffled", "tiled"):
            rows_p, order = probe_rows(rows, kind)
            g_p = g if order is None else g[order].contiguous()
            out["probes"][kind] = {"alone": events_ms(lambda: launch(grad, rows_p, g_p),
                                                      grad.zero_)}
            if kind == "parallel":
                out["probes"][kind].update(requests(rows_p, g_p))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                        help="checkout whose diffdrr_tpu_torch is timed")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scatter_timing: no CUDA device", file=sys.stderr)
        return 2
    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.ops.kernels import build
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    label = args.root.resolve().name
    print(f"[scatter_timing] {label}: package {Path(T.__file__).parent}; {card}", flush=True)
    build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    thetas = np.linspace(0, np.pi, N_VIEWS, endpoint=False)
    rot_v = torch.tensor(np.stack([thetas, np.full(N_VIEWS, np.pi / 2), np.zeros(N_VIEWS)], 1),
                         dtype=torch.float32, device=dev)
    trans_v = torch.tensor(BENCH_TRANS * N_VIEWS, device=dev)
    rot0 = torch.tensor(BENCH_ROT, device=dev)
    trans0 = torch.tensor(BENCH_TRANS, device=dev)

    def rows_of(drr, rot, trans, axis, **prep):
        src, tgt = drr.detector(T.convert(rot, trans, **KW))
        w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
        return prep_rays(drr.affine_inverse(src), drr.affine_inverse(tgt), w, axis,
                         drr.density.shape, **prep)

    def cotangent(rows):
        return torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device=dev)

    cases = {}
    main_ct = T.load_example_ct()
    drr = T.DRR(main_ct, sdd=1020.0, height=200, delx=2.0)
    shape = tuple(drr.density.shape)
    for name, rot, trans, axis in (("siddon_bwd_vol recon", rot_v, trans_v, 2),
                                   ("siddon_bwd_vol axis 0", rot0, trans0, 0)):
        rows = rows_of(drr, rot, trans, axis)
        cases[name] = scatter_case("siddon", "siddon_bwd_vol", K.siddon_bwd_vol, rows,
                                   cotangent(rows), shape, axis, [], probes=axis == 2)
    drr_j = T.DRR(main_ct, sdd=1020.0, height=200, delx=2.0, renderer="joseph")
    h0 = float(drr_j.joseph_steps[0])
    rows = rows_of(drr_j, rot0, trans0, 0, quadrature="joseph", h=h0)
    march = [h0, int(-(-shape[0] // h0)), int(J.is_blend(h0))]
    cases["joseph_bwd_vol axis 0"] = scatter_case("joseph", "joseph_bwd_vol", J.joseph_bwd_vol,
                                                  rows, cotangent(rows), shape, 0, march)
    del drr, drr_j, main_ct
    cli_ct = T.load_example_ct(shape=(512, 512, 128))  # the CLI's --volume-size 512
    drr_t = T.DRR(cli_ct, sdd=1020.0, height=200, delx=3.0, renderer="trilinear")
    shape = tuple(drr_t.density.shape)
    h, n = raymarch_steps(shape[2], 500)  # the CLI's trilinear n_points
    rows = rows_of(drr_t, rot_v, trans_v, 2, quadrature="joseph", h=h)
    cases["joseph_bwd_vol recon-CLI"] = scatter_case("joseph", "joseph_bwd_vol",
                                                     J.joseph_bwd_vol, rows, cotangent(rows),
                                                     shape, 2, [h, n, int(J.is_blend(h))],
                                                     probes=True)
    for name, c in cases.items():
        prof = ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(c["profiled"].items(),
                                                                 key=lambda kv: -kv[1]))
        extra = (f"; scratch (march axis innermost) {c['scratch']:.4f} with fill and copy, "
                 f"kernel {c['scratch_alone']:.4f} (vs wrapper {c['scratch_err']:.2e})"
                 if "scratch" in c else "")
        print(f"[scatter_timing] {label} {name} ({c['rays']} rays, axis {c['axis']}): alone "
              f"{c['alone']:.4f} ms, wrapper {c['wrapper']:.4f} ms, fill {c['fill']:.4f} ms; "
              f"profiled per call: {prof} (device {100 * c['profiled_busy']:.1f}% busy)"
              + extra, flush=True)
        for kind, res in [("as is", c["requests"])] + list(c["probes"].items()) \
                if "probes" in c else []:
            print(f"[scatter_timing] {label} probe {name} {kind}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in res.items()),
                flush=True)
    print(json.dumps({"label": label, "card": card, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
