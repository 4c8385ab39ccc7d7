#!/usr/bin/env python3
"""Drive diffdrr_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py                    # all phases, one card, ~a minute
    python3 chip_smoke.py --profile OUT.txt  # also profile registration and
                                             # reconstruction steps: the
                                             # device's busy share (in a
                                             # registration step also the
                                             # fused kernel's share of it),
                                             # and the profiler's tables in
                                             # OUT.txt

Phases (any failure raises and the exit code is non-zero):
  1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
  2. build: nvcc builds the kernels from diffdrr_tpu_torch/csrc for sm_90a;
  3. kernels vs plain: every kernel against its plain PyTorch version on
     the card, random 128x128x64 volume, 64x64 detector, an off-grid pose, a
     random cotangent g; siddon_bwd_rays and siddon_bwd_vol in sum and MIP
     modes (value and argmax exact or value atol 1e-4 * max, rows atol
     1e-3 * max|row|, gradient volume atol 1e-4 * max|ref|); siddon_fwd
     and siddon_fwdgrad (which read the density's bricked copy) also with
     the march axis pinned to 0 and to 2, siddon_fwdgrad launched twice at
     each axis with the same bits (its lanes combine in a fixed order);
  4. main path at full size: the 512x512x133 example CT, a 200x200 detector
     (sdd 1020 mm, 2 mm pixels), the bench pose; renders with the march axis
     pinned to 2 and chosen automatically, held against the plain version;
     then registration steps from translation + 5 mm (Adam, multiscale NCC),
     with the score rising, no density-gradient or two-pass launch, and the
     CT's bricked copy made once. Launch counts are zeroed before each path
     and read after it;
  4b. MIP at full size, same CT, detector and pose: a reducefn="max" render
     and one backward of sum(img**2) to the density and the pose, each
     kernel held against its plain version; a sum-mode pose backward with
     fused_pose_bwd=False, equal to the fused one;
  4c. reconstruction at full size: 8 views of the same CT and detector on
     the reconstruction CLI's trajectory (the detector turned about its
     central ray, so every view marches axis 2), measured images rendered
     from the true density, 20 Adam steps (lr 5e-2) from a zero density
     with the loss falling and exact launch counts (the density's bricked
     copy made 21 times: once for the measured images, once a step);
     siddon_fwd and siddon_bwd_vol held against their plain versions at all
     320,000 rays;
  5. the 512^3 isotropic CT (the volume the TPU had to stream plane by
     plane): a 200x200 and a 1000x1000 render, each against the plain
     version, siddon_fwd at 1000x1000 timed with its bricked copy cached and
     made anew;
  6. timings: median CUDA-event times of each kernel and its plain version
     at the shapes of the path that launches it, a render, a registration
     step and a reconstruction step, the host time of the auto axis choice
     (it reads back to the host), and each kernel's bound (the least time
     the card could take for the same work); siddon_bwd_vol also alone
     (into a preallocated, zeroed gradient) and with the march axis pinned
     to 0; siddon_fwd at 200x200 and at the reconstruction's 320,000 rays,
     each with the density's bricked copy cached (registration, renders)
     and made anew in each call (a reconstruction step), and the copy alone;
     siddon_fwdgrad likewise at the main path's rays;
  7. the Joseph and trilinear renderers (csrc/joseph.cu):
  7a. every Joseph kernel against its plain version on the random volume of
     phase 3, at strides h = 1, 4 (axis 0 pinned), ~1.37 and ~0.26, in sum
     and MIP modes (the tolerances of phase 3), joseph_fwdgrad launched twice
     with the same bits; joseph_fwd and joseph_fwdgrad (sum and max) also at
     axis 0 with h = 1 and 1.37 and at axis 2 with h = 4;
  7b. trilinear registration at full size: phase 4's CT, detector, pose and
     60 Adam steps with renderer="trilinear" (n_points 500, capped at the
     133 planes: h = 1), exactly joseph_fwd 2, joseph_fwdgrad 60 and one
     bricked copy of the CT;
  7c. joseph MIP at the main pose: one backward to density and pose (fused:
     joseph_fwdgrad max + joseph_bwd_vol), one two-pass pose backward
     (joseph_fwd_max + joseph_bwd_rays), the two pose gradients equal;
  7d. trilinear reconstruction through the port's CLI
     (diffdrr_tpu_torch.experiments.reconstruction): a 512x512x128 CT, 8
     views of 200x200, 20 steps with checkpoints every 10, exactly
     joseph_fwd 21 and joseph_bwd_vol 20, the loss falling tenfold; a second
     call resumes at step 20 and runs no step;
  7e. fractional strides at full size: trilinear with n_points=100 and with
     allow_oversample at 500, joseph pinned to axis 0 (h = 4), and
     joseph_bwd_vol there against its plain version, timed;
  7f. the 512^3 CT with joseph_fwd at 200x200 and 1000x1000, each against
     the plain version;
  7g. timings of every Joseph kernel beside its bound and plain version, and
     F.grid_sample over the same sample points as the library yardstick;
     joseph_bwd_vol also alone; joseph_fwd at 200x200 and at the CLI's
     320,000 rays with its bricked copy cached and made anew, the copy
     alone, and F.grid_sample over those 320,000 rays' sample points;
     joseph_fwdgrad at 200x200 with its copy cached and made anew;
  8. per-structure channels (mask_to_channels) and p_subsample:
  8a. the channel kernels (joseph_fwd_ch, joseph_bwd_rays_ch,
     joseph_bwd_vol_ch) against their plain versions on phase 3's volume with
     a random 5-label map, at 5 channels and at 3 (labels 3 and 4 drop),
     strides 1, 4 (axis 0), ~1.37, 0.5 (plane-pair ties) and ~0.26;
  8b. joseph and trilinear channel renders of phase 4's CT with its 7
     labels: shape (1, 7, 200, 200), channel sum equal to the scalar render,
     each kernel against its plain version at all 40,000 rays, one backward
     of sum_c w_c sum img_c**2 to density and pose launching exactly one of
     each channel kernel and no joseph_fwdgrad;
  8c. Siddon channels at full width on the oracle (no Siddon kernel
     launched), the channel sum equal to siddon_fwd's render;
  8d. p_subsample=0.1, trilinear at full width: equal to the full render at
     its 4,000 pixels and 0 elsewhere, with and without channels; one pose
     backward; its render time beside the full render's;
  8e. timings of the channel kernels at 200^2 with 7 channels.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. In the record, ``brick_copy`` (the
bricked copy of the density that siddon_fwd and joseph_fwd read; no TPU
counterpart) has an entry of its own, with the launches of phase 4c. The
two forwards' entries at 320,000 rays give ``ms`` with the copy already
made (as a registration or a render reads it) and ``ms_with_copy`` with a
fresh copy in each call, which is what a reconstruction step pays; the two
fused pose kernels' entries likewise at 200x200, with ``design`` naming
their layout (the bricked copy, G lanes a ray).
Without a CUDA device, or without the package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# A bound's operations are the float32 arithmetic the kernel does on the
# data (add, subtract, multiply, divide, abs, floor and rint; comparisons,
# min/max and selects are not counted), counted by hand from its header.
# csrc/siddon.cuh, per non-empty (ray, slab) step: slab_segments 59 (the
# slab's two alphas 6, two crossings 20, lengths and midpoints 9, the
# segments' voxels 24); then 2 per slab and 4 per non-empty segment
# (trace_fwd: the voxel's position, len * V and the sums), 4 per segment
# (trace_fwd_max), 54 per slab (trace_fwdgrad: three positions 6, slab_rows
# 46, w * seg 2), 52 per slab and 9 products by g per ray (trace_bwd_rays),
# or 5 per segment (trace_bwd_vol: the position 2, len * w * g 2, the atomic
# add). slab_range costs 10 per ray; a MIP backward skips it and visits only
# the argmax slab and segment.
SLAB_OPS = 59
SLAB_RANGE_OPS = 10

N_REG_STEPS = 60
BENCH_ROT = [[0.01, 3.141592653589793 / 2 + 0.02, -0.01]]
BENCH_TRANS = [[0.0, 850.0, 0.0]]
# Reconstruction (experiments/reconstruction.py:62-68): 8 views, rotation
# [theta, pi/2, 0] for theta in linspace(0, pi, 8, endpoint=False).
N_VIEWS = 8
N_RECON_STEPS = 20
RECON_LR = 5e-2
# The trilinear reconstruction through the port's CLI: a 512x512x128 CT
# (its shape rule (vs, vs, max(16, vs // 4))) and 200x200 views.
CLI_VOLUME_SIZE = 512
CLI_HEIGHT = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 2, before=None) -> float:
    """Median CUDA-event time of ``fn`` (device work it enqueues); ``before``
    runs ahead of each call, outside the events."""
    import torch

    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def scatter_alone_ms(lib, fn_name, rows, g, shape, axis, march=(), reps: int = 20) -> float:
    """Median CUDA-event time of one launch of the density-gradient scatter
    ``fn_name`` into a preallocated gradient, zeroed before each launch
    outside the events: the kernel alone, without the wrapper's allocation
    and zero fill. It calls the C entry point, so no launch counter moves."""
    import torch

    from diffdrr_tpu_torch.ops.kernels._launch import call, strides_extents

    rows = rows.contiguous()
    grad = torch.zeros(tuple(shape), dtype=torch.float32, device=rows.device)
    return median_ms(lambda: call(lib, fn_name, rows.device, rows.data_ptr(), rows.shape[1],
                                  g.data_ptr(), None, grad.data_ptr(),
                                  *strides_extents(grad, axis), *march),
                     reps, before=grad.zero_)


def median_host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn``, which must end in a device sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def slab_work(rows, density, axis, arg=None):
    """(non-empty ray-slab steps, non-empty segments, distinct voxels read).

    What the data needs, not what a kernel does: empty slabs and zero-length
    segments are not counted, and a voxel read by many rays counts once.
    With a MIP argmax ``arg``, only each ray's argmax slab and segment.
    """
    import torch

    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    r = K._rows_dict(rows)
    vol_p = density.permute(march_perm(axis))
    X, Y, Z = vol_p.shape
    seen = torch.zeros((X, Y, Z), dtype=torch.bool, device=density.device)
    steps = segments = 0
    for s in range(X):
        sl = K._slab(r, s)
        if arg is None:
            steps += int(torch.count_nonzero(sl["ahi_raw"] >= sl["alo"]))
        else:
            steps += int(torch.count_nonzero((arg >= 0) & (arg // 4 == s)))
        for j, ((iy, iz), length) in enumerate(zip(sl["sel"], sl["lens"])):
            fy, fz = sl["y0"] + iy, sl["z0"] + iz
            nonempty = length > 0
            if arg is not None:
                nonempty = nonempty & (arg == s * 4 + j)
            segments += int(torch.count_nonzero(nonempty))
            ok = nonempty & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
            seen[s, fy[ok].long(), fz[ok].long()] = True
    return steps, segments, int(torch.count_nonzero(seen))


def roofline(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes and operations over peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def io_bytes(rows, density, ray_bytes, voxels, writes_volume):
    """Each ray's ``ray_bytes`` (rows, cotangent, argmax, outputs) plus 4 B
    per distinct voxel read, or, for a density gradient, 4 B per voxel of
    the whole volume written once (its zero fill is part of the call)."""
    return ray_bytes * rows.shape[1] + 4 * (density.numel() if writes_volume else voxels)


def bound(rows, density, axis, *, ray_bytes, slab_ops=0, segment_ops=0, ray_ops=0,
          writes_volume=False, arg=None):
    """(bound_ms, bound_by) of a Siddon kernel on this run's rays: ``slab_ops``
    per non-empty slab step, ``segment_ops`` per non-empty segment, and
    ``ray_ops`` (plus the slab range's, outside MIP) per ray."""
    steps, segments, voxels = slab_work(rows, density, axis, arg)
    ray_ops += SLAB_RANGE_OPS if arg is None else 0
    n_ops = steps * (SLAB_OPS + slab_ops) + segments * segment_ops + ray_ops * rows.shape[1]
    return roofline(io_bytes(rows, density, ray_bytes, voxels, writes_volume), n_ops)


# ray_bytes of each kernel: 36 B of rows in, 4 B of g, 4 B of argmax, and
# 4 (fwd), 40 (fwdgrad), 8 (fwd_max) or 36 (bwd_rays) B out per ray.
FWD_BOUND = dict(ray_bytes=36 + 4, slab_ops=2, segment_ops=4)
FWDGRAD_BOUND = dict(ray_bytes=36 + 40, slab_ops=54)
FWD_MAX_BOUND = dict(ray_bytes=36 + 8, segment_ops=4)
BWD_RAYS_BOUND = dict(ray_bytes=36 + 4 + 36, slab_ops=52, ray_ops=9)
BWD_VOL_BOUND = dict(ray_bytes=36 + 4, segment_ops=5, writes_volume=True)

# csrc/joseph.cuh, per in-slab (ray, step) sample, by the rule above:
# step_at 21 (k, alpha and the transverse position 7, its floors and
# offsets 4, four tent weights 10); then 19 (trace_fwd: four neighbour
# positions 8, bilinear 9, the weighted sum 2), 18 (trace_fwd_max), 58
# (trace_fwdgrad: positions 8, step_terms 42, eight sums), 57 and 7
# products by g per ray (trace_bwd_rays), or 22 (trace_bwd_vol: wy * g 2,
# then per neighbour its position 2, the product 2 and the atomic add). A
# fractional stride adds 18 to each: k's floor and fraction 2, and per
# neighbour a second plane's lerp (or weight and scatter) 4. step_range
# costs 9 per ray; a MIP backward skips it and visits only the argmax step.
J_STEP_OPS = 21
J_BLEND_OPS = 18
J_RANGE_OPS = 9


def march_work(rows, density, axis, h, n_steps, arg=None):
    """(in-slab samples, distinct voxels read, distinct label voxels read)
    of one Joseph march.

    What the data needs: samples outside a ray's [amin, amax] are not
    counted, and a voxel read by many samples counts once. With a MIP argmax
    ``arg``, only each ray's argmax step. The label voxels are those a
    channel kernel reads (``label_at``: the nearest voxel of each sample).
    """
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    X, Y, Z = density.permute(march_perm(axis)).shape
    seen = torch.zeros((X, Y, Z), dtype=torch.bool, device=density.device)
    seen_lab = torch.zeros_like(seen)
    samples = 0
    for st in J.march_steps(rows, h, X, n_steps):
        ok = st["inslab"] if arg is None else st["inslab"] & (arg == st["p"])
        samples += int(torch.count_nonzero(ok))
        for _, _, fy, fz in J.corners(st):
            v = ok & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
            for k, _ in st["planes"]:
                if 0 <= k < X:
                    seen[k, fy[v].long(), fz[v].long()] = True
        (k, _), *pair = st["planes"]
        k = pair[0][0] if pair and pair[0][1] > 0.5 else k
        iy, iz = torch.round(st["y"]), torch.round(st["z"])
        v = ok & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
        if 0 <= k < X:
            seen_lab[k, iy[v].long(), iz[v].long()] = True
    return samples, int(torch.count_nonzero(seen)), int(torch.count_nonzero(seen_lab))


def march_bound(rows, density, axis, h, n_steps, *, ray_bytes, sample_ops, ray_ops=0,
                writes_volume=False, arg=None, labels=False):
    """(bound_ms, bound_by) of a Joseph kernel, as ``bound`` is for Siddon's;
    ``labels``: it also reads 4 B per distinct label voxel."""
    from diffdrr_tpu_torch.ops.kernels.joseph import is_blend

    samples, voxels, label_voxels = march_work(rows, density, axis, h, n_steps, arg)
    ray_ops += J_RANGE_OPS if arg is None else 0
    per_sample = J_STEP_OPS + sample_ops + (J_BLEND_OPS if is_blend(h) else 0)
    n_ops = samples * per_sample + ray_ops * rows.shape[1]
    n_bytes = io_bytes(rows, density, ray_bytes, voxels, writes_volume)
    return roofline(n_bytes + (4 * label_voxels if labels else 0), n_ops)


# ray_bytes of each Joseph kernel: 36 B of rows in, 4 B of g and 4 B of
# argmax where they are read, and 4 (fwd), 8 (fwd_max), 32 (fwdgrad; 36
# with its argmax) or 28 (bwd_rays) B out per ray.
J_FWD_BOUND = dict(ray_bytes=36 + 4, sample_ops=19)
J_FWD_MAX_BOUND = dict(ray_bytes=36 + 8, sample_ops=18)
J_FWDGRAD_BOUND = dict(ray_bytes=36 + 32, sample_ops=58)
J_BWD_RAYS_BOUND = dict(ray_bytes=36 + 4 + 28, sample_ops=57, ray_ops=7)
J_BWD_VOL_BOUND = dict(ray_bytes=36 + 4, sample_ops=22, writes_volume=True)
# The channel kernels at C channels: their scalar counterpart's work, plus
# label_at's 6 operations a sample (the transverse position 4, two rints)
# and 4 B per distinct label voxel read; per ray 4 * C B of output or
# cotangent in place of 4. joseph_bwd_rays_ch multiplies each step's 7
# terms by its channel's cotangent (7 a sample, not 7 a ray).
J_LABEL_OPS = 6


def channel_bounds(C):
    return {"fwd_ch": dict(ray_bytes=36 + 4 * C, sample_ops=19 + J_LABEL_OPS, labels=True),
            "bwd_rays_ch": dict(ray_bytes=36 + 4 * C + 28, sample_ops=57 + 7 + J_LABEL_OPS,
                                labels=True),
            "bwd_vol_ch": dict(ray_bytes=36 + 4 * C, sample_ops=22 + J_LABEL_OPS,
                               writes_volume=True, labels=True)}


def profile_steps(step, label: str, t_step: float, out: Path, n: int = 5,
                  kernel: str = None) -> None:
    """Profile ``n`` calls of ``step``: log the device's busy time per step
    against ``t_step`` (its measured median) and, with ``kernel``, the share
    of it that the device spent in kernels whose name holds that string;
    append the table to ``out``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # Kernels of one stream do not overlap, so their durations add up to
    # the device's busy time; user annotations span kernels and are left out.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / n
    with out.open("a") as f:
        f.write(f"\n== {label} step, {n} steps ==\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    share = ""
    if kernel is not None:
        k_ms = sum(e.time_range.elapsed_us() for e in device if kernel in e.name) / 1e3 / n
        share = f"; {kernel} {k_ms:.4f} ms a step, {100 * k_ms / busy_ms:.1f}% of the busy time"
    log(f"[profile] {label} step: device busy {busy_ms:.3f} ms of a {t_step:.3f} ms step "
        f"({100 * busy_ms / t_step:.1f}% busy){share}; table in {out}")


def fused_design(header: str) -> str:
    """The fused kernel's layout, for the record: its lanes a ray, as the
    header ``csrc/<header>`` compiles them."""
    import re

    text = (ROOT / "diffdrr_tpu_torch" / "csrc" / header).read_text()
    lanes = re.search(r"constexpr int kFusedLanes = (\d+);", text).group(1)
    return f"bricked copy, {lanes} lanes a ray"


def check_close(name, got, ref, rel):
    import torch

    err = float(torch.max(torch.abs(got - ref)))
    tol = rel * float(torch.max(torch.abs(ref)))
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name}: max abs err {err:.3e} > tol {tol:.3e}")
    return err


def check_fused(name, got, ref):
    """Rows 0..8 to 1e-3 * max|row|, the value row to 1e-4 * max|value|."""
    errs = [check_close(f"{name} row {k}", got[k], ref[k], 1e-3 if k < 9 else 1e-4)
            for k in range(ref.shape[0])]
    return max(errs)


def check_repeat(name, first, again):
    """A second launch gives the same bits (the fused kernels' lanes combine
    in a fixed order)."""
    import torch

    if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{name}: a repeated launch differs")


def check_max(name, got, ref):
    """MIP (value, argmax): the argmax exact, the value to 1e-4 * max."""
    import torch

    n_diff = int(torch.count_nonzero(got[1] != ref[1]))
    if n_diff:
        raise AssertionError(f"{name}: argmax differs on {n_diff} rays")
    return check_close(f"{name} value", got[0], ref[0], 1e-4)


def rays_of(drr, rot, trans, axis=None):
    """Voxel-space rows of a DRR's full frame at a pose (the render's own prep)."""
    import torch

    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.pose import convert

    pose = convert(rot, trans, parameterization="euler_angles", convention="ZXY")
    src, tgt = drr.detector(pose)
    w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
    sv, tv = drr.affine_inverse(src), drr.affine_inverse(tgt)
    if axis is None:
        axis = int(torch.argmin(drr.worst_ratios(sv, tv)))
    return prep_rays(sv, tv, w, axis, drr.density.shape), axis


def jrays_of(drr, rot, trans, axis, h):
    """Voxel-space rows of a DRR's full frame with the Joseph quadrature at stride h."""
    import torch

    from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
    from diffdrr_tpu_torch.pose import convert

    pose = convert(rot, trans, parameterization="euler_angles", convention="ZXY")
    src, tgt = drr.detector(pose)
    w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
    return prep_rays(drr.affine_inverse(src), drr.affine_inverse(tgt), w, axis,
                     drr.density.shape, quadrature="joseph", h=h)


def check_rows(name, got, ref, value_row=None):
    """Gradient rows to 1e-3 * max|row|, the value row to 1e-4 * max|value|."""
    return max(check_close(f"{name} row {k}", got[k], ref[k], 1e-4 if k == value_row else 1e-3)
               for k in range(ref.shape[0]))


def check_joseph(label, rows, dens, axis, h, n, g):
    """All five Joseph kernels against their plain versions, sum and MIP."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J

    e = {"fwd": check_close(f"joseph_fwd {label}", J.joseph_fwd(rows, dens, axis, h, n),
                            J.joseph_fwd_plain(rows, dens, axis, h, n), 1e-4)}
    mip = J.joseph_fwd_max(rows, dens, axis, h, n)
    e["fwd_max"] = check_max(f"joseph_fwd_max {label}", mip,
                             J.joseph_fwd_max_plain(rows, dens, axis, h, n))
    for reduce in ("sum", "max"):
        got, arg = J.joseph_fwdgrad(rows, dens, axis, h, n, reduce)
        ref, ref_arg = J.joseph_fwdgrad_plain(rows, dens, axis, h, n, reduce)
        if reduce == "max" and not (torch.equal(arg, ref_arg) and torch.equal(arg, mip[1])):
            raise AssertionError(f"joseph_fwdgrad[max] {label}: argmax differs")
        again, arg_again = J.joseph_fwdgrad(rows, dens, axis, h, n, reduce)
        check_repeat(f"joseph_fwdgrad[{reduce}] {label}", got, again)
        if reduce == "max" and not torch.equal(arg, arg_again):
            raise AssertionError(f"joseph_fwdgrad[max] {label}: a repeated launch differs")
        e[f"fwdgrad_{reduce}"] = check_rows(f"joseph_fwdgrad[{reduce}] {label}", got, ref, 7)
    for mode, a in (("sum", None), ("mip", mip[1])):
        e[f"bwd_rays_{mode}"] = check_rows(
            f"joseph_bwd_rays[{mode}] {label}", J.joseph_bwd_rays(rows, dens, axis, h, n, g, a),
            J.joseph_bwd_rays_plain(rows, dens, axis, h, n, g, a))
        e[f"bwd_vol_{mode}"] = check_close(
            f"joseph_bwd_vol[{mode}] {label}", J.joseph_bwd_vol(rows, g, dens.shape, axis, h, n, a),
            J.joseph_bwd_vol_plain(rows, g, dens.shape, axis, h, n, a), 1e-4)
    e["rays_with_max"] = int((mip[1] >= 0).sum())
    return e


def joseph_launches():
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    return {fn.__name__: fn.launches for fn in J.KERNELS}


def expect_launches(phase, got, want):
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{phase}: launches (got, want) {bad}")


def events_step(step, n):
    """Run ``step()`` n times with CUDA events around each; (results, ms list)."""
    import torch

    out, marks = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.append(step())
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in marks]


def joseph_small(small, rot_g, trans_g, rng):
    """Phase 7a: the Joseph kernels against their plain versions on the
    random volume, at strides 1, 4 (axis 0 pinned), ~1.37 and ~0.26."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    dens = small.density
    _, ax = rays_of(small, rot_g, trans_g)
    X = dens.shape[ax]
    cases = [("h=1", ax, 1.0, X), ("h=4 axis 0", 0, 4.0, -(-dens.shape[0] // 4)),
             ("h~1.37", ax, *raymarch_steps(X, 47)),
             ("h~0.26", ax, *raymarch_steps(X, 243, allow_oversample=True))]
    worst = {}
    for label, axis, h, n in cases:
        rows = jrays_of(small, rot_g, trans_g, axis, h)
        g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device=rows.device)
        errs = check_joseph(f"{label} 128x128x64", rows, dens, axis, h, n, g)
        torch.cuda.synchronize()
        log(f"[joseph kernels] {label}: axis {axis}, h {h:.6f}, {n} steps: "
            + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in errs.items()))
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0), v)
    # The two kernels that read the bricked copy, joseph_fwd and joseph_fwdgrad
    # (sum and max), on the other axis of each stride: axes 0 and 2.
    errs, errs_fg = [], []
    for axis, h in ((0, 1.0), (0, 1.37), (2, 4.0)):
        n = int(-(-dens.shape[axis] // h))
        rows = jrays_of(small, rot_g, trans_g, axis, h)
        errs.append(check_close(f"joseph_fwd axis {axis} h={h:g} 128x128x64",
                                J.joseph_fwd(rows, dens, axis, h, n),
                                J.joseph_fwd_plain(rows, dens, axis, h, n), 1e-4))
        for reduce in ("sum", "max"):
            got, arg = J.joseph_fwdgrad(rows, dens, axis, h, n, reduce)
            ref, ref_arg = J.joseph_fwdgrad_plain(rows, dens, axis, h, n, reduce)
            if reduce == "max" and not torch.equal(arg, ref_arg):
                raise AssertionError(f"joseph_fwdgrad[max] axis {axis} h={h:g}: argmax differs")
            errs_fg.append(check_rows(f"joseph_fwdgrad[{reduce}] axis {axis} h={h:g}", got,
                                      ref, 7))
    log(f"[joseph kernels] joseph_fwd at axis 0 h 1 and 1.37, axis 2 h 4: "
        + ", ".join(f"{e:.3e}" for e in errs) + "; joseph_fwdgrad sum, max there: "
        + ", ".join(f"{e:.3e}" for e in errs_fg))
    worst["fwd"] = max(worst["fwd"], *errs)
    worst["fwdgrad_sum"] = max(worst["fwdgrad_sum"], *errs_fg)
    return worst


def trilinear_registration(T, subject, rot0, trans, kw, profile):
    """Phase 7b: 60 trilinear registration steps at full size."""
    import numpy as np
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.registration import make_registration_step

    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer="trilinear")
    J.reset_launch_counts()
    brick.clear_cache()
    brick.brick_density.launches = 0
    target = drr(rot0, trans, axis=2, **kw)
    auto = drr(rot0, trans, **kw)
    init_fn, step_fn = make_registration_step(drr, target, "euler_angles", "ZXY",
                                              lr_rotation=1e-3, lr_translation=1e-1)
    params, opt = init_fn(rot0, trans + 5.0)
    state = {"params": params, "opt": opt}

    def step():
        state["params"], state["opt"], score = step_fn(state["params"], state["opt"])
        return score

    scores, step_ms = events_step(step, N_REG_STEPS)
    launches = dict(joseph_launches(), brick_copy=brick.brick_density.launches)
    log(f"[trilinear] registration launches {launches}")
    # One CT: its bricked copy made once for the renders and all 60 steps.
    expect_launches("trilinear registration", launches,
                    {"joseph_fwd": 2, "joseph_fwdgrad": N_REG_STEPS, "joseph_fwd_max": 0,
                     "joseph_bwd_rays": 0, "joseph_bwd_vol": 0, "brick_copy": 1})
    scores = torch.stack(scores).tolist()
    if not (scores[-1] > scores[0] and np.isfinite(scores).all()):
        raise AssertionError(f"trilinear registration NCC did not rise: {scores[0]} -> {scores[-1]}")
    if target.shape != (1, 1, 200, 200) or not torch.isfinite(target).all():
        raise AssertionError(f"bad trilinear render {tuple(target.shape)}")
    check_close("trilinear auto-axis render", auto, target, 1e-6)
    X = drr.density.shape[2]
    rows_m = jrays_of(drr, rot0, trans, 2, 1.0)
    err_fwd = check_close("joseph_fwd (trilinear h=1) 512x512x133 @200^2", target.reshape(-1),
                          J.joseph_fwd_plain(rows_m, drr.density, 2, 1.0, X), 1e-4)
    p = state["params"]
    rows_r = jrays_of(drr, p["rotation"].detach(), p["translation"].detach(), 2, 1.0)
    got, _ = J.joseph_fwdgrad(rows_r, drr.density, 2, 1.0, X)
    err_fg = check_rows("joseph_fwdgrad 512x512x133 @200^2", got,
                        J.joseph_fwdgrad_plain(rows_r, drr.density, 2, 1.0, X)[0], 7)
    t_err = (p["translation"].detach() - trans)[0].tolist()
    t_step = statistics.median(step_ms[5:])
    if profile is not None:
        profile_steps(step, "trilinear registration", t_step, profile, kernel="joseph_fwdgrad")
    log(f"[trilinear] registration {N_REG_STEPS} steps: NCC {scores[0]:.5f} -> {scores[-1]:.5f}; "
        f"translation error from (5, 5, 5) to ({t_err[0]:.3f}, {t_err[1]:.3f}, {t_err[2]:.3f}) "
        f"mm; step median {t_step:.3f} ms (steps 6..{N_REG_STEPS}); render vs plain "
        f"{err_fwd:.3e}, fused rows vs plain {err_fg:.3e}")
    return dict(drr=drr, launches=launches, rows_m=rows_m, rows_r=rows_r, err_fwd=err_fwd,
                err_fg=err_fg, t_step=t_step, target=target)


def joseph_mip(T, subject, rot0, trans, kw, rows_m):
    """Phase 7c: the joseph MIP at the main pose, fused and two-pass."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J

    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer="joseph")
    J.reset_launch_counts()
    rot_p = rot0.clone().requires_grad_(True)
    trans_p = trans.clone().requires_grad_(True)
    dens_p = drr.density.clone().requires_grad_(True)
    mip = drr.render(dens_p, *drr.detector(T.convert(rot_p, trans_p, **kw)), reducefn="max")
    torch.sum(mip ** 2).backward()
    pg_fused = torch.cat([rot_p.grad, trans_p.grad], -1)
    r, t = rot0.clone().requires_grad_(True), trans.clone().requires_grad_(True)
    torch.sum(drr(r, t, reducefn="max", fused_pose_bwd=False, **kw) ** 2).backward()
    pg_two = torch.cat([r.grad, t.grad], -1)
    torch.cuda.synchronize()
    launches = joseph_launches()
    log(f"[joseph mip] launches {launches}")
    expect_launches("joseph MIP", launches,
                    {"joseph_fwdgrad": 1, "joseph_bwd_vol": 1, "joseph_fwd_max": 1,
                     "joseph_bwd_rays": 1, "joseph_fwd": 0})
    if not (torch.isfinite(mip).all() and torch.isfinite(dens_p.grad).all()
            and torch.isfinite(pg_fused).all()):
        raise AssertionError("joseph MIP render or gradients not finite")
    X = drr.density.shape[2]  # joseph_steps[2] = 1: the same rows as trilinear h = 1
    ref = J.joseph_fwd_max_plain(rows_m, drr.density, 2, 1.0, X)
    err_max = max(check_close("joseph MIP render @200^2", mip.reshape(-1).detach(), ref[0], 1e-4),
                  check_max("joseph_fwd_max @200^2",
                            J.joseph_fwd_max(rows_m, drr.density, 2, 1.0, X), ref))
    g = (2 * mip).reshape(-1).detach()
    arg = ref[1]
    err_br = check_rows("joseph_bwd_rays[mip] @200^2",
                        J.joseph_bwd_rays(rows_m, drr.density, 2, 1.0, X, g, arg),
                        J.joseph_bwd_rays_plain(rows_m, drr.density, 2, 1.0, X, g, arg))
    err_bv = check_close("joseph MIP density gradient", dens_p.grad,
                         J.joseph_bwd_vol_plain(rows_m, g, drr.density.shape, 2, 1.0, X, arg), 1e-4)
    err_pose = check_close("joseph MIP pose gradient, two-pass vs fused", pg_two, pg_fused, 1e-5)
    log(f"[joseph mip] render vs plain {err_max:.3e} ({int((arg >= 0).sum())} of {arg.numel()} "
        f"rays with a maximum); bwd_rays vs plain {err_br:.3e}; density gradient vs plain "
        f"{err_bv:.3e}; two-pass vs fused pose gradient {err_pose:.3e} (max "
        f"{pg_fused.abs().max().item():.3e})")
    return dict(drr=drr, launches=launches, arg=arg, err_max=err_max,
                err_br=max(err_br, err_pose), err_bv_mip=err_bv)


def trilinear_reconstruction(profile):
    """Phase 7d: the port's reconstruction CLI at full size, then its resume."""
    import tempfile

    import numpy as np
    import torch

    from diffdrr_tpu_torch.experiments import reconstruction as recon_cli
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    argv = ["--volume-size", str(CLI_VOLUME_SIZE), "--height", str(CLI_HEIGHT),
            "--n-views", str(N_VIEWS), "--n-iters", str(N_RECON_STEPS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        argv += ["--ckpt-dir", ckpt, "--ckpt-every", "10"]
        J.reset_launch_counts()
        brick.clear_cache()
        brick.brick_density.launches = 0
        res = recon_cli.main(argv)
        torch.cuda.synchronize()
        launches = dict(joseph_launches(), brick_copy=brick.brick_density.launches)
        log(f"[trilinear recon] launches {launches}")
        expect_launches("trilinear reconstruction", launches,
                        {"joseph_fwd": N_RECON_STEPS + 1, "joseph_bwd_vol": N_RECON_STEPS,
                         "joseph_fwdgrad": 0, "joseph_fwd_max": 0, "joseph_bwd_rays": 0,
                         "brick_copy": N_RECON_STEPS + 1})
        losses = res["losses"]
        if not (len(losses) == N_RECON_STEPS and np.isfinite(losses).all()
                and losses[-1] * 10 <= losses[0]):
            raise AssertionError(f"reconstruction loss did not fall tenfold: {losses}")
        again = recon_cli.main(argv)
        if again["start"] != N_RECON_STEPS or again["losses"]:
            raise AssertionError(f"resume ran from {again['start']}: {again['losses']}")
        del again
    t_step = statistics.median(res["step_ms"][2:])
    if profile is not None:
        state = list(res["state"])

        def step():
            state[0], state[1], _ = res["step"](*state)

        profile_steps(step, "trilinear reconstruction", t_step, profile)
    drr = res["drr"]
    thetas = np.linspace(0, np.pi, N_VIEWS, endpoint=False)
    rot_v = torch.tensor(np.stack([thetas, np.full(N_VIEWS, np.pi / 2), np.zeros(N_VIEWS)], 1),
                         dtype=torch.float32, device=drr.device)
    trans_v = torch.tensor(BENCH_TRANS * N_VIEWS, device=drr.device)
    X = drr.density.shape[2]
    h, n = raymarch_steps(X, 500)
    rows_v = jrays_of(drr, rot_v, trans_v, 2, h)
    dens = res["state"][0].detach()
    g_v = torch.tensor(np.random.default_rng(2).normal(size=rows_v.shape[1]) * 1e-5,
                       dtype=torch.float32, device=drr.device)
    err_fv = check_close("joseph_fwd 8 views", J.joseph_fwd(rows_v, dens, 2, h, n),
                         J.joseph_fwd_plain(rows_v, dens, 2, h, n), 1e-4)
    err_bv = check_close("joseph_bwd_vol 8 views", J.joseph_bwd_vol(rows_v, g_v, dens.shape, 2, h, n),
                         J.joseph_bwd_vol_plain(rows_v, g_v, dens.shape, 2, h, n), 1e-4)
    # The cotangent the CLI's last step scattered: d(MSE)/d(image), 0 on rays
    # whose render equals the measurement (those through air only).
    meas_v = J.joseph_fwd(rows_v, drr.density, 2, h, n)
    g_res = 2 * (J.joseph_fwd(rows_v, dens, 2, h, n) - meas_v) / meas_v.numel()
    log(f"[trilinear recon] {N_VIEWS} views x {CLI_HEIGHT}^2 rays of a {tuple(drr.density.shape)} CT "
        f"(h = {h}), {N_RECON_STEPS} steps: loss {losses[0]:.5g} -> {losses[-1]:.5g} "
        f"({losses[0] / losses[-1]:.1f}-fold); voxel RMSE {res['rmse']:.5g} (true RMS "
        f"{res['rms']:.5g}); step median {t_step:.3f} ms (steps 3..{N_RECON_STEPS}); resumed "
        f"at step {N_RECON_STEPS} with no step run; joseph_fwd vs plain {err_fv:.3e}, "
        f"joseph_bwd_vol vs plain {err_bv:.3e}")
    return dict(launches=launches, rows_v=rows_v, g_v=g_v, g_res=g_res, dens_shape=dens.shape,
                h=h, n=n, density=drr.density, err_fv=err_fv, err_bv=err_bv, t_step=t_step)


def fractional_strides(drr_t, drr_j, rot0, trans, kw):
    """Phase 7e: full-size renders at fractional strides and at h = 4."""
    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    X = drr_t.density.shape[2]
    errs = {}
    for label, opts, (h, n) in (
            ("n_points=100", dict(n_points=100), raymarch_steps(X, 100)),
            ("allow_oversample n_points=500", dict(n_points=500, allow_oversample=True),
             raymarch_steps(X, 500, True))):
        img = drr_t(rot0, trans, axis=2, **opts, **kw)
        rows = jrays_of(drr_t, rot0, trans, 2, h)
        errs[label] = check_close(f"trilinear {label} (h={h:.4f})", img.reshape(-1),
                                  J.joseph_fwd_plain(rows, drr_t.density, 2, h, n), 1e-4)
    h = float(drr_j.joseph_steps[0])
    n = int(-(-drr_j.density.shape[0] // h))
    img = drr_j(rot0, trans, axis=0, **kw)
    rows = jrays_of(drr_j, rot0, trans, 0, h)
    errs[f"joseph axis 0 h={h:g}"] = check_close(
        "joseph axis 0", img.reshape(-1), J.joseph_fwd_plain(rows, drr_j.density, 0, h, n), 1e-4)
    log("[fractional] renders vs plain at 200^2: " + "; ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))
    return max(errs.values())


def joseph_axis0_scatter(drr_j, rot0, trans, rng):
    """Phase 7e: joseph_bwd_vol with the march axis pinned to 0 (h = 4, the
    density's stride 512 x 133 along the march), one 200x200 view at the
    main pose: against its plain version, timed with and without its fill."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J

    shape = drr_j.density.shape
    h = float(drr_j.joseph_steps[0])
    n = int(-(-shape[0] // h))
    rows = jrays_of(drr_j, rot0, trans, 0, h)
    g = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device=rows.device)
    err = check_close("joseph_bwd_vol axis 0 @200^2", J.joseph_bwd_vol(rows, g, shape, 0, h, n),
                      J.joseph_bwd_vol_plain(rows, g, shape, 0, h, n), 1e-4)
    t = median_ms(lambda: J.joseph_bwd_vol(rows, g, shape, 0, h, n), 20)
    t_alone = scatter_alone_ms("joseph", "joseph_bwd_vol", rows, g, shape, 0,
                               (h, n, int(J.is_blend(h))))
    log(f"[time] joseph_bwd_vol axis 0 (h = {h:g}, 200^2, main pose) {t:.4f} ms with its zero "
        f"fill, {t_alone:.4f} ms alone; vs plain {err:.3e}")
    return err


def joseph_cube(T, cube, rot0, trans, kw):
    """Phase 7f: joseph_fwd (#7's function) on the 512^3 CT."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    drr = T.DRR(cube, sdd=1020.0, height=200, delx=2.0, renderer="joseph")
    J.reset_launch_counts()
    img = drr(rot0, trans, axis=2, **kw)
    torch.cuda.synchronize()
    launches = J.joseph_fwd.launches
    if launches < 1 or not torch.isfinite(img).all():
        raise AssertionError("512^3 joseph render did not run through joseph_fwd")
    X = drr.density.shape[2]
    h = float(drr.joseph_steps[2])
    rows = jrays_of(drr, rot0, trans, 2, h)
    err = check_close("joseph_fwd 512^3 @200^2", img.reshape(-1),
                      J.joseph_fwd_plain(rows, drr.density, 2, h, X), 1e-4)
    t = median_ms(lambda: J.joseph_fwd(rows, drr.density, 2, h, X), 20)
    t_plain = median_ms(lambda: J.joseph_fwd_plain(rows, drr.density, 2, h, X), 2, 1)
    b, by = march_bound(rows, drr.density, 2, h, X, **J_FWD_BOUND)
    drr_k = T.DRR(cube, sdd=1020.0, height=1000, delx=0.4, renderer="joseph")
    img_k = drr_k(rot0, trans, axis=2, **kw)
    rows_k = jrays_of(drr_k, rot0, trans, 2, h)
    err_k = check_close("joseph_fwd 512^3 @1000^2", img_k.reshape(-1),
                        J.joseph_fwd_plain(rows_k, drr_k.density, 2, h, X), 1e-4)
    t_k = median_ms(lambda: J.joseph_fwd(rows_k, drr_k.density, 2, h, X), 10)
    t_k_copy = median_ms(lambda: J.joseph_fwd(rows_k, drr_k.density, 2, h, X), 10,
                         before=brick.clear_cache)
    log(f"[cube] joseph 200^2: max abs err {err:.3e}; joseph_fwd {t:.4f} ms (plain "
        f"{t_plain:.2f}, bound {b:.4f} by {by}); 1000^2: max abs err {err_k:.3e}; joseph_fwd "
        f"{t_k:.4f} ms with the bricked copy cached, {t_k_copy:.4f} ms making it anew")
    return dict(launches=launches, err=max(err, err_k), t=t, t_plain=t_plain, b=b, by=by,
                t_k=t_k)


def grid_sample_ms(rows, density, axis, h, n, time_ms=None):
    """One F.grid_sample (trilinear, zero padding) over the march's sample
    points: the library yardstick of joseph_fwd, without its weighted sum.
    ``time_ms`` times a call (default: median of 20 CUDA-event runs)."""
    import torch
    import torch.nn.functional as F

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    vol = density.permute(march_perm(axis)).contiguous()
    X, Y, Z = vol.shape
    cols = []
    for st in J.march_steps(rows, h, X, n):
        y, z = st["y"], st["z"]
        x = torch.full_like(y, st["k"])
        # grid_sample's (x, y, z) index (W, H, D) = the volume's (z, y, s) axes.
        cols.append(torch.stack([2 * z / (Z - 1) - 1, 2 * y / (Y - 1) - 1,
                                 2 * x / (X - 1) - 1], -1))
    grid = torch.stack(cols, 1)[None, :, :, None, :]  # (1, R, n, 1, 3)
    del cols
    inp = vol[None, None]

    def call():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    return time_ms(call) if time_ms is not None else median_ms(call, 20)


CH_KERNELS = ("joseph_fwd_ch", "joseph_bwd_rays_ch", "joseph_bwd_vol_ch")


def check_channels(label, rows, dens, lab, axis, h, n, g):
    """The three channel kernels against their plain versions: values to
    1e-4 * max, rows to 1e-3 * max|row|, the density gradient to 1e-4 * max."""
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    C = g.shape[0]
    return {
        "fwd_ch": check_close(f"joseph_fwd_ch {label}", J.joseph_fwd_ch(rows, dens, lab, axis, h, n, C),
                              J.joseph_fwd_ch_plain(rows, dens, lab, axis, h, n, C), 1e-4),
        "bwd_rays_ch": check_rows(f"joseph_bwd_rays_ch {label}",
                                  J.joseph_bwd_rays_ch(rows, dens, lab, axis, h, n, g),
                                  J.joseph_bwd_rays_ch_plain(rows, dens, lab, axis, h, n, g)),
        "bwd_vol_ch": check_close(f"joseph_bwd_vol_ch {label}",
                                  J.joseph_bwd_vol_ch(rows, g, lab, dens.shape, axis, h, n),
                                  J.joseph_bwd_vol_ch_plain(rows, g, lab, dens.shape, axis, h, n),
                                  1e-4),
    }


def channels_small(small, rot_g, trans_g, rng):
    """Phase 8a: the channel kernels against their plain versions on the
    random volume with a random 5-label map, at 5 channels and at 3 (labels
    3 and 4 drop), strides 1, 4 (axis 0), ~1.37, 0.5 (a plane-pair tie every
    other step) and ~0.26."""
    import torch

    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    dens = small.density
    lab = torch.tensor(rng.integers(0, 5, tuple(dens.shape)), dtype=torch.int32,
                       device=dens.device)
    _, ax = rays_of(small, rot_g, trans_g)
    X = dens.shape[ax]
    cases = [("h=1", ax, 1.0, X), ("h=4 axis 0", 0, 4.0, -(-dens.shape[0] // 4)),
             ("h~1.37", ax, *raymarch_steps(X, 47)),
             ("h=0.5", ax, *raymarch_steps(X, 2 * X - 1, allow_oversample=True)),
             ("h~0.26", ax, *raymarch_steps(X, 243, allow_oversample=True))]
    worst = {}
    for label, axis, h, n in cases:
        rows = jrays_of(small, rot_g, trans_g, axis, h)
        for C in (5, 3):
            g = torch.tensor(rng.normal(size=(C, rows.shape[1])), dtype=torch.float32,
                             device=rows.device)
            errs = check_channels(f"{label} C={C} 128x128x64", rows, dens, lab, axis, h, n, g)
            torch.cuda.synchronize()
            log(f"[channel kernels] {label} (h {h:.6f}, {n} steps), {C} channels: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def channels_full(T, subject, rot0, trans, kw, rng):
    """Phase 8b: joseph and trilinear channel renders of the full CT with its
    7 labels at 200x200; each kernel against its plain version at every ray;
    one backward of sum_c w_c sum img_c**2 to density and pose with exact
    launch counts."""
    import numpy as np
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    w = torch.tensor(np.random.default_rng(4).uniform(0.5, 1.5, 7), dtype=torch.float32,
                     device=subject.device)
    out = {"launches": dict.fromkeys(CH_KERNELS, 0), "errs": {}}
    for renderer in ("joseph", "trilinear"):
        drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer=renderer)
        img = drr(rot0, trans, mask_to_channels=True, **kw)
        if img.shape != (1, 7, 200, 200) or not torch.isfinite(img).all():
            raise AssertionError(f"bad {renderer} channel render {tuple(img.shape)}")
        err_sum = check_close(f"{renderer} channel sum vs scalar render",
                              img.sum(1, keepdim=True), drr(rot0, trans, **kw), 1e-4)
        src, tgt = drr.detector(T.convert(rot0, trans, **kw))
        axis = int(torch.argmin(drr.worst_ratios(drr.affine_inverse(src),
                                                 drr.affine_inverse(tgt))))
        X = drr.density.shape[axis]
        if renderer == "joseph":
            h = float(drr.joseph_steps[axis])
            n = int(-(-X // drr.joseph_steps[axis]))
        else:
            h, n = raymarch_steps(X, 500)
        rows = jrays_of(drr, rot0, trans, axis, h)
        dens, lab = drr.density, drr.mask
        err_img = check_close(f"{renderer} channel render vs plain", img.reshape(7, -1),
                              J.joseph_fwd_ch_plain(rows, dens, lab, axis, h, n, 7), 1e-4)
        g = torch.tensor(rng.normal(size=(7, rows.shape[1])), dtype=torch.float32,
                         device=dens.device)
        errs = check_channels(f"{renderer} 512x512x133 @200^2", rows, dens, lab, axis, h, n, g)
        errs["fwd_ch"] = max(errs["fwd_ch"], err_img)

        J.reset_launch_counts()
        rot_p = rot0.clone().requires_grad_(True)
        trans_p = trans.clone().requires_grad_(True)
        dens_p = dens.clone().requires_grad_(True)
        img_p = drr.render(dens_p, *drr.detector(T.convert(rot_p, trans_p, **kw)),
                           mask_to_channels=True)
        (w[None, :, None] * img_p ** 2).sum().backward()
        torch.cuda.synchronize()
        launches = joseph_launches()
        log(f"[channels] {renderer} backward launches {launches}")
        expect_launches(f"{renderer} channel backward", launches,
                        {"joseph_fwd_ch": 1, "joseph_bwd_rays_ch": 1, "joseph_bwd_vol_ch": 1,
                         "joseph_fwdgrad": 0, "joseph_fwd": 0, "joseph_fwd_max": 0,
                         "joseph_bwd_rays": 0, "joseph_bwd_vol": 0})
        pose_grad = torch.cat([rot_p.grad, trans_p.grad], -1)
        if not (torch.isfinite(pose_grad).all() and pose_grad.abs().max() > 0):
            raise AssertionError(f"{renderer} channel pose gradient {pose_grad.tolist()}")
        g_img = (2 * w[:, None] * img_p.detach().reshape(7, -1))
        errs["bwd_vol_ch"] = max(errs["bwd_vol_ch"], check_close(
            f"{renderer} channel density gradient vs plain", dens_p.grad,
            J.joseph_bwd_vol_ch_plain(rows, g_img, lab, dens.shape, axis, h, n), 1e-4))
        for k in CH_KERNELS:
            out["launches"][k] += launches[k]
        for k, v in errs.items():
            out["errs"][k] = max(out["errs"].get(k, 0.0), v)
        sums = img.sum(dim=(2, 3))[0].tolist()
        log(f"[channels] {renderer} axis {axis}, h {h:g}: shape {tuple(img.shape)}, channel sums "
            + ", ".join(f"{s:.1f}" for s in sums) + f"; channel sum vs scalar {err_sum:.3e}; "
            + ", ".join(f"{k} vs plain {v:.3e}" for k, v in errs.items())
            + f" (density gradient max {dens_p.grad.abs().max().item():.3e}); pose gradient "
            + f"{[round(x, 4) for x in pose_grad[0].tolist()]}")
        out.update(drr=drr, rows=rows, axis=axis, h=h, n=n)  # the trilinear one is kept
    return out


def channels_siddon(T, subject, rot0, trans, kw):
    """Phase 8c: Siddon channels at full width on the oracle, no kernel launched."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import siddon as K

    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0)
    K.reset_launch_counts()
    img = drr(rot0, trans, mask_to_channels=True, **kw)
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in K.KERNELS if fn.launches}
    if launched or img.shape != (1, 7, 200, 200) or not torch.isfinite(img).all():
        raise AssertionError(f"Siddon channels: shape {tuple(img.shape)}, launches {launched}")
    # The oracle against siddon_fwd's render, as tests/test_torch_siddon.py holds them.
    err = check_close("Siddon channel sum vs siddon_fwd", img.sum(1, keepdim=True),
                      drr(rot0, trans, **kw), 1e-3)
    log(f"[channels] siddon (oracle, no kernel launched): channel sum vs siddon_fwd {err:.3e} "
        f"(image max {img.sum(1).max().item():.3f})")
    return err


def subsample_full_width(T, subject, rot0, trans, kw, drr_t):
    """Phase 8d: p_subsample=0.1, trilinear at full width: the full render at
    the 4,000 sampled pixels exactly, 0 elsewhere, with and without channels;
    one pose backward; its render time against the full render's."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J

    drr_s = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer="trilinear",
                  p_subsample=0.1)
    idx = drr_s.detector.subsample_index
    keep = torch.zeros(200 * 200, dtype=torch.bool, device=idx.device)
    keep[idx] = True
    for channels in (False, True):
        s = drr_s(rot0, trans, mask_to_channels=channels, **kw)
        f = drr_t(rot0, trans, mask_to_channels=channels, **kw)
        C = s.shape[1]
        s, f = s.reshape(C, -1), f.reshape(C, -1)
        if not torch.equal(s[:, idx], f[:, idx]) or torch.count_nonzero(s[:, ~keep]):
            raise AssertionError(f"p_subsample render (channels {channels}): max diff "
                                 f"{(s[:, idx] - f[:, idx]).abs().max().item():.3e}, "
                                 f"{int(torch.count_nonzero(s[:, ~keep]))} unsampled nonzero")
    J.reset_launch_counts()
    rot_p = rot0.clone().requires_grad_(True)
    (drr_s(rot_p, trans, **kw) ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = joseph_launches()
    if launches["joseph_fwdgrad"] != 1 or not (torch.isfinite(rot_p.grad).all()
                                                and rot_p.grad.abs().max() > 0):
        raise AssertionError(f"p_subsample pose backward: {launches}, {rot_p.grad.tolist()}")
    t_sub = median_ms(lambda: drr_s(rot0, trans, **kw), 20)
    t_full = median_ms(lambda: drr_t(rot0, trans, **kw), 20)
    log(f"[subsample] p=0.1 ({idx.numel()} rays): equal to the full render at its pixels, 0 "
        f"elsewhere, with and without channels; pose backward launches joseph_fwdgrad 1; "
        f"render {t_sub:.3f} ms against the full render's {t_full:.3f} ms")
    return t_sub, t_full


def channel_timings(ch):
    """Phase 8e: each channel kernel at 200^2 with 7 channels (the trilinear
    render's rows), its plain version and its bound."""
    import numpy as np
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J

    rows, axis, h, n = ch["rows"], ch["axis"], ch["h"], ch["n"]
    dens, lab = ch["drr"].density, ch["drr"].mask
    g = torch.tensor(np.random.default_rng(5).normal(size=(7, rows.shape[1])),
                     dtype=torch.float32, device=dens.device)
    b = channel_bounds(7)
    fns = {
        "fwd_ch": (lambda: J.joseph_fwd_ch(rows, dens, lab, axis, h, n, 7),
                   lambda: J.joseph_fwd_ch_plain(rows, dens, lab, axis, h, n, 7)),
        "bwd_rays_ch": (lambda: J.joseph_bwd_rays_ch(rows, dens, lab, axis, h, n, g),
                        lambda: J.joseph_bwd_rays_ch_plain(rows, dens, lab, axis, h, n, g)),
        "bwd_vol_ch": (lambda: J.joseph_bwd_vol_ch(rows, g, lab, dens.shape, axis, h, n),
                       lambda: J.joseph_bwd_vol_ch_plain(rows, g, lab, dens.shape, axis, h, n)),
    }
    times = {}
    for name, (kernel, plain) in fns.items():
        bnd, by = march_bound(rows, dens, axis, h, n, **b[name])
        times[name] = (median_ms(kernel, 20), median_ms(plain, 2, 1), bnd, by)
        log(f"[time] joseph_{name} {times[name][0]:.4f} ms (plain {times[name][1]:.2f}, bound "
            f"{bnd:.4f} by {by}) at 200^2 rays, 7 channels, axis {axis}, h {h:g}")
    return times


def main(argv) -> int:
    parser = argparse.ArgumentParser(description="Drive diffdrr_tpu_torch on one CUDA card.")
    parser.add_argument("--profile", type=Path, metavar="OUT",
                        help="profile registration and reconstruction steps; write "
                             "the tables to OUT")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.data import Image, Subject, _REORIENT, canonicalize
    from diffdrr_tpu_torch.ops.kernels import brick, build
    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.parallel import make_reconstruction_step
    from diffdrr_tpu_torch.registration import make_registration_step

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. Environment ---------------------------------------------------------
    card = card_line()
    log(f"[env] {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. Build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds or 'cached'})")

    # 3. Kernels vs plain, random volume -------------------------------------
    rng = np.random.default_rng(0)
    vol = rng.uniform(0.0, 1.0, (128, 128, 64)).astype(np.float32)
    affine = np.diag([1.5, 1.5, 2.5, 1.0])
    subj = canonicalize(Subject(volume=Image(vol, affine), density=Image(vol, affine),
                                reorient=_REORIENT["AP"].copy()))
    small = T.DRR(subj.to(dev), sdd=1020.0, height=64, delx=4.0)
    rot_g = torch.tensor([[0.0237, 1.5963, -0.0191]], device=dev)
    trans_g = torch.tensor([[1.37, 851.3, -2.11]], device=dev)
    rows, ax = rays_of(small, rot_g, trans_g)
    e1 = check_close("siddon_fwd 128x128x64", K.siddon_fwd(rows, small.density, ax),
                     K.siddon_fwd_plain(rows, small.density, ax), 1e-4)
    # The bricked copy serves every march axis: axes 0 and 2 pinned.
    for axis in (0, 2):
        rows_a, _ = rays_of(small, rot_g, trans_g, axis)
        e1 = max(e1, check_close(f"siddon_fwd axis {axis} 128x128x64",
                                 K.siddon_fwd(rows_a, small.density, axis),
                                 K.siddon_fwd_plain(rows_a, small.density, axis), 1e-4))
    # The fused kernel (G lanes a ray on the bricked copy) at the auto axis and
    # at axes 0 and 2, and a repeat that must give the same bits.
    e2 = 0.0
    for axis in sorted({ax, 0, 2}):
        rows_a, _ = rays_of(small, rot_g, trans_g, axis)
        fused = K.siddon_fwdgrad(rows_a, small.density, axis)
        e2 = max(e2, check_fused(f"siddon_fwdgrad axis {axis} 128x128x64", fused,
                                 K.siddon_fwdgrad_plain(rows_a, small.density, axis)))
        check_repeat(f"siddon_fwdgrad axis {axis}", fused,
                     K.siddon_fwdgrad(rows_a, small.density, axis))
    dens_s = small.density
    g_s = torch.tensor(rng.normal(size=rows.shape[1]), dtype=torch.float32, device=dev)
    mip_s = K.siddon_fwd_max(rows, dens_s, ax)
    e3 = check_max("siddon_fwd_max 128x128x64", mip_s, K.siddon_fwd_max_plain(rows, dens_s, ax))
    e4, e5 = {}, {}
    for mode, arg_s in (("sum", None), ("mip", mip_s[1])):
        e4[mode] = check_fused(f"siddon_bwd_rays[{mode}] 128x128x64",
                               K.siddon_bwd_rays(rows, dens_s, ax, g_s, arg_s),
                               K.siddon_bwd_rays_plain(rows, dens_s, ax, g_s, arg_s))
        e5[mode] = check_close(f"siddon_bwd_vol[{mode}] 128x128x64",
                               K.siddon_bwd_vol(rows, g_s, dens_s.shape, ax, arg_s),
                               K.siddon_bwd_vol_plain(rows, g_s, dens_s.shape, ax, arg_s), 1e-4)
    torch.cuda.synchronize()
    log(f"[kernels] axis {ax}: siddon_fwd max abs err {e1:.3e}, "
        f"siddon_fwdgrad max abs err {e2:.3e}, siddon_fwd_max {e3:.3e} (argmax exact, "
        f"{int((mip_s[1] >= 0).sum())} rays with a maximum), siddon_bwd_rays sum "
        f"{e4['sum']:.3e} mip {e4['mip']:.3e}, siddon_bwd_vol sum {e5['sum']:.3e} "
        f"mip {e5['mip']:.3e}")
    jsmall = joseph_small(small, rot_g, trans_g, rng)

    # 4. Main path at full size ----------------------------------------------
    t0 = time.perf_counter()
    subject = T.load_example_ct()
    log(f"[main] example CT {tuple(subject.density.data.shape)} loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0)
    rot0 = torch.tensor(BENCH_ROT, device=dev)
    trans = torch.tensor(BENCH_TRANS, device=dev)
    kw = dict(parameterization="euler_angles", convention="ZXY")

    K.reset_launch_counts()
    brick.clear_cache()
    brick.brick_density.launches = 0
    target = drr(rot0, trans, axis=2, **kw)
    auto = drr(rot0, trans, **kw)
    init_fn, step_fn = make_registration_step(drr, target, "euler_angles", "ZXY",
                                              lr_rotation=1e-3, lr_translation=1e-1)
    params, opt = init_fn(rot0, trans + 5.0)
    scores, step_ms = [], []
    for _ in range(N_REG_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, score = step_fn(params, opt)
        end.record()
        scores.append(score)
        step_ms.append((start, end))
    torch.cuda.synchronize()
    main_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    main_launches["brick_copy"] = brick.brick_density.launches
    step_ms = [s.elapsed_time(e) for s, e in step_ms]
    scores = torch.stack(scores).tolist()
    log(f"[main] launches {main_launches}, slab escapes {drr.siddon_escapes}")
    if (min(main_launches["siddon_fwd"], main_launches["siddon_fwdgrad"]) < 1
            or drr.siddon_escapes != 0):
        raise AssertionError("the main path did not run through every kernel")
    if main_launches["siddon_bwd_vol"] or main_launches["siddon_bwd_rays"]:
        raise AssertionError("registration launched a density or two-pass backward")
    if main_launches["brick_copy"] != 1:  # one CT: its bricked copy made once
        raise AssertionError(f"registration bricked its CT {main_launches['brick_copy']} times")
    if target.shape != (1, 1, 200, 200) or not torch.isfinite(target).all():
        raise AssertionError(f"bad render {tuple(target.shape)}")
    check_close("auto-axis render", auto, target, 1e-6)
    if not (scores[-1] > scores[0] and np.isfinite(scores).all()):
        raise AssertionError(f"registration score did not rise: {scores[0]} -> {scores[-1]}")
    t_err = (params["translation"].detach() - trans)[0].tolist()
    r_err = (params["rotation"].detach() - rot0).abs().max().item()
    log(f"[main] registration {N_REG_STEPS} steps: NCC {scores[0]:.5f} -> {scores[-1]:.5f}; "
        f"translation error (x, y, z) from (5, 5, 5) to "
        f"({t_err[0]:.3f}, {t_err[1]:.3f}, {t_err[2]:.3f}) mm, max rotation error "
        f"{r_err:.2e} rad")

    rows_m, ax_m = rays_of(drr, rot0, trans, axis=2)
    err_fwd = check_close("siddon_fwd 512x512x133 @200^2", target.reshape(-1),
                          K.siddon_fwd_plain(rows_m, drr.density, ax_m), 1e-4)
    rows_r, ax_r = rays_of(drr, params["rotation"].detach(), params["translation"].detach())
    err_fg = check_fused("siddon_fwdgrad 512x512x133 @200^2",
                         K.siddon_fwdgrad(rows_r, drr.density, ax_r),
                         K.siddon_fwdgrad_plain(rows_r, drr.density, ax_r))
    log(f"[main] render vs plain max abs err {err_fwd:.3e} (image max "
        f"{target.max().item():.3f}); fused rows vs plain {err_fg:.3e}")

    # 6a. Timings at the main path's shapes ----------------------------------
    t_fwd = median_ms(lambda: K.siddon_fwd(rows_m, drr.density, ax_m), 20)
    t_fwd_copy = median_ms(lambda: K.siddon_fwd(rows_m, drr.density, ax_m), 20,
                           before=brick.clear_cache)
    t_fwd_plain = median_ms(lambda: K.siddon_fwd_plain(rows_m, drr.density, ax_m), 3, 1)
    t_fg = median_ms(lambda: K.siddon_fwdgrad(rows_r, drr.density, ax_r), 20)
    t_fg_copy = median_ms(lambda: K.siddon_fwdgrad(rows_r, drr.density, ax_r), 20,
                          before=brick.clear_cache)
    t_fg_plain = median_ms(lambda: K.siddon_fwdgrad_plain(rows_r, drr.density, ax_r), 3, 1)
    t_render = median_ms(lambda: drr(rot0, trans, **kw), 20)
    # The auto axis reads three ratios back to the host every render.
    src0, tgt0 = drr.detector(T.convert(rot0, trans, **kw))
    sv0, tv0 = drr.affine_inverse(src0), drr.affine_inverse(tgt0)
    t_axis = median_host_ms(lambda: drr.worst_ratios(sv0, tv0).tolist(), 50)
    b_fwd, by_fwd = bound(rows_m, drr.density, ax_m, **FWD_BOUND)
    b_fg, by_fg = bound(rows_r, drr.density, ax_r, **FWDGRAD_BOUND)
    t_step = statistics.median(step_ms[5:])
    log(f"[time] siddon_fwd axis {ax_m} {t_fwd:.4f} ms (plain {t_fwd_plain:.2f}, bound "
        f"{b_fwd:.4f} by {by_fwd}); siddon_fwdgrad axis {ax_r} {t_fg:.4f} ms with the bricked "
        f"copy cached, {t_fg_copy:.4f} ms making it anew (plain {t_fg_plain:.2f}, bound "
        f"{b_fg:.4f} by {by_fg})")
    log(f"[time] render 200^2 (auto axis) {t_render:.3f} ms; axis choice with its host "
        f"sync {t_axis:.4f} ms; registration step median {t_step:.3f} ms "
        f"(steps 6..{N_REG_STEPS})")

    if args.profile is not None:
        args.profile.parent.mkdir(parents=True, exist_ok=True)
        args.profile.write_text(card + "\n")

        def reg_step():
            nonlocal params, opt
            params, opt, _ = step_fn(params, opt)

        profile_steps(reg_step, "registration", t_step, args.profile, kernel="siddon_fwdgrad")
    # 4b. MIP at full size ---------------------------------------------------
    K.reset_launch_counts()
    rot_p = rot0.clone().requires_grad_(True)
    trans_p = trans.clone().requires_grad_(True)
    dens_p = drr.density.clone().requires_grad_(True)
    src_p, tgt_p = drr.detector(T.convert(rot_p, trans_p, **kw))
    mip = drr.render(dens_p, src_p, tgt_p, reducefn="max")
    torch.sum(mip ** 2).backward()

    def pose_grad(fused):
        r, t = rot0.clone().requires_grad_(True), trans.clone().requires_grad_(True)
        torch.sum(drr(r, t, fused_pose_bwd=fused, **kw) ** 2).backward()
        return torch.cat([r.grad, t.grad], -1)

    pg_fused, pg_two = pose_grad(True), pose_grad(False)
    torch.cuda.synchronize()
    mip_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    log(f"[mip] launches {mip_launches}, slab escapes {drr.siddon_escapes}")
    if drr.siddon_escapes != 0 or min(mip_launches[n] for n in (
            "siddon_fwd_max", "siddon_bwd_rays", "siddon_bwd_vol")) < 1:
        raise AssertionError("the MIP path did not run through its kernels")
    if not (torch.isfinite(mip).all() and torch.isfinite(dens_p.grad).all()
            and torch.isfinite(rot_p.grad).all() and torch.isfinite(trans_p.grad).all()):
        raise AssertionError("MIP render or gradients not finite")
    mip_ref = K.siddon_fwd_max_plain(rows_m, drr.density, ax_m)
    err_max = check_close("MIP render 512x512x133 @200^2", mip.reshape(-1).detach(),
                          mip_ref[0], 1e-4)
    err_max = max(err_max, check_max("siddon_fwd_max 512x512x133 @200^2",
                                     K.siddon_fwd_max(rows_m, drr.density, ax_m), mip_ref))
    g_mip = (2 * mip).reshape(-1).detach()
    arg_m = mip_ref[1]
    err_br = check_fused("siddon_bwd_rays[mip] 512x512x133 @200^2",
                         K.siddon_bwd_rays(rows_m, drr.density, ax_m, g_mip, arg_m),
                         K.siddon_bwd_rays_plain(rows_m, drr.density, ax_m, g_mip, arg_m))
    ref_vol = K.siddon_bwd_vol_plain(rows_m, g_mip, drr.density.shape, ax_m, arg_m)
    err_bv_mip = check_close("MIP density gradient 512x512x133", dens_p.grad, ref_vol, 1e-4)
    err_pose = check_close("pose gradient, fused_pose_bwd=False vs fused", pg_two, pg_fused,
                           1e-5)
    log(f"[mip] render vs plain max abs err {err_max:.3e} (image max "
        f"{mip.max().item():.3f}, {int((arg_m >= 0).sum())} of {arg_m.numel()} rays with a "
        f"maximum); rows vs plain {err_br:.3e}; density gradient vs plain "
        f"{err_bv_mip:.3e}; two-pass vs fused pose gradient {err_pose:.3e} (max "
        f"{pg_fused.abs().max().item():.3e})")
    del rot_p, trans_p, dens_p, src_p, tgt_p, mip, ref_vol

    # 4c. Reconstruction at full size ---------------------------------------
    thetas = np.linspace(0, np.pi, N_VIEWS, endpoint=False)
    rot_v = torch.tensor(np.stack([thetas, np.full(N_VIEWS, np.pi / 2), np.zeros(N_VIEWS)], 1),
                         dtype=torch.float32, device=dev)
    trans_v = torch.tensor(BENCH_TRANS * N_VIEWS, device=dev)
    K.reset_launch_counts()
    brick.clear_cache()
    brick.brick_density.launches = 0
    measured = drr(rot_v, trans_v, **kw)
    init_fn, recon_step = make_reconstruction_step(drr, lr=RECON_LR)
    dens_r, opt_r = init_fn(torch.zeros_like(drr.density))
    losses, recon_ms = [], []
    for _ in range(N_RECON_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dens_r, opt_r, loss = recon_step(dens_r, opt_r, rot_v, trans_v, measured)
        end.record()
        losses.append(loss)
        recon_ms.append((start, end))
    torch.cuda.synchronize()
    recon_launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    recon_launches["brick_copy"] = brick.brick_density.launches
    recon_ms = [s.elapsed_time(e) for s, e in recon_ms]
    losses = torch.stack(losses).tolist()
    log(f"[recon] launches {recon_launches}, slab escapes {drr.siddon_escapes}")
    # The true density's copy for the measured images, then one a step:
    # Adam writes the density in place.
    want = {"siddon_fwd": N_RECON_STEPS + 1, "siddon_bwd_vol": N_RECON_STEPS,
            "siddon_fwdgrad": 0, "brick_copy": N_RECON_STEPS + 1}
    if drr.siddon_escapes != 0 or any(recon_launches[k] != v for k, v in want.items()):
        raise AssertionError(f"reconstruction launches {recon_launches}, want {want}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and torch.isfinite(dens_r).all()):
        raise AssertionError(f"reconstruction loss did not fall: {losses[0]} -> {losses[-1]}")
    rmse = torch.sqrt(torch.mean((dens_r.detach() - drr.density) ** 2)).item()
    t_recon = statistics.median(recon_ms[2:])
    if args.profile is not None:
        def rec_step():
            nonlocal dens_r, opt_r
            dens_r, opt_r, _ = recon_step(dens_r, opt_r, rot_v, trans_v, measured)

        profile_steps(rec_step, "reconstruction", t_recon, args.profile)
    # Its kernels against their plain versions at all 8 views (320,000 rays).
    rows_v, ax_v = rays_of(drr, rot_v, trans_v)
    with torch.no_grad():
        img_v = drr.render(dens_r, *drr.detector(T.convert(rot_v, trans_v, **kw)))
    g_v = (2 * (img_v.reshape(measured.shape) - measured) / measured.numel()).reshape(-1)
    err_fv = check_close("siddon_fwd 8 views", K.siddon_fwd(rows_v, dens_r.detach(), ax_v),
                         K.siddon_fwd_plain(rows_v, dens_r.detach(), ax_v), 1e-4)
    err_bv = check_close("siddon_bwd_vol 8 views",
                         K.siddon_bwd_vol(rows_v, g_v, drr.density.shape, ax_v),
                         K.siddon_bwd_vol_plain(rows_v, g_v, drr.density.shape, ax_v), 1e-4)
    log(f"[recon] {N_VIEWS} views x 200^2 rays, axis {ax_v}, {N_RECON_STEPS} Adam steps "
        f"(lr {RECON_LR}) from zero: loss {losses[0]:.5g} -> {losses[-1]:.5g}; voxel RMSE "
        f"vs the true density {rmse:.5g} (true density RMS "
        f"{torch.sqrt(torch.mean(drr.density ** 2)).item():.5g}); step median "
        f"{t_recon:.3f} ms (steps 3..{N_RECON_STEPS}); siddon_fwd vs plain {err_fv:.3e}, "
        f"siddon_bwd_vol vs plain {err_bv:.3e}")

    # 6b. Timings of the new kernels ----------------------------------------
    g_m = torch.tensor(rng.normal(size=rows_m.shape[1]), dtype=torch.float32, device=dev)
    t_max = median_ms(lambda: K.siddon_fwd_max(rows_m, drr.density, ax_m), 20)
    t_max_plain = median_ms(lambda: K.siddon_fwd_max_plain(rows_m, drr.density, ax_m), 3, 1)
    t_br = median_ms(lambda: K.siddon_bwd_rays(rows_m, drr.density, ax_m, g_m), 20)
    t_br_plain = median_ms(lambda: K.siddon_bwd_rays_plain(rows_m, drr.density, ax_m, g_m), 3, 1)
    t_br_mip = median_ms(lambda: K.siddon_bwd_rays(rows_m, drr.density, ax_m, g_m, arg_m), 20)
    shape = drr.density.shape
    t_bv = median_ms(lambda: K.siddon_bwd_vol(rows_v, g_v, shape, ax_v), 20)
    t_bv_alone = scatter_alone_ms("siddon", "siddon_bwd_vol", rows_v, g_v, shape, ax_v)
    t_bv_plain = median_ms(lambda: K.siddon_bwd_vol_plain(rows_v, g_v, shape, ax_v), 2, 1)
    t_zero = median_ms(lambda: torch.zeros(shape, device=dev), 20)
    dens_v = dens_r.detach()
    # siddon_fwd with the density's bricked copy cached (registration, a
    # render) and made anew in each call (a reconstruction step), the copy
    # alone, and the plain version, at the recon cell's 320,000 rays.
    t_fv = median_ms(lambda: K.siddon_fwd(rows_v, dens_v, ax_v), 20)
    t_fv_copy = median_ms(lambda: K.siddon_fwd(rows_v, dens_v, ax_v), 20,
                          before=brick.clear_cache)
    t_copy = median_ms(lambda: brick.brick_density(dens_v), 20)
    t_copy_plain = median_ms(lambda: brick.brick_density_plain(dens_v), 20)
    copy_v = brick.brick_density(dens_v).data
    if not torch.equal(copy_v, brick.brick_density_plain(dens_v).data):
        raise AssertionError("brick_copy differs from its plain version on the recon density")
    # The copy's bound: the density read once and the padded copy written once.
    b_copy, by_copy = roofline(4 * (dens_v.numel() + copy_v.numel()), 0)
    del copy_v
    t_fv_plain = median_ms(lambda: K.siddon_fwd_plain(rows_v, dens_v, ax_v), 1, 1)
    b_fv, by_fv = bound(rows_v, dens_v, ax_v, **FWD_BOUND)
    # The scatter with the march axis pinned to 0 (stride 512 x 133, not 1),
    # one 200x200 view at the main pose.
    rows_0, _ = rays_of(drr, rot0, trans, axis=0)
    g_0 = torch.tensor(rng.normal(size=rows_0.shape[1]), dtype=torch.float32, device=dev)
    err_bv0 = check_close("siddon_bwd_vol axis 0 @200^2", K.siddon_bwd_vol(rows_0, g_0, shape, 0),
                          K.siddon_bwd_vol_plain(rows_0, g_0, shape, 0), 1e-4)
    t_bv0 = median_ms(lambda: K.siddon_bwd_vol(rows_0, g_0, shape, 0), 20)
    t_bv0_alone = scatter_alone_ms("siddon", "siddon_bwd_vol", rows_0, g_0, shape, 0)
    b_max, by_max = bound(rows_m, drr.density, ax_m, **FWD_MAX_BOUND)
    b_br, by_br = bound(rows_m, drr.density, ax_m, **BWD_RAYS_BOUND)
    b_br_mip, by_br_mip = bound(rows_m, drr.density, ax_m, arg=arg_m,
                                **dict(BWD_RAYS_BOUND, ray_bytes=36 + 4 + 4 + 36))
    b_bv, by_bv = bound(rows_v, drr.density, ax_v, **BWD_VOL_BOUND)
    zero_bytes = drr.density.numel() * 4
    log(f"[time] siddon_fwd_max {t_max:.4f} ms (plain {t_max_plain:.2f}, bound {b_max:.4f} by "
        f"{by_max}); siddon_bwd_rays sum {t_br:.4f} ms (plain {t_br_plain:.2f}, bound "
        f"{b_br:.4f} by {by_br}), mip {t_br_mip:.4f} ms (bound {b_br_mip:.4f} by {by_br_mip}); "
        f"all at 200^2 rays, axis {ax_m}")
    log(f"[time] siddon_bwd_vol at {rows_v.shape[1]} rays {t_bv:.4f} ms with its zero fill, "
        f"{t_bv_alone:.4f} ms alone ({int((g_v == 0).sum())} rays with g = 0; plain "
        f"{t_bv_plain:.2f}, bound {b_bv:.4f} by {by_bv}); the zero fill alone "
        f"{t_zero:.4f} ms ({zero_bytes / 1e6:.1f} MB, bound "
        f"{zero_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); siddon_fwd at the same rays "
        f"{t_fv:.4f} ms (bound {b_fv:.4f} by {by_fv}); reconstruction step median "
        f"{t_recon:.3f} ms")
    log(f"[time] siddon_bwd_vol axis 0 (200^2, main pose) {t_bv0:.4f} ms with its zero fill, "
        f"{t_bv0_alone:.4f} ms alone; vs plain {err_bv0:.3e}")
    log(f"[time] siddon_fwd at {rows_v.shape[1]} rays {t_fv:.4f} ms with the bricked copy "
        f"cached, {t_fv_copy:.4f} ms making it anew (the copy alone {t_copy:.4f} ms by "
        f"brick_copy, equal to its plain version, which takes {t_copy_plain:.4f} ms; "
        f"{dens_v.numel() * 4 / 1e6:.1f} MB each way); plain {t_fv_plain:.2f}; at 200^2 "
        f"{t_fwd:.4f} ms cached, {t_fwd_copy:.4f} ms making it anew")
    del dens_r, dens_v, opt_r, measured, img_v, rows_v, g_v, rows_0, g_0
    del drr, target, auto, params, opt

    # 5. The 512^3 isotropic CT ----------------------------------------------
    t0 = time.perf_counter()
    cube = T.load_example_ct(shape=(512, 512, 512), spacing=(0.703125,) * 3)
    log(f"[cube] 512^3 CT loaded in {time.perf_counter() - t0:.1f} s")
    drr_c = T.DRR(cube, sdd=1020.0, height=200, delx=2.0)
    K.reset_launch_counts()
    img_c = drr_c(rot0, trans, axis=2, **kw)
    torch.cuda.synchronize()
    cube_launches = K.siddon_fwd.launches
    if cube_launches < 1 or not torch.isfinite(img_c).all():
        raise AssertionError("512^3 render did not run through siddon_fwd")
    rows_c, ax_c = rays_of(drr_c, rot0, trans, axis=2)
    err_c = check_close("siddon_fwd 512^3 @200^2", img_c.reshape(-1),
                        K.siddon_fwd_plain(rows_c, drr_c.density, ax_c), 1e-4)
    t_c = median_ms(lambda: K.siddon_fwd(rows_c, drr_c.density, ax_c), 20)
    t_c_plain = median_ms(lambda: K.siddon_fwd_plain(rows_c, drr_c.density, ax_c), 2, 1)
    b_c, by_c = bound(rows_c, drr_c.density, ax_c, **FWD_BOUND)
    log(f"[cube] 200^2: max abs err {err_c:.3e}; siddon_fwd {t_c:.4f} ms (plain "
        f"{t_c_plain:.2f}, bound {b_c:.4f} by {by_c})")

    drr_k = T.DRR(cube, sdd=1020.0, height=1000, delx=0.4)
    img_k = drr_k(rot0, trans, axis=2, **kw)
    rows_k, ax_k = rays_of(drr_k, rot0, trans, axis=2)
    err_k = check_close("siddon_fwd 512^3 @1000^2", img_k.reshape(-1),
                        K.siddon_fwd_plain(rows_k, drr_k.density, ax_k), 1e-4)
    t_k = median_ms(lambda: K.siddon_fwd(rows_k, drr_k.density, ax_k), 10)
    t_k_copy = median_ms(lambda: K.siddon_fwd(rows_k, drr_k.density, ax_k), 10,
                         before=brick.clear_cache)
    err_c = max(err_c, err_k)
    log(f"[cube] 1000^2: shape {tuple(img_k.shape)}, max abs err {err_k:.3e}; "
        f"siddon_fwd {t_k:.4f} ms with the bricked copy cached, {t_k_copy:.4f} ms making it "
        f"anew")

    # 7. Joseph and trilinear renderers ---------------------------------------
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    tri = trilinear_registration(T, subject, rot0, trans, kw, args.profile)
    jm = joseph_mip(T, subject, rot0, trans, kw, tri["rows_m"])
    err_frac = fractional_strides(tri["drr"], jm["drr"], rot0, trans, kw)
    err_jbv0 = joseph_axis0_scatter(jm["drr"], rot0, trans, rng)
    jc = joseph_cube(T, cube, rot0, trans, kw)
    del drr_c, drr_k, img_c, img_k, rows_c, rows_k, cube

    # 8. Per-structure channels and p_subsample --------------------------------
    ch_small = channels_small(small, rot_g, trans_g, rng)
    ch = channels_full(T, subject, rot0, trans, kw, rng)
    err_sid_ch = channels_siddon(T, subject, rot0, trans, kw)
    t_sub, t_full = subsample_full_width(T, subject, rot0, trans, kw, ch["drr"])
    ch_times = channel_timings(ch)
    del subject
    rec = trilinear_reconstruction(args.profile)

    # 7g. Timings of the Joseph kernels at their paths' shapes
    dens_m, rows_m, rows_r = tri["drr"].density, tri["rows_m"], tri["rows_r"]
    X = dens_m.shape[2]
    arg_j = jm["arg"]
    g_j = torch.tensor(rng.normal(size=rows_m.shape[1]), dtype=torch.float32, device=dev)
    jt = {
        "fwd": (lambda: J.joseph_fwd(rows_m, dens_m, 2, 1.0, X),
                lambda: J.joseph_fwd_plain(rows_m, dens_m, 2, 1.0, X),
                march_bound(rows_m, dens_m, 2, 1.0, X, **J_FWD_BOUND)),
        "fwdgrad": (lambda: J.joseph_fwdgrad(rows_r, dens_m, 2, 1.0, X),
                    lambda: J.joseph_fwdgrad_plain(rows_r, dens_m, 2, 1.0, X),
                    march_bound(rows_r, dens_m, 2, 1.0, X, **J_FWDGRAD_BOUND)),
        "fwd_max": (lambda: J.joseph_fwd_max(rows_m, dens_m, 2, 1.0, X),
                    lambda: J.joseph_fwd_max_plain(rows_m, dens_m, 2, 1.0, X),
                    march_bound(rows_m, dens_m, 2, 1.0, X, **J_FWD_MAX_BOUND)),
        "bwd_rays": (lambda: J.joseph_bwd_rays(rows_m, dens_m, 2, 1.0, X, g_j),
                     lambda: J.joseph_bwd_rays_plain(rows_m, dens_m, 2, 1.0, X, g_j),
                     march_bound(rows_m, dens_m, 2, 1.0, X, **J_BWD_RAYS_BOUND)),
        "bwd_rays_mip": (lambda: J.joseph_bwd_rays(rows_m, dens_m, 2, 1.0, X, g_j, arg_j),
                         lambda: J.joseph_bwd_rays_plain(rows_m, dens_m, 2, 1.0, X, g_j, arg_j),
                         march_bound(rows_m, dens_m, 2, 1.0, X, arg=arg_j,
                                     **dict(J_BWD_RAYS_BOUND, ray_bytes=36 + 4 + 4 + 28))),
        "bwd_vol": (lambda: J.joseph_bwd_vol(rec["rows_v"], rec["g_v"], rec["dens_shape"], 2,
                                             rec["h"], rec["n"]),
                    lambda: J.joseph_bwd_vol_plain(rec["rows_v"], rec["g_v"], rec["dens_shape"],
                                                   2, rec["h"], rec["n"]),
                    march_bound(rec["rows_v"], rec["density"], 2, rec["h"], rec["n"],
                                **J_BWD_VOL_BOUND)),
    }
    jtimes = {}
    for name, (kernel, plain, (b, by)) in jt.items():
        jtimes[name] = (median_ms(kernel, 20), median_ms(plain, 2, 1), b, by)
        log(f"[time] joseph_{name} {jtimes[name][0]:.4f} ms (plain {jtimes[name][1]:.2f}, bound "
            f"{b:.4f} by {by})")
    t_lib = grid_sample_ms(rows_m, dens_m, 2, 1.0, X)
    # The recon-CLI cell's 320,000 rays: the scatter alone and its zero fill
    # alone, and the forward it runs 21 times.
    rows_v, g_v, h_v, n_v = rec["rows_v"], rec["g_v"], rec["h"], rec["n"]
    t_jbv_alone = scatter_alone_ms("joseph", "joseph_bwd_vol", rows_v, g_v, rec["dens_shape"], 2,
                                   (h_v, n_v, int(J.is_blend(h_v))))
    t_jbv_res = scatter_alone_ms("joseph", "joseph_bwd_vol", rows_v, rec["g_res"],
                                 rec["dens_shape"], 2, (h_v, n_v, int(J.is_blend(h_v))))
    t_jzero = median_ms(lambda: torch.zeros(rec["dens_shape"], device=dev), 20)
    dens_v = rec["density"]
    t_jfv = median_ms(lambda: J.joseph_fwd(rows_v, dens_v, 2, h_v, n_v), 20)
    t_jfv_copy = median_ms(lambda: J.joseph_fwd(rows_v, dens_v, 2, h_v, n_v), 20,
                           before=brick.clear_cache)
    t_jcopy = median_ms(lambda: brick.brick_density(dens_v), 20)
    t_jfv_plain = median_ms(lambda: J.joseph_fwd_plain(rows_v, dens_v, 2, h_v, n_v), 1, 1)
    t_lib_v = grid_sample_ms(rows_v, dens_v, 2, h_v, n_v)
    b_jfv, by_jfv = march_bound(rows_v, dens_v, 2, h_v, n_v, **J_FWD_BOUND)
    t_jf_copy = median_ms(lambda: J.joseph_fwd(rows_m, dens_m, 2, 1.0, X), 20,
                          before=brick.clear_cache)
    t_jfg_copy = median_ms(lambda: J.joseph_fwdgrad(rows_r, dens_m, 2, 1.0, X), 20,
                           before=brick.clear_cache)
    log(f"[time] joseph_fwd and the rest at 200^2 rays of the main CT, axis 2, h = 1; "
        f"joseph_bwd_vol at {rec['rows_v'].shape[1]} rays with its zero fill; F.grid_sample "
        f"over the {rows_m.shape[1]} x {X} sample points (no weighted sum) {t_lib:.4f} ms; "
        f"trilinear registration step median {tri['t_step']:.3f} ms, trilinear reconstruction "
        f"step median {rec['t_step']:.3f} ms")
    log(f"[time] joseph_bwd_vol at {rows_v.shape[1]} rays {jtimes['bwd_vol'][0]:.4f} ms with its "
        f"zero fill, {t_jbv_alone:.4f} ms alone, {t_jbv_res:.4f} ms alone with the CLI's "
        f"cotangent ({int((rec['g_res'] == 0).sum())} rays with g = 0); the zero fill alone "
        f"{t_jzero:.4f} ms; joseph_fwd at the same rays {t_jfv:.4f} ms (bound {b_jfv:.4f} by "
        f"{by_jfv})")
    log(f"[time] joseph_fwd at {rows_v.shape[1]} rays {t_jfv:.4f} ms with the bricked copy "
        f"cached, {t_jfv_copy:.4f} ms making it anew (the copy alone {t_jcopy:.4f} ms); plain "
        f"{t_jfv_plain:.2f}; F.grid_sample over the {rows_v.shape[1]} x {n_v} sample points "
        f"{t_lib_v:.4f} ms; at 200^2 {jtimes['fwd'][0]:.4f} ms cached, {t_jf_copy:.4f} ms "
        f"making it anew")
    log(f"[time] joseph_fwdgrad at 200^2 {jtimes['fwdgrad'][0]:.4f} ms with the bricked copy "
        f"cached, {t_jfg_copy:.4f} ms making it anew (bound {jtimes['fwdgrad'][2]:.4f} by "
        f"{jtimes['fwdgrad'][3]})")

    # Records ----------------------------------------------------------------
    src = "diffdrr_tpu_torch/csrc/siddon.cu"
    kernels = [
        {"name": "siddon_fwd", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:189",
         "launches": main_launches["siddon_fwd"], "max_abs_err": err_fwd,
         "ms": t_fwd, "plain_ms": t_fwd_plain, "bound_ms": b_fwd, "bound_by": by_fwd,
         "library_ms": None},
        {"name": "siddon_fwdgrad", "route": "cuda", "design": fused_design("siddon.cuh"),
         "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:396",
         "launches": main_launches["siddon_fwdgrad"], "max_abs_err": max(err_fg, e2),
         "ms": t_fg, "ms_with_copy": t_fg_copy, "plain_ms": t_fg_plain, "bound_ms": b_fg,
         "bound_by": by_fg, "library_ms": None},
        {"name": "siddon_fwd[320k]", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:189",
         "launches": recon_launches["siddon_fwd"], "max_abs_err": err_fv,
         "ms": t_fv, "ms_with_copy": t_fv_copy, "plain_ms": t_fv_plain, "bound_ms": b_fv,
         "bound_by": by_fv, "library_ms": None},
        {"name": "brick_copy", "route": "cuda", "source": "diffdrr_tpu_torch/csrc/brick.cu",
         "replaces": "none: layout glue that siddon_fwd and joseph_fwd read",
         "launches": recon_launches["brick_copy"], "max_abs_err": 0.0,
         "ms": t_copy, "plain_ms": t_copy_plain, "bound_ms": b_copy, "bound_by": by_copy,
         "library_ms": None},
        {"name": "siddon_fwd[512^3]", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:573",
         "launches": cube_launches, "max_abs_err": err_c,
         "ms": t_c, "plain_ms": t_c_plain, "bound_ms": b_c, "bound_by": by_c,
         "library_ms": None},
        {"name": "siddon_fwd_max", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:189",
         "launches": mip_launches["siddon_fwd_max"], "max_abs_err": err_max,
         "ms": t_max, "plain_ms": t_max_plain, "bound_ms": b_max, "bound_by": by_max,
         "library_ms": None},
        {"name": "siddon_bwd_rays", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:248",
         "launches": mip_launches["siddon_bwd_rays"], "max_abs_err": max(err_br, err_pose),
         "ms": t_br, "plain_ms": t_br_plain, "bound_ms": b_br, "bound_by": by_br,
         "library_ms": None},
        {"name": "siddon_bwd_vol", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:501",
         "launches": recon_launches["siddon_bwd_vol"],
         "max_abs_err": max(err_bv, err_bv0, err_bv_mip, e5["sum"], e5["mip"]),
         "ms": t_bv, "plain_ms": t_bv_plain, "bound_ms": b_bv, "bound_by": by_bv,
         "library_ms": None},
    ]
    jsrc = "diffdrr_tpu_torch/csrc/joseph.cu"
    jpal = "diffdrr_tpu/ops/pallas/joseph.py"

    def jrec(name, key, replaces, launches, err, library_ms=None):
        ms, plain_ms, b, by = jtimes[key]
        return {"name": name, "route": "cuda", "source": jsrc, "replaces": f"{jpal}:{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "library_ms": library_ms}

    kernels += [
        jrec("joseph_fwd", "fwd", 376, tri["launches"]["joseph_fwd"],
             max(tri["err_fwd"], err_frac, jsmall["fwd"]), library_ms=t_lib),
        {"name": "joseph_fwd[320k]", "route": "cuda", "source": jsrc,
         "replaces": f"{jpal}:376", "launches": rec["launches"]["joseph_fwd"],
         "max_abs_err": rec["err_fv"], "ms": t_jfv, "ms_with_copy": t_jfv_copy,
         "plain_ms": t_jfv_plain, "bound_ms": b_jfv, "bound_by": by_jfv, "library_ms": t_lib_v},
        {"name": "joseph_fwd[512^3]", "route": "cuda", "source": jsrc,
         "replaces": f"{jpal}:487", "launches": jc["launches"], "max_abs_err": jc["err"],
         "ms": jc["t"], "plain_ms": jc["t_plain"], "bound_ms": jc["b"], "bound_by": jc["by"],
         "library_ms": None},
        jrec("joseph_fwd_max", "fwd_max", 376, jm["launches"]["joseph_fwd_max"],
             max(jm["err_max"], jsmall["fwd_max"])),
        dict(jrec("joseph_fwdgrad", "fwdgrad", 732, tri["launches"]["joseph_fwdgrad"],
                  max(tri["err_fg"], jsmall["fwdgrad_sum"], jsmall["fwdgrad_max"])),
             design=fused_design("joseph.cuh"), ms_with_copy=t_jfg_copy),
        jrec("joseph_bwd_rays", "bwd_rays", 600, jm["launches"]["joseph_bwd_rays"],
             max(jm["err_br"], jsmall["bwd_rays_sum"], jsmall["bwd_rays_mip"])),
        jrec("joseph_bwd_vol", "bwd_vol", 903, rec["launches"]["joseph_bwd_vol"],
             max(rec["err_bv"], jm["err_bv_mip"], err_jbv0, jsmall["bwd_vol_sum"],
                 jsmall["bwd_vol_mip"])),
    ]
    # Channel kernels: launches of phase 8b's two backwards (joseph, trilinear).
    jtimes.update(ch_times)
    kernels += [jrec(f"joseph_{key}", key, line, ch["launches"][f"joseph_{key}"],
                     max(ch["errs"][key], ch_small[key]))
                for key, line in (("fwd_ch", 376), ("bwd_rays_ch", 600), ("bwd_vol_ch", 903))]
    log(f"[channels] Siddon channel sum vs siddon_fwd {err_sid_ch:.3e}; p_subsample=0.1 render "
        f"{t_sub:.3f} ms, full render {t_full:.3f} ms")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
