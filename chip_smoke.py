#!/usr/bin/env python3
"""Drive diffdrr_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py                    # all phases, one card, ~5-7 minutes
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
     each axis with the same bits (its lanes combine in a fixed order), and
     siddon_fwd_max (which reads the bricked copy too) at axes 0 and 2;
  4. main path at full size: the 512x512x133 example CT, a 200x200 detector
     (sdd 1020 mm, 2 mm pixels), the bench pose; renders with the march axis
     pinned to 2 and chosen automatically, held against the plain version;
     then registration steps from translation + 5 mm (Adam, multiscale NCC),
     with the score rising, no density-gradient or two-pass launch, and the
     CT's bricked copy made once. Launch counts are zeroed before each path
     and read after it;
  4b. MIP at full size, same CT, detector and pose: a reducefn="max" render
     and one backward of sum(img**2) to the density and the pose, each
     kernel held against its plain version, one bricked copy (of the new
     density the MIP renders); a sum-mode pose backward with
     fused_pose_bwd=False (siddon_bwd_rays reading the CT's copy), equal to
     the fused one to the last bit;
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
     siddon_fwdgrad likewise at the main path's rays; siddon_fwd_max one
     call and back to back, its copy cached and made anew; siddon_bwd_rays
     in sum mode one call and back to back, against its plain version and
     equal to siddon_fwdgrad's rows times g;
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
     (joseph_fwd_max + joseph_bwd_rays), the two pose gradients equal (the
     values; the bits may differ in the sign of a zero); two bricked copies
     (of the new density and of the CT); then a sum-mode two-pass pose
     backward (fused_pose_bwd=False: joseph_fwd + joseph_bwd_rays' lanes,
     counted alone, reading the CT's cached copy: no copy made), equal to
     the fused one to the last bit;
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
     F.grid_sample over the same sample points as the library yardstick
     (of joseph_fwd and joseph_fwd_max); joseph_fwd_max also back to back,
     with its bricked copy made anew, and at a lateral pose (axis 0, the
     trilinear stride 1.024) against its plain version; joseph_bwd_rays in
     sum mode one call, back to back and at the lateral pose, against its
     plain version and equal to joseph_fwdgrad's rows times g;
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
     each channel kernel, no joseph_fwdgrad and one bricked copy of the
     density (joseph_fwd_ch makes it, joseph_bwd_rays_ch reads it);
  8c. Siddon channels at full width on the oracle (no Siddon kernel
     launched), the channel sum equal to siddon_fwd's render;
  8d. p_subsample=0.1, trilinear at full width: equal to the full render at
     its 4,000 pixels and 0 elsewhere, with and without channels; one pose
     backward; its render time beside the full render's;
  8e. timings of the channel kernels at 200^2 with 7 channels: one call
     and back to back, joseph_fwd_ch and joseph_bwd_rays_ch with their
     bricked copies cached and made anew.
  9. the registration CLI (diffdrr_tpu_torch.experiments.registration) at
     full width, through main(argv): a 512x512x128 CT, 200x200 detector;
  9a. --multiscale 0.25,0.5,1.0 --iters-per-scale 20,20,20 --lr-decay 0.1
     --polish-iters 20 --n-runs 2 (trilinear): exactly joseph_fwd 1 (the
     target), joseph_fwdgrad one a step (the warm-up run's too), no other
     kernel, and one bricked copy for all scales; each run's double
     geodesic below its start;
  9b. one serial Siddon run of 60 steps: siddon_fwd 1, siddon_fwdgrad one a
     step, one bricked copy, no slab escape;
  9c. --multistart --n-runs 4 --n-iters 60: joseph_fwdgrad one a batched
     step (warm-up included), joseph_fwd 3 (the target, each run's final
     scores); the restarts independent bit for bit (each one's trace,
     final pose and score unchanged when the other three starts are
     replaced); 4 single-pose runs from the same starts, their distance to
     the batched run's poses logged (batches of one and of four round
     differently on the card, and the float32 patch NCC amplifies it);
  9d. optimize_until from translation + 5 mm, at most 40 steps: with a tol
     never met it runs to max_iters, with the distance that run reached at
     step 20 it stops at the first step at or below it, as a replay of its
     steps shows;
  9e. a pose gradient with checkpoint_gradients=True equal to the plain one
     to the last bit, joseph_fwdgrad 2 and no bricked copy (the rerun in
     the backward reads the cached one); two cache_volume=False renders
     make two copies;
  9f. mutual information at 200^2 (three streamed chunks) against its
     dense formula on the card, value 1e-5 relative and gradient 1e-4 x
     max;
  9g. CUDA-event step times per scale and of the polish, of the serial
     Siddon step, and of a 4-pose multistart step against a single-pose
     step, beside the card's name and power limit.
 10. the rest of pose estimation at the registration CLI's full width (a
     512x512x128 CT, 200x200 detector, 2 mm pixels, sdd 1020), counts
     zeroed before each sub-phase:
 10a. --optimizer lbfgs (optax.lbfgs() in the port's copy): trilinear
     --n-runs 2 --n-iters 20, one Siddon serial run of 20 steps, and
     --multistart --n-runs 4 --n-iters 10; the fused pose kernel launched
     exactly once an evaluation (the line searches' evaluations, which the
     runs record step by step, plus each run's first), the forward once for
     the target and once for each multistart call's final scores, one
     bricked copy, nothing else; each serial run's loss non-increasing over
     its accepted steps (those that met the line search's sufficient
     decrease, up to its approximate-decrease allowance of 1e-6 relative)
     and lower at its last step than its first, its double geodesic logged;
     a Siddon evaluation past the slab guard renders on the oracle and
     counts in siddon_escapes in place of a launch; CUDA-event ms per step
     and per evaluation;
 10b. rotation_9d, rotation_10d and quaternion_adjugate: 10 Adam steps
     each from the true pose + 5 mm, the score rising, joseph_fwdgrad once
     a step and one bricked copy; special_procrustes' and the Jacobi
     eigenvector's backwards on 16 random rotations (their matrices and
     -q q^T, perturbed by N(0, 0.05)) on the card equal to the CPU's to
     1e-5 x max;
 10c. the pose-regressor trainer (batch 8): rotation_6d 20 steps saving
     every 10, a resume that starts at step 20 and runs 10 more, and
     rotation_10d 10 steps; joseph_fwd exactly once a step, one bricked
     copy a call, no pose kernel, the losses finite; ms per step; one
     forward and backward of the "default" and "large" presets at batch 8,
     256^2;
 10d. the scipy baseline (Nelder-Mead, 2 runs, maxiter 100): joseph_fwd
     exactly once a function evaluation and once for the target, one
     bricked copy; each run's final mm and seconds;
 10e. the pinhole camera of the main view: its projection matrix
     reprojects the CT's 8 corners onto perspective_projection within
     1e-2 px.
 11. several ranks (parallel/, profiling.py):
 11a. make_mesh() with nothing wired: a world of one on NCCL;
     make_sharded_render of 2 poses of the main cell, Siddon and
     trilinear, equal to DRR.__call__ bit for bit with one forward and one
     bricked copy each; the reconstruction CLI of phase 7d with --mesh,
     its launches as 7d's and its losses within 1e-6 relative of 7d's;
 11b. two ranks on the one card (NCCL refuses two ranks on one device, so
     gloo, on CUDA tensors), each a process of
     diffdrr_tpu_torch.experiments.parallel_check: the collectives gloo
     takes on CUDA tensors; renders split (1, 2) and (2, 1) equal to the
     unsharded card render bit for bit, the pose gradients of both within
     1e-5 x max; slab_sharded_siddon and slab_sharded_joseph on the kernels
     (use_pallas=True), 2 slabs of 256 planes along axis 0 at the lateral
     pose, against the unsharded kernel render (values 1e-4 x max; each
     ray's gradients 1e-3 x max, the slab's density gradient 3e-4 x max:
     float32 segment lengths round otherwise in slab-local coordinates; but
     for at most 2 rays and 8 voxels that round across a kink, within
     5e-2 and 0.15 x max), one
     forward, one fused pose kernel, one scatter and one bricked copy a
     call; the sharded Siddon reconstruction step on phase 4c's 8 views,
     (2, 1), 5 steps: the density equal on both ranks after every step, the
     losses within 1e-5 relative of phase 4c's, siddon_fwd, siddon_bwd_vol
     and brick_copy once a step and rank, CUDA-event ms a step and the
     collectives' ms alone (gloo through the host: no measure of NCCL);
 11c. profiling.trace around one sharded step names siddon_fwd's,
     siddon_bwd_vol's and brick_copy's kernels; render_cost of the main
     DRR gives siddon_fwd's bound of phase 6a exactly.

 12. visualization and scene export (host C++ meshers and QEM, the HTML
     scene, the animation frames, the tutorials), counts zeroed before each
     sub-phase, host milliseconds of each step logged:
 12a. the port's native libraries (diffdrr_tpu_torch/native, g++) built at
     once, each required (a failed build fails the run with g++'s message);
     the 512x512x133 CT loaded through the native HU transfer
     (hu_to_density counted) and a .nii.gz of a cut of it read back through
     the native gunzip;
 12b. drr_to_mesh with surface_nets and with marching_cubes on the full CT
     (threshold 300 HU): extract_largest, QEM decimation 0.25 (marching
     cubes), fill_holes(100), clean; surface_nets, taubin_smooth,
     marching_cubes and qem_decimate each called natively once; faces > 0,
     their indices in range, every vertex inside the volume's world
     bounding box; at 128x128x64 the native and NumPy meshers agree as
     tests/test_viz.py requires (vertex counts, vertices to the voxel,
     marching cubes' vertex sets to 1e-4, as nearest-vertex distances);
 12c. labelmap_to_mesh for each of the CT's labels 1-6, natively;
 12d. visualize_scene_html with the main cell's DRR (200^2, sdd 1020, 2 mm
     pixels, the bench pose): exactly one siddon_fwd and one brick_copy,
     the textured image equal to a direct drr(pose) bit for bit (and its
     8-bit texture to that render's), the file written and self-contained;
 12e. the 60 poses of a 60-step trilinear registration of the main cell:
     viz.animation_frames launches exactly joseph_fwd 60 and brick_copy 1,
     each frame equal to a direct render at its row's pose bit for bit;
     the rows through a CSV and experiments/gif.py's reader give the same
     poses;
 12f. the port's nine tutorials (diffdrr_tpu_torch/tutorials) at their
     default sizes on the card, each a subprocess with a timeout of its
     own (07_timing alone, after the others), each exiting 0 and printing
     "all checks passed".

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. In the record, ``brick_copy`` (the
bricked copy of the density that the forwards read; no TPU counterpart)
has an entry of its own, with the launches of phase 4c. The
two forwards' entries at 320,000 rays give ``ms`` with the copy already
made (as a registration or a render reads it) and ``ms_with_copy`` with a
fresh copy in each call, which is what a reconstruction step pays; the two
fused pose kernels' entries likewise at 200x200, with ``design`` naming
their layout (the bricked copy, G lanes a ray), as the channel ray
backward's, the channel and MIP forwards' and the two two-pass ray
backwards'; the channel entries, the MIP forwards' and the two-pass ray
backwards' also give ``ms_back_to_back``, the forwards ``ms_with_copy``,
joseph_fwd_max and joseph_bwd_rays their lateral pose's ``ms_lateral`` and
``ms_lateral_back_to_back``, the two-pass ray backwards ``ms_mip``.
``library_ms`` is one PyTorch call over the same samples: F.grid_sample
for the Joseph forwards; torch.ops.aten.grid_sampler_3d_backward's input
gradient (grad_output g * scale) for joseph_bwd_vol and joseph_bwd_vol_ch
(g the channel cotangent at each sample's label), its grid gradient for
joseph_bwd_rays and joseph_fwdgrad, and its nearest-mode input gradient at
the segments' midpoints (grad_output len * w * g) for siddon_bwd_vol.
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
# data, counted by hand from its header (diffdrr_tpu_torch/profiling.py has
# the counts, and the data's work: siddon_work, joseph_work).

N_REG_STEPS = 60
BENCH_ROT = [[0.01, 3.141592653589793 / 2 + 0.02, -0.01]]
BENCH_TRANS = [[0.0, 850.0, 0.0]]
# The lateral pose of the timing scripts (experiments/*_timing.py): march
# axis 0, the CT's 512 planes.
LATERAL_ROT = [[3.141592653589793 / 2 + 0.02, 0.01, -0.01]]
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
    from diffdrr_tpu_torch.profiling import SLAB_OPS, SLAB_RANGE_OPS, siddon_work

    steps, segments, voxels = siddon_work(rows, density, axis, arg)
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


def march_bound(rows, density, axis, h, n_steps, *, ray_bytes, sample_ops, ray_ops=0,
                writes_volume=False, arg=None, labels=False):
    """(bound_ms, bound_by) of a Joseph kernel, as ``bound`` is for Siddon's;
    ``labels``: it also reads 4 B per distinct label voxel."""
    from diffdrr_tpu_torch.ops.kernels.joseph import is_blend
    from diffdrr_tpu_torch.profiling import J_BLEND_OPS, J_RANGE_OPS, J_STEP_OPS, joseph_work

    samples, voxels, label_voxels = joseph_work(rows, density, axis, h, n_steps, arg)
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


def fused_design(header: str, constant: str = "kFusedLanes") -> str:
    """A lanes kernel's layout, for the record: its lanes a ray, as the
    header ``csrc/<header>`` compiles them (``constant``)."""
    import re

    text = (ROOT / "diffdrr_tpu_torch" / "csrc" / header).read_text()
    lanes = re.search(rf"constexpr int {constant} = (\d+);", text).group(1)
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


def check_equal(name, got, ref):
    """``got`` equals ``ref`` to the last bit; returns the max abs error, 0."""
    import torch

    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: not equal, max abs diff "
                             f"{float(torch.max(torch.abs(got - ref))):.3e}")
    return 0.0


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
    """Phase 7c: the joseph MIP at the main pose, fused and two-pass, then
    the sum-mode two-pass pose backward against the fused one."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer="joseph")
    J.reset_launch_counts()
    brick.clear_cache()
    brick.brick_density.launches = 0
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
    launches = dict(joseph_launches(), brick_copy=brick.brick_density.launches)
    log(f"[joseph mip] launches {launches}")
    # Two copies: joseph_fwdgrad's of the new density dens_p, joseph_fwd_max's
    # of the CT (the cache was emptied above).
    expect_launches("joseph MIP", launches,
                    {"joseph_fwdgrad": 1, "joseph_bwd_vol": 1, "joseph_fwd_max": 1,
                     "joseph_bwd_rays": 1, "joseph_fwd": 0, "brick_copy": 2})
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
    # Equal values; the bits may differ in the sign of a zero (the serial MIP
    # backward adds the argmax step's terms to +0, the fused rows keep a -0).
    err_pose = check_equal("joseph MIP pose gradient, two-pass vs fused", pg_two, pg_fused)
    log(f"[joseph mip] render vs plain {err_max:.3e} ({int((arg >= 0).sum())} of {arg.numel()} "
        f"rays with a maximum); bwd_rays vs plain {err_br:.3e}; density gradient vs plain "
        f"{err_bv:.3e}; two-pass vs fused pose gradient {err_pose:.3e} (max "
        f"{pg_fused.abs().max().item():.3e})")

    # The sum-mode two-pass pose backward (joseph_fwd, then joseph_bwd_rays'
    # lanes on the CT's copy, which joseph_fwd_max made above) against the
    # fused one (joseph_fwdgrad), counted alone.
    def pose_grad(fused):
        r, t = rot0.clone().requires_grad_(True), trans.clone().requires_grad_(True)
        torch.sum(drr(r, t, reducefn="sum", fused_pose_bwd=fused, **kw) ** 2).backward()
        return torch.cat([r.grad, t.grad], -1)

    pg_sum_fused = pose_grad(True)
    J.reset_launch_counts()
    brick.brick_density.launches = 0
    pg_sum_two = pose_grad(False)
    torch.cuda.synchronize()
    sum_launches = dict(joseph_launches(), brick_copy=brick.brick_density.launches)
    log(f"[joseph two-pass sum] launches {sum_launches}")
    expect_launches("joseph two-pass sum", sum_launches,
                    {"joseph_fwd": 1, "joseph_bwd_rays": 1, "joseph_fwdgrad": 0,
                     "joseph_fwd_max": 0, "joseph_bwd_vol": 0, "brick_copy": 0})
    err_pose_sum = check_equal("joseph pose gradient (sum), two-pass vs fused", pg_sum_two,
                               pg_sum_fused)
    if not (torch.isfinite(pg_sum_fused).all() and pg_sum_fused.abs().max() > 0):
        raise AssertionError("joseph sum-mode pose gradient not finite or zero")
    log(f"[joseph two-pass sum] two-pass vs fused pose gradient {err_pose_sum:.3e} (max "
        f"{pg_sum_fused.abs().max().item():.3e})")
    return dict(drr=drr, launches=launches, sum_launches=sum_launches, arg=arg,
                err_max=err_max, err_br=max(err_br, err_pose, err_pose_sum), err_bv_mip=err_bv)


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
                h=h, n=n, density=drr.density, err_fv=err_fv, err_bv=err_bv, t_step=t_step,
                losses=losses)


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
    # F.grid_sample at the same samples (#7's library yardstick), 200^2 and 1000^2.
    t_lib = grid_sample_ms(rows, drr.density, 2, h, X)
    t_lib_k = grid_sample_ms(rows_k, drr_k.density, 2, h, X)
    log(f"[cube] joseph 200^2: max abs err {err:.3e}; joseph_fwd {t:.4f} ms (plain "
        f"{t_plain:.2f}, bound {b:.4f} by {by}; F.grid_sample at its samples {t_lib:.4f}); "
        f"1000^2: max abs err {err_k:.3e}; joseph_fwd {t_k:.4f} ms with the bricked copy "
        f"cached, {t_k_copy:.4f} ms making it anew (F.grid_sample {t_lib_k:.4f})")
    return dict(launches=launches, err=max(err, err_k), t=t, t_plain=t_plain, b=b, by=by,
                t_k=t_k, t_lib=t_lib, t_lib_k=t_lib_k)


def march_grid(rows, density, axis, h, n):
    """The march's sample points as a grid_sample input and grid (trilinear,
    align_corners), and each sample's scale (0 outside the slab): ``(inp
    (1, 1, X, Y, Z), grid (1, R, n, 1, 3), scale (R, n))``."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    vol = density.permute(march_perm(axis)).contiguous()
    X, Y, Z = vol.shape
    cols, scale = [], []
    for st in J.march_steps(rows, h, X, n):
        y, z = st["y"], st["z"]
        x = torch.full_like(y, st["k"])
        # grid_sample's (x, y, z) index (W, H, D) = the volume's (z, y, s) axes.
        cols.append(torch.stack([2 * z / (Z - 1) - 1, 2 * y / (Y - 1) - 1,
                                 2 * x / (X - 1) - 1], -1))
        scale.append(st["scale"])
    grid = torch.stack(cols, 1)[None, :, :, None, :]  # (1, R, n, 1, 3)
    return vol[None, None], grid, torch.stack(scale, 1)


def grid_sample_ms(rows, density, axis, h, n, time_ms=None):
    """One F.grid_sample (trilinear, zero padding) over the march's sample
    points: the library yardstick of joseph_fwd, without its weighted sum.
    ``time_ms`` times a call (default: median of 20 CUDA-event runs)."""
    import torch.nn.functional as F

    inp, grid, _ = march_grid(rows, density, axis, h, n)

    def call():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    return time_ms(call) if time_ms is not None else median_ms(call, 20)


def grid_backward_ms(inp, grid, grad_output, nearest=False, input_grad=True):
    """Median CUDA-event time of one ``torch.ops.aten.grid_sampler_3d_backward``
    (zero padding, align_corners) of ``grad_output`` (1, C, R, n, 1): the
    input gradient (a backward to the volume) or the grid gradient (a
    backward to the sample points)."""
    import torch

    mask = [input_grad, not input_grad]

    def call():
        return torch.ops.aten.grid_sampler_3d_backward(grad_output, inp, grid, int(nearest), 0,
                                                       True, mask)

    return median_ms(call, 20)


def march_library_ms(rows, density, axis, h, n, g=None, input_grad=True, labels=None):
    """The library yardstick of the Joseph backwards (and joseph_fwdgrad):
    grid_sampler_3d_backward at the march's sample points with grad_output
    g * scale (g = 1 for joseph_fwdgrad; with ``labels`` g is the (C, R)
    channel cotangent taken at each sample's label, as the channel kernel
    takes it), its input gradient (the density scatter) or grid gradient."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import joseph as J
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    inp, grid, scale = march_grid(rows, density, axis, h, n)
    if labels is not None:
        lab_p = labels.permute(march_perm(axis))
        out = torch.stack([J._channel_cotangent(g, J._labels_at(lab_p, st))
                           for st in J.march_steps(rows, h, lab_p.shape[0], n)], 1) * scale
    else:
        out = scale if g is None else g[:, None] * scale
    return grid_backward_ms(inp, grid, out[None, None, :, :, None].contiguous(),
                            input_grad=input_grad)


def siddon_library_ms(rows, density, axis, g):
    """The library yardstick of siddon_bwd_vol: grid_sampler_3d_backward's
    nearest-mode input gradient at every segment's midpoint (three a slab),
    with grad_output len * w * g."""
    import torch

    from diffdrr_tpu_torch.ops.kernels import siddon as K
    from diffdrr_tpu_torch.ops.kernels.prep import march_perm

    r = K._rows_dict(rows)
    vol = density.permute(march_perm(axis)).contiguous()
    X, Y, Z = vol.shape
    cols, outs = [], []
    for s in range(X):
        sl = K._slab(r, s)
        bounds = [sl["alo"], torch.minimum(sl["ty"], sl["tz"]),
                  torch.maximum(sl["ty"], sl["tz"]), sl["ahi"]]
        for j, length in enumerate(sl["lens"]):
            mid = (bounds[j] + bounds[j + 1]) * 0.5
            y = r["gy"] + mid * r["dy"]
            z = r["gz"] + mid * r["dz"]
            x = torch.full_like(y, float(s))
            cols.append(torch.stack([2 * z / (Z - 1) - 1, 2 * y / (Y - 1) - 1,
                                     2 * x / (X - 1) - 1], -1))
            outs.append(torch.clamp(length, min=0.0) * r["sc"] * g)
    grid = torch.stack(cols, 1)[None, :, :, None, :]
    out = torch.stack(outs, 1)[None, None, :, :, None].contiguous()
    del cols, outs
    return grid_backward_ms(vol[None, None], grid, out, nearest=True)


def lateral_jrays(drr_t, dens):
    """(rows, h, n_steps) of the lateral pose's 200^2 rays: axis 0, the
    trilinear stride (n_points 500) over the 512 planes."""
    import torch

    from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_steps

    h, n = raymarch_steps(dens.shape[0], 500)
    rows_l = jrays_of(drr_t, torch.tensor(LATERAL_ROT, device=dens.device),
                      torch.tensor(BENCH_TRANS, device=dens.device), 0, h)
    return rows_l, h, n


def joseph_max_timings(dens, rows_m, X, lateral_rays):
    """Phase 7g: joseph_fwd_max at the main pose's 200^2 rays (axis 2, h = 1)
    back to back and with its bricked copy made anew in each call, and at
    the lateral pose (``lateral_jrays``) one call and back to back, there
    against its plain version (argmax exact, value 1e-4 * max). The times
    by name, and the lateral error."""
    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    def main():
        return J.joseph_fwd_max(rows_m, dens, 2, 1.0, X)

    out = {"ms_back_to_back": burst_ms(main),
           "ms_with_copy": median_ms(main, 20, before=brick.clear_cache)}
    rows_l, h, n = lateral_rays

    def lateral():
        return J.joseph_fwd_max(rows_l, dens, 0, h, n)

    out["err_lateral"] = check_max(f"joseph_fwd_max lateral (axis 0, h {h:g}) @200^2", lateral(),
                                   J.joseph_fwd_max_plain(rows_l, dens, 0, h, n))
    out["ms_lateral"] = median_ms(lateral, 20)
    out["ms_lateral_back_to_back"] = burst_ms(lateral)
    log(f"[time] joseph_fwd_max at 200^2: {out['ms_back_to_back']:.4f} ms back to back, "
        f"{out['ms_with_copy']:.4f} ms making its bricked copy anew; lateral pose (axis 0, "
        f"h {h:g}, {n} steps) {out['ms_lateral']:.4f} ms one call, "
        f"{out['ms_lateral_back_to_back']:.4f} back to back, vs plain {out['err_lateral']:.3e}")
    return out


def joseph_bwd_rays_timings(dens, rows_m, X, g, lateral_rays):
    """Phase 7g: joseph_bwd_rays in sum mode at the main pose's 200^2 rays
    (axis 2, h = 1) back to back, and at the lateral pose
    (``lateral_jrays``) one call and back to back; at both poses against
    its plain version (rows 1e-3 * max|row|) and equal to joseph_fwdgrad's
    rows 0-6 times g to the last bit. The times by name, and the worst
    error."""
    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.ops.kernels import joseph as J

    rows_l, h, n = lateral_rays
    out, errs = {}, []
    for label, rows, axis, hh, nn in (("main", rows_m, 2, 1.0, X), ("lateral", rows_l, 0, h, n)):
        def call():
            return J.joseph_bwd_rays(rows, dens, axis, hh, nn, g)

        name = f"joseph_bwd_rays[sum] {label} (axis {axis}, h {hh:g}) @200^2"
        errs.append(check_rows(name, call(), J.joseph_bwd_rays_plain(rows, dens, axis, hh, nn, g)))
        errs.append(check_equal(f"{name} vs joseph_fwdgrad rows * g", call(),
                                J.joseph_fwdgrad(rows, dens, axis, hh, nn)[0][:7] * g))
        if label == "lateral":
            out["ms_lateral"] = median_ms(call, 20)
            out["ms_lateral_back_to_back"] = burst_ms(call)
        else:
            out["ms_back_to_back"] = burst_ms(call)
    log(f"[time] joseph_bwd_rays sum at 200^2: {out['ms_back_to_back']:.4f} ms back to back; "
        f"lateral pose (axis 0, h {h:g}, {n} steps) {out['ms_lateral']:.4f} ms one call, "
        f"{out['ms_lateral_back_to_back']:.4f} back to back; vs plain and vs joseph_fwdgrad "
        f"rows * g {max(errs):.3e}")
    return out, max(errs)


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

    from diffdrr_tpu_torch.ops.kernels import brick
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
        brick.brick_density.launches = 0
        rot_p = rot0.clone().requires_grad_(True)
        trans_p = trans.clone().requires_grad_(True)
        dens_p = dens.clone().requires_grad_(True)
        img_p = drr.render(dens_p, *drr.detector(T.convert(rot_p, trans_p, **kw)),
                           mask_to_channels=True)
        (w[None, :, None] * img_p ** 2).sum().backward()
        torch.cuda.synchronize()
        launches = dict(joseph_launches(), brick_copy=brick.brick_density.launches)
        log(f"[channels] {renderer} backward launches {launches}")
        # dens_p is a new density: joseph_fwd_ch bricks it once and
        # joseph_bwd_rays_ch reads that copy; the labelmap's is cached.
        expect_launches(f"{renderer} channel backward", launches,
                        {"joseph_fwd_ch": 1, "joseph_bwd_rays_ch": 1, "joseph_bwd_vol_ch": 1,
                         "joseph_fwdgrad": 0, "joseph_fwd": 0, "joseph_fwd_max": 0,
                         "joseph_bwd_rays": 0, "joseph_bwd_vol": 0, "brick_copy": 1})
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
    render's rows), one call and back to back, its plain version and its
    bound; joseph_fwd_ch and joseph_bwd_rays_ch also with their bricked
    copies made anew in each call. (name: (ms, plain_ms, bound_ms,
    bound_by)), and the extra times by name."""
    import numpy as np
    import torch

    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
    from diffdrr_tpu_torch.ops.kernels import brick
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
    times, extra = {}, {}
    for name, (kernel, plain) in fns.items():
        bnd, by = march_bound(rows, dens, axis, h, n, **b[name])
        times[name] = (median_ms(kernel, 20), median_ms(plain, 2, 1), bnd, by)
        extra[name] = {"ms_back_to_back": burst_ms(kernel)}
        if name in ("fwd_ch", "bwd_rays_ch"):
            extra[name]["ms_with_copy"] = median_ms(kernel, 20, before=brick.clear_cache)
        if name == "bwd_vol_ch":
            extra[name]["library_ms"] = march_library_ms(rows, dens, axis, h, n, g, labels=lab)
        if name == "bwd_rays_ch":  # the grid gradient, each sample's label's g * scale
            extra[name]["library_ms"] = march_library_ms(rows, dens, axis, h, n, g,
                                                         input_grad=False, labels=lab)
        log(f"[time] joseph_{name} {times[name][0]:.4f} ms one call, "
            + ", ".join(f"{k} {v:.4f}" for k, v in extra[name].items())
            + f" (plain {times[name][1]:.2f}, bound {bnd:.4f} by {by}) at 200^2 rays, "
            f"7 channels, axis {axis}, h {h:g}")
    return times, extra


# The registration CLI (diffdrr_tpu_torch.experiments.registration) at full
# width: the recon CLI's 512x512x128 CT and 200x200 detector (2 mm pixels).
REG_CLI = ["--volume-size", str(CLI_VOLUME_SIZE), "--height", str(CLI_HEIGHT)]
REG_SCALES = (0.25, 0.5, 1.0)
REG_ITERS = (20, 20, 20)
REG_POLISH = 20
REG_RUNS = 2
REG_SIDDON_STEPS = 60
REG_RESTARTS = 4
REG_UNTIL_STEPS = 40
# Rotation held nearly still, so the double geodesic follows the translation
# (phase 7b's error falls on every axis) and the distance falls below its start.
REG_LR = dict(lr_rotation=1e-5, lr_translation=1e-1)


def all_launches():
    from diffdrr_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def reset_all_launches():
    from diffdrr_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()


def no_other_launches(phase, launches, want):
    """``want`` exactly, and 0 for every other kernel."""
    from diffdrr_tpu_torch.ops import kernels

    kernels.no_other_launches(phase, launches, want)


def mi_dense(x1, x2, sigma=0.1, num_bins=256, epsilon=1e-10):
    """Normalized mutual information of (B, 1, H, W) images from the whole
    (B, N, bins) Parzen tensors at once (the formula the streamed sums
    replace)."""
    import torch

    B = x1.shape[0]
    bins = torch.linspace(0.0, 1.0, num_bins, dtype=x1.dtype, device=x1.device)
    k1 = torch.exp(-0.5 * ((x1.reshape(B, -1, 1) - bins) / sigma) ** 2)
    k2 = torch.exp(-0.5 * ((x2.reshape(B, -1, 1) - bins) / sigma) ** 2)
    N = k1.shape[1]
    p1 = k1.sum(1) / N
    p1 = p1 / (p1.sum(1, keepdim=True) + epsilon)
    p2 = k2.sum(1) / N
    p2 = p2 / (p2.sum(1, keepdim=True) + epsilon)
    j12 = torch.einsum("bni,bnj->bij", k1, k2)
    p12 = j12 / (j12.sum((1, 2), keepdim=True) + epsilon)
    h1 = -(p1 * torch.log2(p1 + epsilon)).sum(1)
    h2 = -(p2 * torch.log2(p2 + epsilon)).sum(1)
    h12 = -(p12 * torch.log2(p12 + epsilon)).sum((1, 2))
    return 2 * (h1 + h2 - h12) / (h1 + h2)


def registration_cli_phase(card: str) -> dict:
    """Phase 9: the registration CLI end to end at full width, with exact
    launch counts, then optimize_until, checkpoint_gradients, cache_volume,
    streamed MI and step timings."""
    import tempfile

    import numpy as np
    import torch

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch.experiments import registration as reg_cli
    from diffdrr_tpu_torch.metrics import (DoubleGeodesicSE3, MultiscaleNormalizedCrossCorrelation2d,
                                           mutual_information)
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.registration import (make_multistart_step, make_registration_step,
                                                optimize, optimize_multistart, optimize_until)

    kw = dict(parameterization="euler_angles", convention="ZXY")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reg_") as outdir:
        # (a) Multiscale with the gradient-NCC polish, trilinear: every step
        # (the warm-up run's too) one joseph_fwdgrad; the target one joseph_fwd;
        # all scales read one bricked copy.
        brick.clear_cache()
        reset_all_launches()
        t0 = time.perf_counter()
        res = reg_cli.main(REG_CLI + [
            "--multiscale", ",".join(map(str, REG_SCALES)),
            "--iters-per-scale", ",".join(map(str, REG_ITERS)), "--lr-decay", "0.1",
            "--polish-iters", str(REG_POLISH), "--n-runs", str(REG_RUNS),
            "--outdir", f"{outdir}/multiscale"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = all_launches()
        steps = (REG_RUNS + 1) * (sum(REG_ITERS) + REG_POLISH)
        log(f"[regcli] multiscale launches {launches}")
        no_other_launches("registration CLI multiscale", launches,
                          {"joseph_fwd": 1, "joseph_fwdgrad": steps, "brick_copy": 1})
        for i, run in enumerate(res["runs"]):
            if not (np.isfinite(run["final_mm"]) and run["final_mm"] < run["start_mm"]):
                raise AssertionError(f"multiscale run {i}: {run['start_mm']} -> "
                                     f"{run['final_mm']} mm")
            log(f"[regcli] multiscale run {i}: double geodesic {run['start_mm']:.3f} -> "
                f"{run['final_mm']:.3f} mm; scores per stage "
                + ", ".join(f"{lab} {sc[0]:.4f} -> {sc[-1]:.4f}"
                            for lab, sc in zip(res["stages"], run["scores"])))
        rows = (Path(outdir) / "multiscale" / "multiscale_summary.csv").read_text().splitlines()
        if len(rows) != REG_RUNS + 1:
            raise AssertionError(f"multiscale_summary.csv has {len(rows)} lines")
        # Each stage's step times past its first two steps, over the runs.
        stage_ms = {lab: statistics.median([t for run in res["runs"]
                                            for t in run["step_ms"][k][2:] or run["step_ms"][k]])
                    for k, lab in enumerate(res["stages"])}
        out.update(multiscale_launches=launches, stage_ms=stage_ms, multiscale_s=secs,
                   final_mm=[r["final_mm"] for r in res["runs"]],
                   start_mm=[r["start_mm"] for r in res["runs"]])
        del res

        # (b) One serial Siddon run: siddon_fwdgrad once a step.
        brick.clear_cache()
        reset_all_launches()
        res = reg_cli.main(REG_CLI + ["--renderer", "siddon", "--n-runs", "1",
                                      "--n-iters", str(REG_SIDDON_STEPS),
                                      "--outdir", f"{outdir}/siddon"])
        torch.cuda.synchronize()
        launches = all_launches()
        run = res["runs"][0]
        log(f"[regcli] siddon serial launches {launches}, slab escapes "
            f"{res['drr'].siddon_escapes}")
        if res["drr"].siddon_escapes:
            raise AssertionError("the serial Siddon run escaped to the oracle")
        no_other_launches("registration CLI siddon", launches,
                          {"siddon_fwd": 1, "siddon_fwdgrad": len(run["scores"]),
                           "brick_copy": 1})
        if not np.isfinite(run["scores"]).all():
            raise AssertionError("serial Siddon scores are not finite")
        log(f"[regcli] siddon serial {len(run['scores'])} steps: score {run['scores'][0]:.4f} -> "
            f"{run['scores'][-1]:.4f}, double geodesic {run['start_mm']:.3f} -> "
            f"{run['final_mm']:.3f} mm")
        out.update(siddon_launches=launches,
                   siddon_step_ms=statistics.median(run["step_ms"][2:] or run["step_ms"]))
        del res, run

        # (c) Multistart: 4 restarts as one batched run (one joseph_fwdgrad a
        # step, warm-up included; the target and each run's final scores one
        # joseph_fwd each). Independence, bit for bit: a rerun gives the CLI's
        # result, and each restart's trajectory (trace, final pose and score)
        # is unchanged when the other three starts are replaced. Then 4
        # single-pose runs from the same starts, their difference reported:
        # the card's kernels for a batch of one and of four round differently
        # in the last bit, which the float32 patch NCC and Adam amplify.
        brick.clear_cache()
        reset_all_launches()
        res = reg_cli.main(REG_CLI + ["--multistart", "--n-runs", str(REG_RESTARTS),
                                      "--n-iters", str(N_REG_STEPS),
                                      "--outdir", f"{outdir}/multistart"])
        torch.cuda.synchronize()
        launches = all_launches()
        log(f"[regcli] multistart launches {launches}")
        no_other_launches("registration CLI multistart", launches,
                          {"joseph_fwd": 3, "joseph_fwdgrad": 2 * N_REG_STEPS, "brick_copy": 1})
        drr, target = res["drr"], res["target"]
        metric = MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5])
        ms_kw = dict(n_iters=N_REG_STEPS, metric=metric, lr_rotation=5e-3, lr_translation=5e-1)
        rots0, transs0 = res["rotation0"], res["translation0"]
        ref = optimize_multistart(drr, target, rots0, transs0, "euler_angles", "ZXY", **ms_kw)
        if not (torch.equal(ref[0], res["rotations"]) and torch.equal(ref[1], res["translations"])):
            raise AssertionError("a rerun of the CLI's multistart gives other poses")
        for i in range(REG_RESTARTS):
            others = torch.arange(REG_RESTARTS, device=rots0.device) != i
            rots, transs = rots0.clone(), transs0.clone()
            rots[others] = rots0[others].flip(0) + 0.01
            transs[others] = transs0[others].flip(0) - 3.0
            alt = optimize_multistart(drr, target, rots, transs, "euler_angles", "ZXY", **ms_kw)
            if not (torch.equal(alt[0][i], ref[0][i]) and torch.equal(alt[1][i], ref[1][i])
                    and torch.equal(alt[2][i], ref[2][i])
                    and torch.equal(alt[3][:, i], ref[3][:, i])):
                raise AssertionError(f"restart {i} depends on the other restarts' starts")
        dev_r = dev_t = 0.0
        for i in range(REG_RESTARTS):
            r, t, _ = optimize(drr, target, rots0[i:i + 1], transs0[i:i + 1], "euler_angles",
                               "ZXY", **ms_kw)
            dev_r = max(dev_r, (r[0] - ref[0][i]).abs().max().item())
            dev_t = max(dev_t, (t[0] - ref[1][i]).abs().max().item())
        log(f"[regcli] multistart {REG_RESTARTS} x {N_REG_STEPS} steps: final scores "
            + ", ".join(f"{s:.4f}" for s in res["final_scores"]) + "; double geodesics "
            + ", ".join(f"{m:.3f}" for m in res["final_mm"]) + " mm; each restart's trajectory "
            f"bit for bit unchanged with the other starts replaced; {REG_RESTARTS} single-pose "
            f"runs from the same starts end {dev_r:.3e} rad and {dev_t:.3e} mm away")
        out.update(multistart_launches=launches, multistart_dev=(dev_r, dev_t))

        # (d) optimize_until from translation + 5 mm, against a replay of its
        # steps: first with a tolerance never met (it runs to max_iters), then
        # with the distance that run reached half way (it stops at the first
        # step at or below it).
        rot_true, trans_true = res["rot_true"], res["trans_true"]
        true_pose = T.convert(rot_true, trans_true, **kw)
        geo = DoubleGeodesicSE3(sdd=1020.0)
        init_fn, step_fn = make_registration_step(drr, target, "euler_angles", "ZXY", **REG_LR)
        params, opt = init_fn(rot_true, trans_true + 5.0)
        dists = []  # after 0, 1, ..., REG_UNTIL_STEPS steps
        for k in range(REG_UNTIL_STEPS + 1):
            with torch.no_grad():
                dists.append(float(geo(true_pose, T.convert(params["rotation"],
                                                            params["translation"], **kw))[2]))
            if k < REG_UNTIL_STEPS:
                params, opt, _ = step_fn(params, opt)
        half = dists[REG_UNTIL_STEPS // 2]
        if not half < dists[0]:
            raise AssertionError(f"optimize_until's run did not come nearer: {dists}")
        for tol in (0.0, half):
            _, _, n_u, d_u = optimize_until(drr, target, rot_true, trans_true + 5.0,
                                            "euler_angles", "ZXY", true_pose=true_pose,
                                            tol_mm=tol, max_iters=REG_UNTIL_STEPS, **REG_LR)
            want = next((k for k, d in enumerate(dists) if d <= tol), REG_UNTIL_STEPS)
            if not (n_u == want and d_u == dists[want]):
                raise AssertionError(f"optimize_until (tol {tol} mm) stopped at step {n_u} "
                                     f"({d_u} mm); the replay's distances {dists}")
        log(f"[regcli] optimize_until from translation + 5 mm ({dists[0]:.3f} mm): tol 0 runs "
            f"the {REG_UNTIL_STEPS} steps to {dists[-1]:.3f} mm; tol {half:.3f} mm (where that "
            f"run was at step {REG_UNTIL_STEPS // 2}) stops at step {n_u}, as a replay says")
        out.update(until=(n_u, d_u))

        # (e) checkpoint_gradients: the pose gradient equals the plain one and
        # the rerun in the backward reads the cached copy; cache_volume=False
        # bricks every render anew.
        def pose_grad(d):
            r = rot_true.clone().requires_grad_(True)
            t = (trans_true + 5.0).requires_grad_(True)
            torch.mean(metric(d(r, t, **kw), target)).backward()
            return torch.cat([r.grad, t.grad], -1)

        ckpt = T.DRR(drr.subject, sdd=1020.0, height=CLI_HEIGHT, delx=2.0, renderer="trilinear",
                     checkpoint_gradients=True)
        nocache = T.DRR(drr.subject, sdd=1020.0, height=CLI_HEIGHT, delx=2.0,
                        renderer="trilinear", cache_volume=False)
        if not (ckpt.density is drr.density is nocache.density):
            raise AssertionError("the DRRs of one subject do not share its density")
        reset_all_launches()
        g_plain = pose_grad(drr)
        torch.cuda.synchronize()
        l_plain = all_launches()
        reset_all_launches()
        g_ckpt = pose_grad(ckpt)
        torch.cuda.synchronize()
        l_ckpt = all_launches()
        no_other_launches("plain pose gradient", l_plain, {"joseph_fwdgrad": 1})
        no_other_launches("checkpointed pose gradient", l_ckpt, {"joseph_fwdgrad": 2})
        if not torch.equal(g_ckpt, g_plain):
            raise AssertionError(f"checkpointed pose gradient {g_ckpt} != {g_plain}")
        reset_all_launches()
        with torch.no_grad():
            imgs = [nocache(rot_true, trans_true, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        l_nocache = all_launches()
        no_other_launches("cache_volume=False renders", l_nocache,
                          {"joseph_fwd": 2, "brick_copy": 2})
        if not all(torch.equal(img, target) for img in imgs):
            raise AssertionError("cache_volume=False renders differ from the target")
        log(f"[regcli] checkpoint_gradients: pose gradient equal to the plain one to the last "
            f"bit; launches plain {l_plain['joseph_fwdgrad']} joseph_fwdgrad, checkpointed "
            f"{l_ckpt['joseph_fwdgrad']} and brick_copy {l_ckpt['brick_copy']}; cache_volume=False: "
            f"2 renders, brick_copy {l_nocache['brick_copy']}")
        out.update(ckpt_launches=l_ckpt)

        # (f) Mutual information at 200^2 (40,000 pixels: three streamed
        # chunks) against its dense formula, forward and backward.
        with torch.no_grad():
            moved = drr(rot_true, trans_true + 5.0, **kw)
        x2 = (target / target.max()).detach()
        x1 = (moved / moved.max()).detach().requires_grad_(True)
        mi = mutual_information(x1, x2)
        (g_mi,) = torch.autograd.grad(mi.sum(), x1)
        x1d = x1.detach().requires_grad_(True)
        mi_ref = mi_dense(x1d, x2)
        (g_ref,) = torch.autograd.grad(mi_ref.sum(), x1d)
        err_mi = abs(mi.item() - mi_ref.item()) / abs(mi_ref.item())
        err_g = ((g_mi - g_ref).abs().max() / g_ref.abs().max()).item()
        if not (err_mi <= 1e-5 and err_g <= 1e-4):
            raise AssertionError(f"MI streamed vs dense: value {err_mi}, gradient {err_g}")
        t_mi = median_ms(lambda: torch.autograd.grad(mutual_information(x1, x2).sum(), x1), 10)
        t_mi_dense = median_ms(lambda: torch.autograd.grad(mi_dense(x1d, x2).sum(), x1d), 10)
        log(f"[regcli] MI at 200^2: {mi.item():.6f} streamed, {mi_ref.item():.6f} dense "
            f"(relative {err_mi:.2e}); gradient {err_g:.2e} of its max; forward and backward "
            f"{t_mi:.3f} ms streamed, {t_mi_dense:.3f} ms dense")
        out.update(mi=(err_mi, err_g, t_mi, t_mi_dense))

        # (g) A 4-pose multistart step against a single-pose step (CUDA events).
        starts = (res["rotation0"], res["translation0"])
        init4, step4 = make_multistart_step(drr, target, "euler_angles", "ZXY", metric=metric,
                                            lr_rotation=5e-3, lr_translation=5e-1)
        state4 = list(init4(*starts))
        init1, step1 = make_registration_step(drr, target, "euler_angles", "ZXY", metric=metric,
                                              lr_rotation=5e-3, lr_translation=5e-1)
        state1 = list(init1(starts[0][:1], starts[1][:1]))

        def run4():
            state4[0], state4[1], _ = step4(*state4)

        def run1():
            state1[0], state1[1], _ = step1(*state1)

        t4 = statistics.median(events_step(run4, 25)[1][5:])
        t1 = statistics.median(events_step(run1, 25)[1][5:])
        out.update(multistart_step_ms=t4, single_step_ms=t1)
        del res, drr, target, ckpt, nocache
    log(f"[regcli] {card}: step medians (CUDA events) per stage "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in out["stage_ms"].items())
        + f"; serial Siddon step {out['siddon_step_ms']:.3f} ms; a {REG_RESTARTS}-pose "
        f"multistart step {t4:.3f} ms against a single-pose step {t1:.3f} ms; the multiscale "
        f"CLI call {out['multiscale_s']:.1f} s")
    return out


# Phase 10: the rest of pose estimation at the registration CLI's full width.
LBFGS_RUNS = 2
LBFGS_STEPS = 20
LBFGS_SIDDON_STEPS = 20
LBFGS_RESTARTS = 4
LBFGS_RESTART_STEPS = 10
PARAM_STEPS = 10
TRAIN_BATCH = 8
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 10
TRAIN_RESUME_STEPS = 10
TRAIN_10D_STEPS = 10
SCIPY_RUNS = 2
SCIPY_MAXITER = 100


def check_lbfgs_runs(phase, res):
    """Each serial run's loss non-increasing over its accepted steps (those
    whose line search met the sufficient-decrease criterion, up to its
    approximate-decrease allowance of 1e-6 relative; a failed line search
    returns its last, unchecked step, as optax's does) and lower at its last
    step than at its first; its double geodesic, step and evaluation times
    logged. (The geodesic is not held below its start: from the CLI's
    second seeded start the patch NCC rises monotonically while the pose
    ends ~2.6 mm farther; PERF.md §6, "the rest of pose estimation".)
    Returns each run's (median step ms, ms an evaluation)."""
    import numpy as np

    per_step, failures = [], []
    for i, run in enumerate(res.get("runs", [])):
        ls = [n for n, _ in run["linesearch_steps"]]
        accepted = [ok for _, ok in run["linesearch_steps"]]
        scores = run["scores"]
        step_ms = run["step_ms"]
        n_eval = sum(ls) + 1
        per_step.append((statistics.median(step_ms), sum(step_ms) / n_eval))
        log(f"[lbfgs] {phase} run {i}: {len(scores)} steps, {n_eval} evaluations (line search "
            f"{ls}), {sum(accepted)} steps met sufficient decrease ({accepted}); scores "
            + " ".join(f"{x:.5f}" for x in scores) + f"; double geodesic "
            f"{run['start_mm']:.3f} -> {run['final_mm']:.3f} mm; step median "
            f"{per_step[-1][0]:.3f} ms, {per_step[-1][1]:.3f} ms an evaluation (CUDA events)")
        worse = [(k, a, b) for k, (a, b) in enumerate(zip(scores, scores[1:]))
                 if accepted[k] and b < a - 1e-6 * abs(a)]
        if worse:
            failures.append(f"{phase} run {i}: the loss rose at accepted steps {worse}")
        if not (np.isfinite(run["final_mm"]) and np.isfinite(scores).all()
                and scores[-1] > scores[0]):
            failures.append(f"{phase} run {i}: score {scores[0]} -> {scores[-1]}, double "
                            f"geodesic {run['start_mm']} -> {run['final_mm']} mm")
    if failures:
        raise AssertionError("; ".join(failures))
    return per_step


def lbfgs_cli_run(phase, argv, renderer_fwd, renderer_fwdgrad, n_fwd):
    """One registration-CLI call with --optimizer lbfgs, counts zeroed before:
    the fused pose kernel launched exactly once an evaluation (the line
    searches' and each run's first), the forward ``n_fwd`` times, one
    bricked copy and nothing else; each serial run checked by
    ``check_lbfgs_runs``."""
    import torch

    from diffdrr_tpu_torch import lbfgs
    from diffdrr_tpu_torch.experiments import registration as reg_cli
    from diffdrr_tpu_torch.ops.kernels import brick

    brick.clear_cache()
    reset_all_launches()
    lbfgs.reset_evaluations()
    t0 = time.perf_counter()
    res = reg_cli.main(REG_CLI + ["--optimizer", "lbfgs"] + argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, evals = all_launches(), dict(lbfgs.evaluations)
    # A Siddon evaluation at a pose past the slab guard renders on the oracle
    # (no kernel), and counts in siddon_escapes.
    escapes = res["drr"].siddon_escapes
    log(f"[lbfgs] {phase}: launches {launches}; evaluations {evals}, slab escapes {escapes} "
        f"in {secs:.1f} s")
    no_other_launches(f"LBFGS {phase}", launches,
                      {renderer_fwd: n_fwd,
                       renderer_fwdgrad: evals["linesearch"] + evals["first"] - escapes,
                       "brick_copy": 1})
    per_step = check_lbfgs_runs(phase, res)
    if res["mode"] == "serial" and evals["linesearch"] != sum(
            n for run in res["runs"] for n, _ in run["linesearch_steps"]):
        raise AssertionError(f"{phase}: the recorded line-search evaluations differ from "
                             f"the count {evals}")
    if res["mode"] == "serial" and evals["first"] != len(res["runs"]):
        raise AssertionError(f"{phase}: {evals['first']} first evaluations for "
                             f"{len(res['runs'])} runs")
    return res, launches, evals, per_step, secs


def pose_estimation_phase(card: str) -> dict:
    """Phase 10: LBFGS through the registration CLI, the three new rotation
    parameterizations, the CNN pose regressor's trainer, the scipy baseline
    and the pinhole camera, at the CLI's full width."""
    import tempfile

    import numpy as np
    import torch

    import diffdrr_tpu_torch as T
    from diffdrr_tpu_torch import pose as P
    from diffdrr_tpu_torch.experiments import pose_regressor as trainer
    from diffdrr_tpu_torch.experiments import reg_scipy
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.registration import PoseRegressor, optimize
    from diffdrr_tpu_torch.utils import get_pinhole_camera

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pose_") as tmp:
        # (a) LBFGS: trilinear serial, one Siddon serial run, multistart (the
        # warm-up and the timed call: 2 x 4 restarts, each its first evaluation).
        res, *tri = lbfgs_cli_run("trilinear serial", [
            "--n-runs", str(LBFGS_RUNS), "--n-iters", str(LBFGS_STEPS),
            "--outdir", f"{tmp}/tri"], "joseph_fwd", "joseph_fwdgrad", 1)
        drr, target = res["drr"], res["target"]
        rot_true, trans_true = res["rot_true"], res["trans_true"]
        dev = drr.device
        _, *sid = lbfgs_cli_run("siddon serial", [
            "--renderer", "siddon", "--n-runs", "1", "--n-iters", str(LBFGS_SIDDON_STEPS),
            "--outdir", f"{tmp}/sid"], "siddon_fwd", "siddon_fwdgrad", 1)
        ms_res, *ms = lbfgs_cli_run("multistart", [
            "--multistart", "--n-runs", str(LBFGS_RESTARTS), "--n-iters",
            str(LBFGS_RESTART_STEPS), "--outdir", f"{tmp}/ms"], "joseph_fwd", "joseph_fwdgrad",
            3)
        if ms[1]["first"] != 2 * LBFGS_RESTARTS:
            raise AssertionError(f"multistart made {ms[1]['first']} first evaluations")
        trace = np.asarray(ms_res["trace"])
        if trace.shape != (LBFGS_RESTART_STEPS, LBFGS_RESTARTS) or not np.isfinite(trace).all():
            raise AssertionError(f"multistart trace {trace.shape}")
        log(f"[lbfgs] multistart {LBFGS_RESTARTS} x {LBFGS_RESTART_STEPS}: scores "
            + ", ".join(f"{a:.4f} -> {b:.4f}" for a, b in zip(trace[0], trace[-1]))
            + "; double geodesics " + ", ".join(f"{m:.3f}" for m in ms_res["final_mm"])
            + f" mm; the call {ms[3]:.1f} s ({ms[1]['linesearch'] + ms[1]['first']} "
            f"evaluations with its warm-up)")
        out.update(lbfgs_tri=tri, lbfgs_sid=sid, lbfgs_ms=ms[:2] + [ms[3]])
        del res, ms_res

        # (b) rotation_9d, rotation_10d and quaternion_adjugate: 10 Adam steps
        # from the truth + 5 mm; then the two autograd Functions' backwards on
        # the card against the CPU's on 16 generic rotations.
        true_pose = T.convert(rot_true, trans_true, parameterization="euler_angles",
                              convention="ZXY")
        for name in ("rotation_9d", "rotation_10d", "quaternion_adjugate"):
            rot_p, trans_p = true_pose.convert(name)
            brick.clear_cache()
            reset_all_launches()
            _, _, tr = optimize(drr, target, rot_p, trans_p + 5.0, name, n_iters=PARAM_STEPS,
                                **REG_LR)
            torch.cuda.synchronize()
            launches = all_launches()
            no_other_launches(f"{name} registration", launches,
                              {"joseph_fwdgrad": PARAM_STEPS, "brick_copy": 1})
            if not (np.isfinite(tr).all() and tr[-1] > tr[0]):
                raise AssertionError(f"{name}: scores {tr}")
            log(f"[param] {name}: {PARAM_STEPS} Adam steps from the truth + 5 mm, score "
                f"{tr[0]:.5f} -> {tr[-1]:.5f}, joseph_fwdgrad {launches['joseph_fwdgrad']}")
        # 16 random rotations as a network would output them: each one's 3x3
        # matrix and symmetric 4x4 (-q q^T), perturbed by N(0, 0.05).
        rng = np.random.default_rng(10)
        q = torch.tensor(rng.normal(size=(16, 4)), dtype=torch.float32)
        q = q / q.norm(dim=-1, keepdim=True)
        errs = {}
        for name, fn, x in (
                ("special_procrustes", P.special_procrustes, P.quaternion_to_matrix(q)),
                ("_smallest_eigvec4", lambda a: P._SmallestEigvec4.apply(a),
                 -q[:, :, None] * q[:, None, :])):
            x = x.numpy() + rng.normal(0, 0.05, x.shape).astype(np.float32)
            if name == "_smallest_eigvec4":
                x = (x + x.transpose(0, 2, 1)) / 2
            grads = []
            for where in ("cpu", dev):
                xt = torch.tensor(x, device=where, requires_grad=True)
                y = fn(xt)
                ct = torch.tensor(np.random.default_rng(11).normal(size=y.shape),
                                  dtype=torch.float32, device=where)
                y.backward(ct)
                grads.append(xt.grad.cpu())
            err = ((grads[1] - grads[0]).abs().max() / grads[0].abs().max()).item()
            if not (np.isfinite(err) and err <= 1e-5):
                raise AssertionError(f"{name} backward on the card vs the CPU: {err}")
            errs[name] = err
        log(f"[param] backwards on 16 perturbed random rotations, card vs CPU (of the max): "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        out.update(param_errs=errs)

        # (c) The trainer: rotation_6d for 20 steps saving every 10, a resume
        # that starts at step 20, rotation_10d for 10 steps; one joseph_fwd a
        # step (8 poses in one batch), one bricked copy a call, no pose kernel.
        train_cli = REG_CLI + ["--batch-size", str(TRAIN_BATCH)]
        ckpt = f"{tmp}/ckpt"
        runs = {}
        for label, extra, steps in (
                ("rotation_6d", ["--n-steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt,
                                 "--ckpt-every", str(TRAIN_CKPT_EVERY)], TRAIN_STEPS),
                ("rotation_6d resumed", ["--n-steps", str(TRAIN_STEPS + TRAIN_RESUME_STEPS),
                                         "--ckpt-dir", ckpt, "--ckpt-every",
                                         str(TRAIN_CKPT_EVERY)], TRAIN_RESUME_STEPS),
                ("rotation_10d", ["--n-steps", str(TRAIN_10D_STEPS), "--parameterization",
                                  "rotation_10d"], TRAIN_10D_STEPS)):
            brick.clear_cache()
            reset_all_launches()
            run = trainer.main(train_cli + extra)
            torch.cuda.synchronize()
            launches = all_launches()
            no_other_launches(f"trainer {label}", launches,
                              {"joseph_fwd": steps, "brick_copy": 1})
            if len(run["losses"]) != steps or not np.isfinite(run["losses"]).all():
                raise AssertionError(f"trainer {label}: losses {run['losses']}")
            want_start = TRAIN_STEPS if label.endswith("resumed") else 0
            if run["start"] != want_start:
                raise AssertionError(f"trainer {label} started at step {run['start']}")
            step_ms = statistics.median(run["step_ms"][2:] or run["step_ms"])
            runs[label] = step_ms
            log(f"[train] {label}: steps {run['start']}..{run['start'] + steps}, loss "
                f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}, joseph_fwd "
                f"{launches['joseph_fwd']}, step median {step_ms:.3f} ms (CUDA events)")
            del run
        presets = {}
        x = torch.randn(TRAIN_BATCH, 1, 256, 256, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        for preset in ("default", "large"):
            model = PoseRegressor("rotation_6d", model_name=preset,
                                  generator=torch.Generator().manual_seed(0)).to(dev)

            def fwd_bwd():
                pose = model(x)
                torch.sum(pose.matrix ** 2).backward()

            presets[preset] = median_ms(fwd_bwd, 10)
        log(f"[train] {card}: one forward and backward at batch {TRAIN_BATCH}, 256^2: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in presets.items()))
        out.update(train_ms=runs, preset_ms=presets)

        # (d) The scipy baseline: one joseph_fwd a function evaluation, and one
        # for the target.
        brick.clear_cache()
        reset_all_launches()
        sc = reg_scipy.main(REG_CLI + ["--n-runs", str(SCIPY_RUNS), "--maxiter",
                                       str(SCIPY_MAXITER)])
        torch.cuda.synchronize()
        launches = all_launches()
        nfev = sum(r["nfev"] for r in sc["runs"])
        no_other_launches("reg_scipy", launches, {"joseph_fwd": nfev + 1, "brick_copy": 1})
        log(f"[scipy] Nelder-Mead, maxiter {SCIPY_MAXITER}: "
            + "; ".join(f"run {i} nfev {r['nfev']}, final {r['final_mm']:.3f} mm, "
                        f"{r['seconds']:.2f} s" for i, r in enumerate(sc["runs"]))
            + f"; joseph_fwd {launches['joseph_fwd']}")
        out.update(scipy=[(r["nfev"], r["final_mm"], r["seconds"]) for r in sc["runs"]])
        del sc

        # (e) The pinhole camera of the main cell's view: its projection
        # matrix reprojects the volume's corners onto perspective_projection.
        cam = get_pinhole_camera(drr, true_pose)
        bounds = drr.subject.volume.get_bounds()
        corners = np.array([[bounds[0][i], bounds[1][j], bounds[2][k]]
                            for i in (0, 1) for j in (0, 1) for k in (0, 1)])
        with torch.no_grad():
            expect = drr.perspective_projection(
                true_pose, torch.tensor(corners[None], dtype=torch.float32,
                                        device=dev))[0].cpu().numpy()
        proj = (cam.projmat[0].astype(np.float64)
                @ np.concatenate([corners, np.ones((8, 1))], 1).T).T
        err_px = float(np.abs(proj[:, :2] / proj[:, 2:] - expect).max())
        if not err_px <= 1e-2:
            raise AssertionError(f"pinhole camera reprojection {err_px} px")
        log(f"[pinhole] the camera's projection matrix reprojects the 8 corners within "
            f"{err_px:.2e} px of perspective_projection")
        out.update(pinhole_px=err_px)
        del drr, target
    return out


# Phase 11: parallel/ and profiling.py: parallel_check.py's two poses of
# the main cell, the 8 recon views of phase 4c, and the ranks of 11b: two
# on the one card, joined by gloo (NCCL refuses two ranks on one device).
PAR_RANKS = 2


def parallel_phase(T, subject, rot0, trans, kw, cli_losses, recon_losses, fwd_bound) -> dict:
    """Phase 11: 11a a world of one on NCCL in this process; 11b two ranks on
    the card (experiments/parallel_check.py); 11c the profiler."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from diffdrr_tpu_torch.experiments import reconstruction as recon_cli
    from diffdrr_tpu_torch.experiments.parallel_check import POSE_ROT, POSE_TRANS, RECON_STEPS
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.parallel import make_mesh, make_sharded_render
    from diffdrr_tpu_torch.profiling import render_cost

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    # 11a. make_mesh() with nothing wired: a world of one, NCCL on the card.
    mesh = make_mesh()
    if (dist.get_backend(), dist.get_world_size(), tuple(mesh.shape)) != ("nccl", 1, (1, 1)):
        raise AssertionError(f"make_mesh(): {dist.get_backend()}, {dist.get_world_size()} "
                             f"ranks, shape {tuple(mesh.shape)}")
    rot2, trans2 = torch.tensor(POSE_ROT, device=dev), torch.tensor(POSE_TRANS, device=dev)
    for renderer, fwd in (("siddon", "siddon_fwd"), ("trilinear", "joseph_fwd")):
        drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0, renderer=renderer)
        render = make_sharded_render(drr, mesh, "euler_angles", "ZXY")
        brick.clear_cache()
        reset_all_launches()
        got = render(rot2, trans2)
        torch.cuda.synchronize()
        no_other_launches(f"world of one, {renderer}", all_launches(), {fwd: 1, "brick_copy": 1})
        ref = drr(rot2, trans2, **kw)
        if got.shape != (2, 1, 200, 200) or not torch.equal(got, ref):
            raise AssertionError(f"world of one, {renderer}: the sharded render is not "
                                 f"DRR.__call__'s bit for bit")
    argv = ["--volume-size", str(CLI_VOLUME_SIZE), "--height", str(CLI_HEIGHT),
            "--n-views", str(N_VIEWS), "--n-iters", str(N_RECON_STEPS), "--mesh"]
    brick.clear_cache()
    reset_all_launches()
    res = recon_cli.main(argv)
    torch.cuda.synchronize()
    no_other_launches("reconstruction CLI --mesh", all_launches(),
                      {"joseph_fwd": N_RECON_STEPS + 1, "joseph_bwd_vol": N_RECON_STEPS,
                       "brick_copy": N_RECON_STEPS + 1})
    rel = float(np.max(np.abs(np.array(res["losses"]) / np.array(cli_losses) - 1)))
    if not rel <= 1e-6:
        raise AssertionError(f"--mesh losses {res['losses']} vs {cli_losses}: {rel:.3e}")
    t_cli = statistics.median(res["step_ms"][2:])
    log(f"[parallel] 11a world of one ({dist.get_backend()}): sharded renders of 2 poses "
        f"(siddon, trilinear) equal DRR.__call__ bit for bit, one forward each; recon CLI "
        f"--mesh launches as without it, losses {res['losses'][0]:.5g} -> "
        f"{res['losses'][-1]:.5g}, {rel:.2e} relative off the CLI's, step median "
        f"{t_cli:.3f} ms")
    del res

    # 11c. render_cost counts siddon_fwd's bytes and operations as bound() does.
    drr = T.DRR(subject, sdd=1020.0, height=200, delx=2.0)
    rc = render_cost(drr, axis=2, pose=T.convert(rot0, trans, **kw))
    if roofline(rc.bytes, rc.flops) != fwd_bound:
        raise AssertionError(f"render_cost {rc} gives {roofline(rc.bytes, rc.flops)}, "
                             f"chip_smoke's bound {fwd_bound}")
    log(f"[parallel] 11c render_cost of the main DRR: {rc}; its roofline is siddon_fwd's "
        f"bound {fwd_bound[0]:.4f} ms by {fwd_bound[1]}")
    dist.destroy_process_group()
    del drr, mesh

    # 11b. Two ranks on the card, joined by gloo on CUDA tensors.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "diffdrr_tpu_torch.experiments.parallel_check",
             "--rank", str(r), "--world", str(PAR_RANKS), "--rendezvous", f"file://{tmp}/rdv",
             "--out", f"{tmp}/rank%d.json"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(PAR_RANKS)]
        try:
            ends = [p.communicate(timeout=400) + (p.returncode,) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        failed = [f"rank {r} exited {rc}:\n{out[-2000:]}\n{err[-4000:]}"
                  for r, (out, err, rc) in enumerate(ends) if rc != 0]
        if failed:
            raise AssertionError("parallel_check failed: " + "\n".join(failed))
        recs = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    for r, rec in enumerate(recs):
        if rec["backend"] != "gloo":
            raise AssertionError(f"rank {r} ran {rec['backend']}")
        losses = rec["recon"]["losses"]
        rel = float(np.max(np.abs(np.array(losses) / np.array(recon_losses[:len(losses)]) - 1)))
        if not rel <= 1e-5:
            raise AssertionError(f"rank {r}: sharded recon losses {losses} vs one device "
                                 f"{recon_losses[:len(losses)]}: {rel:.3e}")
        rec["recon"]["rel_to_one_device"] = rel
        kernels = rec["trace"]["kernels"] if r == 0 else []
        if r == 0 and not all(any(k in n for n in kernels) for k in (
                "siddon_fwd_kernel", "siddon_bwd_vol_kernel", "brick_copy_kernel")):
            raise AssertionError(f"the trace of a sharded step names {kernels}")
    if recs[0]["recon"]["hashes"] != recs[1]["recon"]["hashes"]:
        raise AssertionError("the ranks' densities differ after a sharded recon step")
    for r, rec in enumerate(recs):
        log(f"[parallel] 11b rank {r}/{PAR_RANKS} ({rec['backend']} on {rec['device']}, "
            f"{rec['seconds']:.1f} s): collectives on CUDA tensors {rec['collectives']}")
        log(f"[parallel] 11b rank {r} renders (vs the unsharded card render): " + "; ".join(
            f"{k} {v}" for k, v in rec["renders"].items()))
        log(f"[parallel] 11b rank {r} slabs (2 x 256 planes along axis 0, lateral pose): "
            + "; ".join(f"{k} {v}" for k, v in rec["slabs"].items()))
        log(f"[parallel] 11b rank {r} recon (2, 1), {RECON_STEPS} steps: losses "
            f"{rec['recon']['losses']} ({rec['recon']['rel_to_one_device']:.2e} relative off "
            f"one device), launches a step {rec['recon']['launches']}, step ms "
            f"{[round(x, 3) for x in rec['recon']['step_ms']]} (median "
            f"{rec['recon']['step_ms_median']:.3f}); collectives alone (gloo through the "
            f"host on one card: no measure of NCCL across cards) {rec['collectives_ms']}")
    log(f"[parallel] 11b densities equal bit for bit on both ranks after each step; rank 0's "
        f"trace {recs[0]['trace']['files']} names {recs[0]['trace']['kernels']}")
    log(f"[parallel] phase 11 took {time.perf_counter() - t0:.1f} s")
    return {"ranks": recs}


CUT_SHAPE = (128, 128, 64)
N_LABELS = 6
TUTORIAL_TIMEOUT = 300


class HostTimer:
    """Host milliseconds of named module functions while installed (each
    call's time added to its name), restored on exit."""

    def __init__(self, *targets):
        self.targets = targets  # (module, function name)
        self.ms = {}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self.saved:
            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.ms[_name] = self.ms.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def expect_native(phase, want):
    """``want`` native calls exactly (a native call that fell back to NumPy
    counts none), 0 for every other entry point."""
    from diffdrr_tpu_torch.native import build

    got = build.call_counts()
    bad = {k: (got.get(k, 0), want.get(k, 0)) for k in {**got, **want}
           if got.get(k, 0) != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{phase}: native calls (got, want) {bad}; build errors "
                             f"{build.build_errors}")


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def check_mesh(name, mesh, bounds):
    """Faces, their indices in range, every vertex inside ``bounds``."""
    import numpy as np

    F, V = mesh.faces, mesh.vertices
    if not (mesh.n_faces > 0 and F.min() >= 0 and F.max() < mesh.n_vertices
            and np.isfinite(V).all()):
        span = f"{F.min()}..{F.max()}" if len(F) else "none"
        raise AssertionError(f"{name}: {mesh.n_faces} faces over {mesh.n_vertices} vertices, "
                             f"indices {span}")
    lo = np.array([b[0] for b in bounds]) - 1e-3
    hi = np.array([b[1] for b in bounds]) + 1e-3
    if not ((V >= lo).all() and (V <= hi).all()):
        raise AssertionError(f"{name}: vertices {V.min(0)}..{V.max(0)} leave the volume's "
                             f"bounds {lo}..{hi}")


def run_tutorials(names, timeout):
    """Start the named tutorials together, each a subprocess on the card
    (its output to a file), and wait for each within ``timeout`` s of the
    start. Returns {name: (seconds to its end, stdout)}."""
    import tempfile

    tdir = ROOT / "diffdrr_tpu_torch" / "tutorials"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tutorials_") as tmp:
        t0 = time.perf_counter()
        procs, ends = {}, {}
        for n in names:
            out, err = open(Path(tmp, f"{n}.out"), "w"), open(Path(tmp, f"{n}.err"), "w")
            with out, err:
                procs[n] = subprocess.Popen([sys.executable, str(tdir / f"{n}.py")], cwd=ROOT,
                                            stdout=out, stderr=err, text=True)
        try:
            while len(ends) < len(procs) and time.perf_counter() - t0 < timeout:
                for n, proc in procs.items():
                    if n not in ends and proc.poll() is not None:
                        ends[n] = time.perf_counter() - t0
                time.sleep(0.05)
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()
        failed, done = [], {}
        for n, proc in procs.items():
            out = Path(tmp, f"{n}.out").read_text()
            err = Path(tmp, f"{n}.err").read_text()
            if n not in ends:
                failed.append(f"{n}: no end within {timeout} s")
            elif proc.returncode != 0 or "all checks passed" not in out:
                failed.append(f"{n} exited {proc.returncode}:\n{out[-2000:]}\n{err[-3000:]}")
            else:
                done[n] = (ends[n], out)
    if failed:
        raise AssertionError("tutorials failed:\n" + "\n".join(failed))
    return done


def viz_phase(T, card: str, shape=(512, 512, 133), cut=CUT_SHAPE, height=200, device=None,
              tutorials=True) -> dict:
    """Phase 12: the native meshers, QEM and HU transfer, drr_to_mesh,
    labelmap_to_mesh, the HTML scene, the animation frames and the tutorials."""
    import base64
    import csv
    import re
    import tempfile

    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from diffdrr_tpu_torch import meshops, nifti, scene_html, viz
    from diffdrr_tpu_torch.data import Image
    from diffdrr_tpu_torch.experiments import gif
    from diffdrr_tpu_torch.native import build as nbuild
    from diffdrr_tpu_torch.ops.kernels import brick
    from diffdrr_tpu_torch.registration import make_registration_step

    t_phase = time.perf_counter()
    ms = {}
    kw = dict(parameterization="euler_angles", convention="ZXY")

    # 12a. Build the native libraries; load the CT through the HU transfer.
    t0 = time.perf_counter()
    libs = nbuild.build_all()
    ms["build"] = (time.perf_counter() - t0) * 1e3
    missing = [n for n, lib in libs.items() if lib is None]
    if missing:
        raise AssertionError(f"native libraries failed to build: {missing}: "
                             f"{nbuild.build_errors}")
    log(f"[viz] 12a g++ built {', '.join(libs)} in {ms['build']:.1f} ms "
        f"({ {k: round(v, 2) for k, v in nbuild.build_seconds.items()} or 'cached'} s each)")
    nbuild.reset_call_counts()
    t0 = time.perf_counter()
    subject = T.load_example_ct(shape=shape, device=device)
    ms["load_ct"] = (time.perf_counter() - t0) * 1e3
    if nbuild.call_counts()["hu_to_density"] < 1:
        raise AssertionError(f"load_example_ct did not run the native HU transfer: "
                             f"{nbuild.call_counts()}, {nbuild.build_errors}")
    small = T.load_example_ct(shape=cut, device="cpu")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_viz_") as tmp:
        path = Path(tmp) / "cut.nii.gz"
        nifti.save(path, small.volume.data, small.volume.affine)
        nbuild.reset_call_counts()
        t0 = time.perf_counter()
        back = Image.load(path)
        ms["read_nii_gz"] = (time.perf_counter() - t0) * 1e3
    expect_native("12a .nii.gz read", {"gunzip": 1})
    if not np.array_equal(back.data, small.volume.data):
        raise AssertionError("the .nii.gz read back differs from the volume written")
    log(f"[viz] 12a {shape} CT loaded in {ms['load_ct']:.1f} ms (native HU transfer); a "
        f"{cut} .nii.gz read back bit for bit through the native gunzip in "
        f"{ms['read_nii_gz']:.1f} ms")

    # 12b. drr_to_mesh on the full CT, both methods, the whole pipeline.
    bounds = subject.volume.get_bounds()
    meshes = {}
    for method, want in (("surface_nets", {"surface_nets": 1, "taubin_smooth": 1}),
                         ("marching_cubes", {"marching_cubes": 1, "qem_decimate": 1})):
        nbuild.reset_call_counts()
        # (the last clean's time is the total less these; decimate's and
        # extract_largest's include their own cleans)
        with HostTimer((viz, method), (meshops, "extract_largest"), (meshops, "decimate"),
                       (meshops, "fill_holes")) as timer:
            t0 = time.perf_counter()
            mesh = viz.drr_to_mesh(subject, method=method, threshold=300.0)
            total = (time.perf_counter() - t0) * 1e3
        expect_native(f"12b drr_to_mesh {method}", want)
        check_mesh(f"drr_to_mesh {method}", mesh, bounds)
        meshes[method] = mesh
        ms[f"drr_to_mesh_{method}"] = total
        ms.update({f"{method}.{k}": v for k, v in timer.ms.items()})
        log(f"[viz] 12b drr_to_mesh {method}: {mesh.n_vertices} vertices, {mesh.n_faces} "
            f"faces in {total:.1f} ms (host ms {({k: round(v, 1) for k, v in timer.ms.items()})})")
    vol = small.volume.data
    a, b = viz._surface_nets_numpy(vol, 300.0), viz.surface_nets(vol, 300.0, smooth_iters=0)
    if not (a.n_vertices == b.n_vertices > 0 and np.allclose(
            np.sort(a.vertices.round(0), axis=0), np.sort(b.vertices.round(0), axis=0),
            atol=1.0)):
        raise AssertionError(f"surface_nets native vs NumPy at {cut}: {b.n_vertices} vs "
                             f"{a.n_vertices} vertices")
    a, b = viz._marching_cubes_numpy(vol, 300.0), viz.marching_cubes(vol, 300.0)
    # The vertex sets to 1e-4 (tests/test_viz.py rounds to 4 decimals, which
    # a 1-ulp difference can straddle at these coordinates): every vertex
    # of each within 1e-4 of one of the other's.
    near = max(cKDTree(a.vertices).query(b.vertices)[0].max(),
               cKDTree(b.vertices).query(a.vertices)[0].max()) if b.n_vertices else np.inf
    if not (a.n_vertices == b.n_vertices > 0 and a.n_faces == b.n_faces and near <= 1e-4):
        raise AssertionError(f"marching_cubes native vs NumPy at {cut}: {b.n_vertices}/"
                             f"{b.n_faces} vs {a.n_vertices}/{a.n_faces}, vertices {near} apart")
    log(f"[viz] 12b at {cut}: native and NumPy surface_nets ({b.n_vertices} vertices) and "
        f"marching_cubes ({b.n_faces} faces, vertex sets {near:.2e} apart) agree")

    # 12c. labelmap_to_mesh for each label.
    nbuild.reset_call_counts()
    t0 = time.perf_counter()
    faces = {}
    for label in range(1, N_LABELS + 1):
        mesh = viz.labelmap_to_mesh(subject, label)
        check_mesh(f"labelmap_to_mesh {label}", mesh, subject.mask.get_bounds())
        faces[label] = mesh.n_faces
    ms["labelmap_to_mesh_6"] = (time.perf_counter() - t0) * 1e3
    expect_native("12c labelmap_to_mesh", {"surface_nets": N_LABELS, "taubin_smooth": N_LABELS})
    log(f"[viz] 12c labelmap_to_mesh faces {faces} in {ms['labelmap_to_mesh_6']:.1f} ms")

    # 12d. The HTML scene of the main cell's DRR.
    drr = T.DRR(subject, sdd=1020.0, height=height, delx=2.0, device=device)
    dev = drr.device
    pose = T.convert(torch.tensor(BENCH_ROT, device=dev), torch.tensor(BENCH_TRANS, device=dev),
                     **kw)
    textured = []
    quad = scene_html._image_quad_payload

    def capture(corners, image, *a, **k):
        textured.append(image)
        return quad(corners, image, *a, **k)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as tmp:
        brick.clear_cache()
        reset_all_launches()
        scene_html._image_quad_payload = capture
        try:
            t0 = time.perf_counter()
            out = scene_html.visualize_scene_html(drr, pose, Path(tmp) / "scene.html",
                                                  threshold=300.0)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms["scene_html"] = (time.perf_counter() - t0) * 1e3
        finally:
            scene_html._image_quad_payload = quad
        launches = all_launches()
        text = out.read_text()
    no_other_launches("12d visualize_scene_html", launches, {"siddon_fwd": 1, "brick_copy": 1}
                      if dev.type == "cuda" else {})
    with torch.no_grad():
        direct = drr(pose)[0, 0].cpu().numpy()
    if len(textured) != 1 or not np.array_equal(textured[0], direct):
        raise AssertionError("12d: the scene's texture is not drr(pose) bit for bit")
    scene = json.loads(re.search(r"const SCENE = (\{.*?\});\n", text, re.S).group(1))
    kinds = [it["type"] for it in scene["items"]]
    tex = np.frombuffer(base64.b64decode(scene["items"][2]["texture"]), np.uint8)
    lum = ((direct - direct.min()) / (direct.max() - direct.min()) * 255).astype(np.uint8)
    if kinds != ["mesh", "mesh", "texquad", "lines"] or not np.array_equal(
            tex.reshape(height, height, 4)[..., 0], lum):
        raise AssertionError(f"12d: scene items {kinds}, or its texture is not the render's")
    if "http" in text.replace("http-equiv", ""):
        raise AssertionError("12d: the scene file references an outside resource")
    log(f"[viz] 12d visualize_scene_html: launches {nonzero(launches)}; texture equal to "
        f"drr(pose) bit for bit; {len(text.encode())} bytes written in "
        f"{ms['scene_html']:.1f} ms")

    # 12e. Animation frames of a 60-step trilinear registration's poses.
    drr_t = T.DRR(subject, sdd=1020.0, height=height, delx=2.0, renderer="trilinear",
                  device=device)
    rot0 = torch.tensor(BENCH_ROT, device=dev)
    trans = torch.tensor(BENCH_TRANS, device=dev)
    with torch.no_grad():
        target = drr_t(rot0, trans, **kw)
    init_fn, step_fn = make_registration_step(drr_t, target, "euler_angles", "ZXY",
                                              lr_rotation=1e-3, lr_translation=1e-1)
    params, opt = init_fn(rot0, trans + 5.0)
    rows = []
    for _ in range(N_REG_STEPS):
        r = params["rotation"].detach()[0].tolist()
        t = params["translation"].detach()[0].tolist()
        rows.append(dict(zip(gif.POSE_COLUMNS, r + t)))
        params, opt, _ = step_fn(params, opt)
    brick.clear_cache()
    reset_all_launches()
    t0 = time.perf_counter()
    frames = viz.animation_frames(rows, drr_t)
    ms["frames_60"] = (time.perf_counter() - t0) * 1e3
    launches = all_launches()
    no_other_launches("12e animation frames", launches,
                      {"joseph_fwd": N_REG_STEPS, "brick_copy": 1} if dev.type == "cuda" else {})
    with torch.no_grad():
        for k, row in enumerate(rows):
            r = torch.tensor([[row[c] for c in gif.POSE_COLUMNS[:3]]], device=dev)
            t = torch.tensor([[row[c] for c in gif.POSE_COLUMNS[3:]]], device=dev)
            if not np.array_equal(frames[k], drr_t(r, t, **kw)[0, 0].cpu().numpy()):
                raise AssertionError(f"12e: frame {k} differs from a direct render at its pose")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = Path(tmp) / "trace.csv"
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["iter", *gif.POSE_COLUMNS])
            w.writeheader()
            w.writerows(dict(row, iter=k) for k, row in enumerate(rows))
        read = gif.read_trace(path)
    if [[float(r[c]) for c in gif.POSE_COLUMNS] for r in read] != [
            [row[c] for c in gif.POSE_COLUMNS] for row in rows]:
        raise AssertionError("12e: gif.read_trace does not give the trace's poses")
    moved = float(np.abs(np.array([rows[-1][c] for c in gif.POSE_COLUMNS[3:]])
                         - np.array([rows[0][c] for c in gif.POSE_COLUMNS[3:]])).max())
    log(f"[viz] 12e animation_frames over {N_REG_STEPS} registration poses (translation moved "
        f"{moved:.3f} mm): launches {nonzero(launches)}, {ms['frames_60']:.1f} ms host; each frame "
        f"equal to a direct render; gif.read_trace gives the same poses")

    # 12f. The tutorials on the card.
    if tutorials:
        names = sorted(p.stem for p in (ROOT / "diffdrr_tpu_torch" / "tutorials").glob("*.py"))
        if len(names) != 9:
            raise AssertionError(f"expected 9 tutorials, found {names}")
        t0 = time.perf_counter()
        done = run_tutorials([n for n in names if n != "07_timing"], TUTORIAL_TIMEOUT)
        done.update(run_tutorials(["07_timing"], TUTORIAL_TIMEOUT))
        ms["tutorials"] = (time.perf_counter() - t0) * 1e3
        log(f"[viz] 12f tutorials passed on the card in {ms['tutorials'] / 1e3:.1f} s: "
            + ", ".join(f"{n} {s:.1f} s" for n, (s, _) in sorted(done.items())))
        for line in done["07_timing"][1].splitlines():
            if "ms/render" in line or line.startswith("timing on"):
                log(f"[viz] 12f 07_timing: {line}")
    log(f"[viz] host ms on {card}: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    log(f"[viz] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {"ms": ms}


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
    from diffdrr_tpu_torch.experiments.fwdgrad_timing import burst_ms
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
    for axis in (0, 2):  # the bricked copy at both pinned axes
        rows_a, _ = rays_of(small, rot_g, trans_g, axis)
        e3 = max(e3, check_max(f"siddon_fwd_max axis {axis} 128x128x64",
                               K.siddon_fwd_max(rows_a, dens_s, axis),
                               K.siddon_fwd_max_plain(rows_a, dens_s, axis)))
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
    brick.brick_density.launches = 0
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
    mip_launches["brick_copy"] = brick.brick_density.launches
    log(f"[mip] launches {mip_launches}, slab escapes {drr.siddon_escapes}")
    if drr.siddon_escapes != 0 or min(mip_launches[n] for n in (
            "siddon_fwd_max", "siddon_bwd_rays", "siddon_bwd_vol")) < 1:
        raise AssertionError("the MIP path did not run through its kernels")
    # dens_p is a new density: siddon_fwd_max bricks it once (the MIP
    # backward's siddon_bwd_rays reads the density itself); the two pose
    # gradients render the CT, whose copy phase 6a left cached, and the
    # two-pass one's siddon_bwd_rays (sum mode) reads that copy.
    if mip_launches["brick_copy"] != 1:
        raise AssertionError(f"the MIP path made {mip_launches['brick_copy']} bricked copies")
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
    # siddon_bwd_rays' sum-mode rows are siddon_fwdgrad's times g, bit for bit.
    err_pose = check_equal("pose gradient, fused_pose_bwd=False vs fused", pg_two, pg_fused)
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
    siddon_recon_losses = losses
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
    def fwd_max():
        return K.siddon_fwd_max(rows_m, drr.density, ax_m)

    t_max = median_ms(fwd_max, 20)
    t_max_b2b = burst_ms(fwd_max)
    t_max_copy = median_ms(fwd_max, 20, before=brick.clear_cache)
    t_max_plain = median_ms(lambda: K.siddon_fwd_max_plain(rows_m, drr.density, ax_m), 3, 1)
    def bwd_rays():
        return K.siddon_bwd_rays(rows_m, drr.density, ax_m, g_m)

    # Sum mode at full width: its plain version, and siddon_fwdgrad's rows
    # times g to the last bit.
    err_br_sum = max(
        check_fused("siddon_bwd_rays[sum] 512x512x133 @200^2", bwd_rays(),
                    K.siddon_bwd_rays_plain(rows_m, drr.density, ax_m, g_m)),
        check_equal("siddon_bwd_rays[sum] vs siddon_fwdgrad rows * g @200^2", bwd_rays(),
                    K.siddon_fwdgrad(rows_m, drr.density, ax_m)[:9] * g_m))
    t_br = median_ms(bwd_rays, 20)
    t_br_b2b = burst_ms(bwd_rays)
    t_br_plain = median_ms(lambda: K.siddon_bwd_rays_plain(rows_m, drr.density, ax_m, g_m), 3, 1)
    t_br_mip = median_ms(lambda: K.siddon_bwd_rays(rows_m, drr.density, ax_m, g_m, arg_m), 20)
    shape = drr.density.shape
    t_bv = median_ms(lambda: K.siddon_bwd_vol(rows_v, g_v, shape, ax_v), 20)
    t_bv_alone = scatter_alone_ms("siddon", "siddon_bwd_vol", rows_v, g_v, shape, ax_v)
    t_bv_plain = median_ms(lambda: K.siddon_bwd_vol_plain(rows_v, g_v, shape, ax_v), 2, 1)
    t_bv_lib = siddon_library_ms(rows_v, drr.density, ax_v, g_v)
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
    log(f"[time] siddon_fwd_max {t_max:.4f} ms one call, {t_max_b2b:.4f} back to back with "
        f"the bricked copy cached, {t_max_copy:.4f} making it anew "
        f"(plain {t_max_plain:.2f}, bound {b_max:.4f} by "
        f"{by_max}); siddon_bwd_rays sum {t_br:.4f} ms one call, {t_br_b2b:.4f} back to back "
        f"(plain {t_br_plain:.2f}, bound {b_br:.4f} by {by_br}; vs plain {err_br_sum:.3e}, "
        f"equal to siddon_fwdgrad's rows * g), mip {t_br_mip:.4f} ms (bound {b_br_mip:.4f} by "
        f"{by_br_mip}); all at 200^2 rays, axis {ax_m}")
    log(f"[time] siddon_bwd_vol at {rows_v.shape[1]} rays {t_bv:.4f} ms with its zero fill, "
        f"{t_bv_alone:.4f} ms alone ({int((g_v == 0).sum())} rays with g = 0; plain "
        f"{t_bv_plain:.2f}, bound {b_bv:.4f} by {by_bv}; grid_sampler_3d_backward's nearest "
        f"input gradient at the segments' midpoints {t_bv_lib:.4f} ms); the zero fill alone "
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
    ch_times, ch_extra = channel_timings(ch)
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
    # grid_sampler_3d_backward at the same samples: the input gradient for
    # joseph_bwd_vol, the grid gradient for joseph_bwd_rays and joseph_fwdgrad.
    t_lib_jbv = march_library_ms(rec["rows_v"], rec["density"], 2, rec["h"], rec["n"],
                                 rec["g_v"])
    t_lib_jbr = march_library_ms(rows_m, dens_m, 2, 1.0, X, g_j, input_grad=False)
    t_lib_jfg = march_library_ms(rows_r, dens_m, 2, 1.0, X, input_grad=False)
    log(f"[time] grid_sampler_3d_backward at the Joseph kernels' samples: input gradient "
        f"{t_lib_jbv:.4f} ms ({rec['rows_v'].shape[1]} rays, g * scale), grid gradient "
        f"{t_lib_jbr:.4f} ms (200^2, g * scale) and {t_lib_jfg:.4f} ms (200^2, scale)")
    lat = lateral_jrays(tri["drr"], dens_m)
    jmax_extra = joseph_max_timings(dens_m, rows_m, X, lat)
    jbr_extra, err_jbr = joseph_bwd_rays_timings(dens_m, rows_m, X, g_j, lat)
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
         "replaces": "none: layout glue that the forwards (the MIP and channel ones "
                     "too), the fused kernels, the two two-pass ray backwards' sum modes "
                     "and joseph_bwd_rays_ch read",
         "launches": recon_launches["brick_copy"], "max_abs_err": 0.0,
         "ms": t_copy, "plain_ms": t_copy_plain, "bound_ms": b_copy, "bound_by": by_copy,
         "library_ms": None},
        {"name": "siddon_fwd[512^3]", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:573",
         "launches": cube_launches, "max_abs_err": err_c,
         "ms": t_c, "plain_ms": t_c_plain, "bound_ms": b_c, "bound_by": by_c,
         "library_ms": None},
        {"name": "siddon_fwd_max", "route": "cuda",
         "design": fused_design("siddon.cuh", "kMaxLanes"), "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:189",
         "launches": mip_launches["siddon_fwd_max"], "max_abs_err": err_max,
         "ms": t_max, "ms_back_to_back": t_max_b2b, "ms_with_copy": t_max_copy,
         "plain_ms": t_max_plain, "bound_ms": b_max, "bound_by": by_max, "library_ms": None},
        {"name": "siddon_bwd_rays", "route": "cuda",
         "design": fused_design("siddon.cuh", "kBwdLanes")
         + " (sum); one thread per ray, strided (MIP)",
         "source": src, "replaces": "diffdrr_tpu/ops/pallas/siddon.py:248",
         "launches": mip_launches["siddon_bwd_rays"],
         "max_abs_err": max(err_br, err_br_sum, err_pose, e4["sum"], e4["mip"]),
         "ms": t_br, "ms_back_to_back": t_br_b2b, "ms_mip": t_br_mip, "plain_ms": t_br_plain,
         "bound_ms": b_br, "bound_by": by_br, "library_ms": None},
        {"name": "siddon_bwd_vol", "route": "cuda", "source": src,
         "replaces": "diffdrr_tpu/ops/pallas/siddon.py:501",
         "launches": recon_launches["siddon_bwd_vol"],
         "max_abs_err": max(err_bv, err_bv0, err_bv_mip, e5["sum"], e5["mip"]),
         "ms": t_bv, "plain_ms": t_bv_plain, "bound_ms": b_bv, "bound_by": by_bv,
         "library_ms": t_bv_lib},
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
         "ms": jc["t"], "ms_1000": jc["t_k"], "plain_ms": jc["t_plain"], "bound_ms": jc["b"],
         "bound_by": jc["by"], "library_ms": jc["t_lib"], "library_ms_1000": jc["t_lib_k"]},
        dict(jrec("joseph_fwd_max", "fwd_max", 376, jm["launches"]["joseph_fwd_max"],
                  max(jm["err_max"], jsmall["fwd_max"], jmax_extra.pop("err_lateral")),
                  library_ms=t_lib),
             design=fused_design("joseph.cuh", "kMaxLanes"), **jmax_extra),
        dict(jrec("joseph_fwdgrad", "fwdgrad", 732, tri["launches"]["joseph_fwdgrad"],
                  max(tri["err_fg"], jsmall["fwdgrad_sum"], jsmall["fwdgrad_max"]),
                  library_ms=t_lib_jfg),
             design=fused_design("joseph.cuh"), ms_with_copy=t_jfg_copy),
        dict(jrec("joseph_bwd_rays", "bwd_rays", 600,
                  jm["sum_launches"]["joseph_bwd_rays"] + jm["launches"]["joseph_bwd_rays"],
                  max(jm["err_br"], err_jbr, jsmall["bwd_rays_sum"], jsmall["bwd_rays_mip"]),
                  library_ms=t_lib_jbr),
             design=fused_design("joseph.cuh", "kBwdLanes")
             + " (sum); one thread per ray, strided (MIP)", ms_mip=jtimes["bwd_rays_mip"][0],
             **jbr_extra),
        jrec("joseph_bwd_vol", "bwd_vol", 903, rec["launches"]["joseph_bwd_vol"],
             max(rec["err_bv"], jm["err_bv_mip"], err_jbv0, jsmall["bwd_vol_sum"],
                 jsmall["bwd_vol_mip"]), library_ms=t_lib_jbv),
    ]
    # Channel kernels: launches of phase 8b's two backwards (joseph, trilinear).
    jtimes.update(ch_times)
    ch_design = {"fwd_ch": fused_design("joseph.cuh", "kFwdChLanes"),
                 "bwd_rays_ch": fused_design("joseph.cuh", "kChannelLanes"),
                 "bwd_vol_ch": "one warp per ray"}
    kernels += [dict(jrec(f"joseph_{key}", key, line, ch["launches"][f"joseph_{key}"],
                          max(ch["errs"][key], ch_small[key])),
                     **ch_extra[key], **({"design": ch_design[key]} if key in ch_design else {}))
                for key, line in (("fwd_ch", 376), ("bwd_rays_ch", 600), ("bwd_vol_ch", 903))]
    log(f"[channels] Siddon channel sum vs siddon_fwd {err_sid_ch:.3e}; p_subsample=0.1 render "
        f"{t_sub:.3f} ms, full render {t_full:.3f} ms")

    # 9. The registration CLI at full width -----------------------------------
    registration_cli_phase(card)

    # 10. The rest of pose estimation at full width ----------------------------
    t10 = time.perf_counter()
    pose_estimation_phase(card)
    log(f"[lbfgs] phase 10 took {time.perf_counter() - t10:.1f} s")

    # 11. Several ranks: parallel/ and the profiler ----------------------------
    parallel_phase(T, subject, rot0, trans, kw, rec["losses"], siddon_recon_losses,
                   (b_fwd, by_fwd))
    del subject

    # 12. Visualization and scene export; the tutorials ------------------------
    viz_phase(T, card)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
