"""Profiling and observability: traces, annotations, a render's cost, the build cache.

Counterpart of ``diffdrr_tpu/profiling.py`` on ``torch.profiler``:

    from diffdrr_tpu_torch.profiling import annotate, trace

    with trace("traces/render"):
        with annotate("render-200"):
            img = drr(rot, trans, parameterization="euler_angles", convention="ZXY")
            torch.cuda.synchronize()

``trace`` records the host's operators and, with a card, the device's
kernels (CUPTI), the port's CUDA kernels by their names
(``siddon_fwd_kernel``, ...), and writes a Chrome trace that Perfetto and
TensorBoard open. Under a running profiler the DRR's dispatch opens three
spans of its own, through ``annotate``:

* ``drr.pose``: the pose geometry of a call, ``convert`` and the
  detector's source and target rays (``DRR.forward``, the reconstruction
  step's loss);
* ``drr.render``: one render, ``DRR._render``: the affine inverses, the
  march axis, the ray packing and the kernels' launch (or the oracle);
* ``drr.sync``: a read of a device value on the host inside a render (the
  march axis and Siddon's slab guard from the corner rays, the Joseph
  oracle's axis); its length is how long the host waited for the card.

In a Chrome trace they sit on the host thread's row, ``drr.sync`` inside
``drr.render``; the profiler mirrors each onto the card's row as a
``gpu_user_annotation``. A ``drr.sync`` ends when the card has finished
what was queued before it; the card then idles until the next kernel, and
the spans the host was in meanwhile (the rest of ``drr.render``, the next
``drr.pose``) name the dispatch it waited for.

``render_cost`` counts what one forward render on the port's kernels
reads, writes and computes, as ``chip_smoke.py``'s bounds count it; the
TPU's tile, window, MXU and DMA terms have no counterpart.
``enable_compilation_cache`` points the kernels' build at one directory so
that separate processes (a mesh's ranks, the CLIs) reuse one ``nvcc`` build.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import torch

__all__ = ["trace", "annotate", "render_cost", "RenderCost", "enable_compilation_cache"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its trace into ``log_dir``.

    CPU activity always, CUDA activity when a card is present; the trace is
    ``<host>_<pid>.<time>.pt.trace.json``. Yields the profiler (its
    ``key_averages()`` and ``events()`` are readable after the block)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
            str(log_dir))) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Label the enclosed work in profiler timelines (``record_function``); nests.

    With no profiler running it returns one shared ``nullcontext`` and opens
    nothing, so a span on a hot path costs a flag test when no one traces.
    """
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


# The float32 arithmetic a kernel does on the data (add, subtract, multiply,
# divide, abs, floor and rint; comparisons, min/max and selects are not
# counted), counted by hand from its header.
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
SIDDON_FWD = dict(slab_ops=2, segment_ops=4)
# csrc/joseph.cuh, per in-slab (ray, step) sample: step_at 21 (k, alpha and
# the transverse position 7, its floors and offsets 4, four tent weights
# 10); then 19 (trace_fwd: four neighbour positions 8, bilinear 9, the
# weighted sum 2), 18 (trace_fwd_max), 58 (trace_fwdgrad: positions 8,
# step_terms 42, eight sums), 57 and 7 products by g per ray
# (trace_bwd_rays), or 22 (trace_bwd_vol: wy * g 2, then per neighbour its
# position 2, the product 2 and the atomic add). A fractional stride adds
# 18 to each: k's floor and fraction 2, and per neighbour a second plane's
# lerp (or weight and scatter) 4. step_range costs 9 per ray; a MIP backward
# skips it and visits only the argmax step.
J_STEP_OPS = 21
J_BLEND_OPS = 18
J_RANGE_OPS = 9
JOSEPH_FWD_SAMPLE_OPS = 19
# A forward's bytes per ray: the 9 float32 rows in, the value out.
FWD_RAY_BYTES = 36 + 4


def voxel_bytes(storage=None) -> int:
    """Bytes a voxel of the kernels' density copy takes: 4 (float32), 2 under
    ``storage="bf16"``."""
    return 2 if storage == "bf16" else 4


def siddon_work(rows, density, axis, arg=None):
    """(non-empty ray-slab steps, non-empty segments, distinct voxels read)
    of the Siddon slab march of ``rows (9, R)`` through ``density``.

    What the data needs, not what a kernel does: empty slabs and zero-length
    segments are not counted, and a voxel read by many rays counts once.
    With a MIP argmax ``arg``, only each ray's argmax slab and segment.
    """
    from .ops.kernels import siddon as K
    from .ops.kernels.prep import march_perm

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


def joseph_work(rows, density, axis, h, n_steps, arg=None):
    """(in-slab samples, distinct voxels read, distinct label voxels read)
    of the Joseph march of ``rows (9, R)`` through ``density`` at stride ``h``.

    What the data needs: samples outside a ray's [amin, amax] are not
    counted, and a voxel read by many samples counts once. With a MIP argmax
    ``arg``, only each ray's argmax step. The label voxels are those a
    channel kernel reads (``label_at``: the nearest voxel of each sample).
    """
    from .ops.kernels import joseph as J
    from .ops.kernels.prep import march_perm

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


@dataclass
class RenderCost:
    """What one forward render of a DRR on the port's kernels moves and computes."""

    renderer: str
    axis: int
    n_steps: int  # planes (Siddon: slabs) marched, at the DRR's stride
    rays: int
    bytes: float  # each ray's rows in and value out, each voxel read once
    flops: float  # float32 operations
    exact: bool  # counted on a pose's rays (True) or the most any pose needs

    def __str__(self) -> str:
        how = "on the pose's rays" if self.exact else "at most"
        return (f"{self.renderer} axis={self.axis} steps={self.n_steps} rays={self.rays} "
                f"bytes={self.bytes / 1e6:.3f} MB flops={self.flops / 1e9:.4f} GFLOP ({how})")


def render_cost(drr, axis: Optional[int] = None, pose=None) -> RenderCost:
    """The cost of one forward render of ``drr`` on its kernels
    (``siddon_fwd``, or ``joseph_fwd`` for joseph and trilinear).

    ``axis`` is the march axis (default: the DRR's ``march_axis``);
    ``n_steps`` the planes marched there (Siddon: every plane; joseph: at
    ``joseph_steps[axis]``; trilinear: ``n_points``, 500 unless the DRR was
    given another, capped at one a plane, as its kernel path marches). With a
    ``pose`` (a ``RigidTransform``) the work is counted on its rays as
    ``chip_smoke.py``'s bounds count it: non-empty slabs and segments, or
    in-slab samples, and each distinct voxel read once. Without one, the
    most any pose could need: every step of every ray, every voxel. A voxel
    is 4 bytes, 2 under the DRR's ``storage="bf16"``.
    """
    from .ops.kernels.prep import prep_rays
    from .ops.kernels.raymarch import raymarch_steps

    if axis is None:
        axis = drr.march_axis
    name = drr.renderer_name
    X = int(drr.density.shape[axis])
    h = 1.0
    if name == "siddon":
        n_steps = X
    elif name == "joseph":
        h = float(drr.joseph_steps[axis])
        n_steps = -(-X // drr.joseph_steps[axis])
    else:
        h, n_steps = raymarch_steps(X, drr.renderer_kwargs.get("n_points", 500),
                                    drr.renderer_kwargs.get("allow_oversample", False))
    R = drr.detector.height * drr.detector.width
    if pose is not None:
        source, target = drr.detector(pose, None)
        R = target.shape[0] * target.shape[1]
        weights = torch.linalg.vector_norm(target - source, dim=-1)[:, None, :]
        sv, tv = drr.affine_inverse(source), drr.affine_inverse(target)
        quadrature = "siddon" if name == "siddon" else "joseph"
        with torch.no_grad():
            rows = prep_rays(sv, tv, weights, axis, drr.density.shape, drr.voxel_shift,
                             quadrature=quadrature, h=h)
    if name == "siddon":
        if pose is not None:
            steps, segments, voxels = siddon_work(rows, drr.density, axis)
        else:  # every slab, its three segments, every voxel
            steps, segments, voxels = R * n_steps, 3 * R * n_steps, drr.density.numel()
        flops = (steps * (SLAB_OPS + SIDDON_FWD["slab_ops"]) + segments * SIDDON_FWD["segment_ops"]
                 + SLAB_RANGE_OPS * R)
    else:
        from .ops.kernels.joseph import is_blend

        if pose is not None:
            samples, voxels, _ = joseph_work(rows, drr.density, axis, h, n_steps)
        else:
            samples, voxels = R * n_steps, drr.density.numel()
        per_sample = J_STEP_OPS + JOSEPH_FWD_SAMPLE_OPS + (J_BLEND_OPS if is_blend(h) else 0)
        flops = samples * per_sample + J_RANGE_OPS * R
    return RenderCost(renderer=name, axis=axis, n_steps=n_steps, rays=R,
                      bytes=float(FWD_RAY_BYTES * R + voxel_bytes(drr.pallas_storage) * voxels),
                      flops=float(flops),
                      exact=pose is not None)


def enable_compilation_cache(directory: Optional[str] = None,
                             min_compile_secs: float = 1.0) -> str:
    """Build the CUDA kernels into ``directory`` and reuse what is there.

    Every process that builds the same sources with the same flags then
    loads one ``nvcc`` build (a mesh's ranks, a CLI run after another):
    ``ops/kernels/build.py`` keys each library on a hash of its sources and
    flags, and writes it atomically, so concurrent builders are safe.
    Without a ``directory`` the build stays in the package's own
    ``_build/``, which is already shared. ``min_compile_secs`` is the
    reference's threshold for keeping an executable; every build is kept
    here. Call it before the first kernel launch; returns the directory.
    """
    del min_compile_secs
    from .ops.kernels import build

    if directory is not None:
        build.BUILD_ROOT = Path(directory).resolve()
        build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    return str(build.BUILD_ROOT)
