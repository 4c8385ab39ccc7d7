"""What one kernel launch must read, write and compute, from the rays it renders.

Frozen from ``diffdrr_tpu_torch/profiling.py`` (``render_cost``,
``siddon_work``, ``joseph_work`` and their operation counts, which were
counted by hand from the kernels' headers), and extended by the same
counts to the fused pose kernels and the density scatters. The work is
what the data needs, worked out here from the rays in voxel coordinates
(``reference.geometry``), not what a kernel happens to do:

* Siddon: non-empty (ray, slab) steps along the march axis, non-empty
  segments (a slab holds up to three, split where the ray crosses a
  transverse voxel boundary), and each distinct voxel read once;
* Joseph: in-box samples (``k = p * h``; a fractional ``h`` lerps a plane
  pair) and each distinct voxel read once.

Bytes: each input byte once and each output byte once. A ray brings its 9
float32 rows (36 B); a forward writes 4 B a ray, a fused pose kernel its
value and 7 row derivatives (32 B), a scatter reads 4 B of cotangent a ray
and writes the whole density gradient. The density is counted at float32
(4 B a voxel). ``benchmark/tests`` holds these counts to the program's
``render_cost`` on the CPU at a tiny size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EPS = 1e-8
ROW_BYTES = 36
VOXEL_BYTES = 4
# Siddon (csrc/siddon.cuh), per non-empty (ray, slab) step and segment.
SLAB_OPS = 59
SLAB_RANGE_OPS = 10
SIDDON = {"fwd": (2, 4), "fwdgrad": (54, 0), "bwd_vol": (0, 5)}  # (per step, per segment)
# Joseph (csrc/joseph.cuh), per in-box sample.
J_STEP_OPS = 21
J_BLEND_OPS = 18
J_RANGE_OPS = 9
JOSEPH = {"fwd": 19, "fwdgrad": 58, "bwd_vol": 22}
# Bytes a ray writes: forward 4, fused pose kernel 8 rows of 4.
OUT_BYTES = {"fwd": 4, "fwdgrad": 32, "bwd_vol": 0}


@dataclass
class Work:
    """What one render of a batch of rays needs."""

    renderer: str  # "siddon" or "joseph"
    rays: int
    steps: int  # Siddon: non-empty ray-slab steps; Joseph: in-box samples
    segments: int  # Siddon only
    voxels: int  # distinct voxels read
    numel: int  # the density's voxels
    blend: bool = False


def is_blend(h: float) -> bool:
    return abs(h - round(h)) > 1e-9


def _permuted(source, target, axis):
    perm = [axis] + [a for a in range(3) if a != axis]
    B, N, _ = target.shape
    g = source.expand(B, N, 3).reshape(-1, 3)[:, perm]
    d = (target.reshape(-1, 3) - source.expand(B, N, 3).reshape(-1, 3) + EPS)[:, perm]
    return g, d, perm


def _box(g, d, dims, clamp):
    n = torch.tensor([float(x) for x in dims], dtype=g.dtype, device=g.device)
    a0, a1 = (-0.5 - g) / d, (n + 0.5 - g) / d
    amin = torch.minimum(a0, a1).amax(dim=1)
    amax = torch.maximum(a0, a1).amin(dim=1)
    if clamp:
        amin, amax = amin.clamp_min(0.0), amax.clamp_max(1.0)
    return amin, amax


def _mark(seen, k, fy, fz, ok):
    X, Y, Z = seen.shape
    ok = ok & (fy >= 0) & (fy < Y) & (fz >= 0) & (fz < Z)
    if 0 <= k < X:
        seen[k].view(-1)[(fy[ok] * Z + fz[ok]).long()] = True


def siddon_work(source, target, shape, axis) -> Work:
    """The Siddon slab march's work for rays ``source (B|1, 1, 3)``,
    ``target (B, N, 3)`` in voxel coordinates."""
    g, d, perm = _permuted(source, target, axis)
    dims = [shape[p] for p in perm]
    amin, amax = _box(g, d, dims, clamp=False)
    a, b = 1.0 / d[:, 0], -g[:, 0] / d[:, 0]
    seen = torch.zeros(dims, dtype=torch.bool, device=g.device)
    steps = segments = 0

    def crossing(gc, dc, alo, ahi):
        m_lo, m_hi = torch.round(gc + alo * dc), torch.round(gc + ahi * dc)
        t = (torch.maximum(m_lo, m_hi) - 0.5 - gc) / dc
        return torch.where(m_lo != m_hi, torch.minimum(torch.maximum(t, alo), ahi), alo)

    for s in range(dims[0]):
        a1, a2 = (s - 0.5) * a + b, (s + 0.5) * a + b
        alo = torch.maximum(torch.minimum(a1, a2), amin)
        ahi_raw = torch.minimum(torch.maximum(a1, a2), amax)
        ahi = torch.maximum(ahi_raw, alo)
        steps += int(torch.count_nonzero(ahi_raw >= alo))
        ty, tz = crossing(g[:, 1], d[:, 1], alo, ahi), crossing(g[:, 2], d[:, 2], alo, ahi)
        t1, t2 = torch.minimum(ty, tz), torch.maximum(ty, tz)
        for lo, hi in ((alo, t1), (t1, t2), (t2, ahi)):
            ok = hi - lo > 0
            segments += int(torch.count_nonzero(ok))
            mid = 0.5 * (lo + hi)
            _mark(seen, s, torch.round(g[:, 1] + mid * d[:, 1]),
                  torch.round(g[:, 2] + mid * d[:, 2]), ok)
    return Work("siddon", g.shape[0], steps, segments, int(torch.count_nonzero(seen)),
                int(np.prod(shape)))


def joseph_work(source, target, shape, axis, h, n_steps) -> Work:
    """The Joseph march's work at stride ``h`` (planes), ``n_steps`` steps."""
    g, d, perm = _permuted(source, target, axis)
    dims = [shape[p] for p in perm]
    amin, amax = _box(g, d, dims, clamp=True)
    a, b = 1.0 / d[:, 0], -g[:, 0] / d[:, 0]
    seen = torch.zeros(dims, dtype=torch.bool, device=g.device)
    blend = is_blend(h)
    samples = 0
    for p in range(n_steps):
        k = float(np.float32(np.float32(p) * np.float32(h)))
        alpha = k * a + b
        inslab = (alpha >= amin) & (alpha <= amax)
        samples += int(torch.count_nonzero(inslab))
        fy = torch.floor(g[:, 1] + alpha * d[:, 1])
        fz = torch.floor(g[:, 2] + alpha * d[:, 2])
        if blend:
            k0 = int(min(max(np.floor(k), 0.0), dims[0] - 1))
            planes = (k0, k0 + 1)
        else:
            planes = (p * int(round(h)),)
        for kk in planes:
            for m in (0, 1):
                for n in (0, 1):
                    _mark(seen, kk, fy + m, fz + n, inslab)
    return Work("joseph", g.shape[0], samples, 0, int(torch.count_nonzero(seen)),
                int(np.prod(shape)), blend)


def kernel_cost(work: Work, kind: str):
    """``(bytes, flops)`` of one launch of the ``kind`` kernel ("fwd",
    "fwdgrad" or "bwd_vol") over ``work``."""
    R = work.rays
    if kind == "bwd_vol":
        bytes_ = (ROW_BYTES + 4) * R + VOXEL_BYTES * work.numel
    else:
        bytes_ = (ROW_BYTES + OUT_BYTES[kind]) * R + VOXEL_BYTES * work.voxels
    if work.renderer == "siddon":
        per_step, per_segment = SIDDON[kind]
        flops = (work.steps * (SLAB_OPS + per_step) + work.segments * per_segment
                 + SLAB_RANGE_OPS * R)
    else:
        per_sample = J_STEP_OPS + JOSEPH[kind] + (J_BLEND_OPS if work.blend else 0)
        flops = work.steps * per_sample + J_RANGE_OPS * R
    return float(bytes_), float(flops)
