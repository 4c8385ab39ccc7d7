"""Line integrals through a voxel grid: Siddon's exact method and Joseph's march.

Rays come in voxel coordinates (``geometry.Geometry.rays``): voxel i spans
[i - 0.5, i + 0.5) on each axis, a sample outside the grid reads 0, and the
integral is weighted by the ray's world length (its parameter runs over
[0, 1] from source to pixel). ``eps`` (1e-8) is added to each direction, as
upstream DiffDRR adds it.

* Siddon: every crossing of the ray with every grid plane, sorted; each
  segment reads the voxel at its midpoint (nearest, half to even) and adds
  value x length. A midpoint within rounding of a voxel's face may read
  either neighbour: ``siddon_bounds`` gives the lowest and highest value.
* Joseph (the program's ``trilinear`` renderer): along the march ``axis`` the
  ray is sampled at the planes' positions ``k = p * h``, ``p < n_steps``;
  the sample is trilinear in the other two coordinates (and between the two
  bracketing planes when ``k`` is fractional), kept where the ray is inside
  the grid box ``[-0.5, n + 0.5]`` (its parameter clamped to [0, 1]), and
  weighted by ``|h / d_axis|``. ``n_points`` samples along an axis of ``X``
  planes give ``n_steps = max(2, min(n_points, X))`` and
  ``h = (X - 1) / (n_steps - 1)``.

Each function takes a block of rays, flattened: ``source``, ``target``
``(R, 3)`` and ``weights (R,)``; the callers cut a render into blocks.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def march_steps(X: int, n_points: int):
    """``(h, n_steps)`` of ``n_points`` samples along an axis of ``X`` planes."""
    n_steps = max(2, min(int(n_points), int(X)))
    return (X - 1) / (n_steps - 1), n_steps


# A Siddon segment whose midpoint lies within this many voxels of a voxel's
# face reads either neighbour by float32 rounding.
EDGE_VOXEL = 1e-3


def _flat(idx, shape):
    inside = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    for a, n in enumerate(shape):
        inside &= (idx[..., a] >= 0) & (idx[..., a] < n)
    idx = idx.clamp_min(0)
    flat = (idx[..., 0].clamp_max(shape[0] - 1) * shape[1]
            + idx[..., 1].clamp_max(shape[1] - 1)) * shape[2] + idx[..., 2].clamp_max(shape[2] - 1)
    return flat, inside


def _siddon_segments(source, target, shape, neighbour: bool = False):
    """Flat voxel index, inside flag and length of every segment ``(R, S)``;
    with ``neighbour``, also the flat index and inside flag of the voxel
    across the face nearest the midpoint, where that face lies within
    ``EDGE_VOXEL`` of it (else the segment's own voxel again)."""
    d = target - source + EPS
    alphas = []
    for a, n in enumerate(shape):
        planes = torch.arange(n + 1, dtype=source.dtype, device=source.device) - 0.5
        alphas.append((planes[None, :] - source[:, a:a + 1]) / d[:, a:a + 1])
    alphas = torch.sort(torch.cat(alphas, dim=1), dim=1).values
    mid = 0.5 * (alphas[:, :-1] + alphas[:, 1:])
    pts = source[:, None, :] + mid[..., None] * d[:, None, :]
    idx = torch.round(pts).to(torch.int64)
    flat, inside = _flat(idx, shape)
    if not neighbour:
        return flat, inside, torch.diff(alphas, dim=1)
    off = pts - idx  # in [-0.5, 0.5]
    face = (0.5 - off.abs())  # distance to the nearest face on each axis
    axis = face.argmin(dim=-1, keepdim=True)
    step = torch.where(off.gather(-1, axis) >= 0, 1, -1) * (face.gather(-1, axis) <= EDGE_VOXEL)
    other = idx + torch.zeros_like(idx).scatter(-1, axis, step)
    flat2, inside2 = _flat(other, shape)
    return flat, inside, torch.diff(alphas, dim=1), flat2, inside2


def siddon(volume: torch.Tensor, source, target, weights) -> torch.Tensor:
    """Siddon line integrals ``(R,)`` through ``volume (X, Y, Z)``."""
    flat, inside, lengths = _siddon_segments(source, target, volume.shape)
    vals = volume.reshape(-1)[flat] * inside
    return (vals * lengths).sum(dim=1) * weights


def siddon_bounds(volume: torch.Tensor, source, target, weights):
    """Siddon line integrals ``(R,)`` with each segment whose midpoint lies
    within rounding of a voxel face read from the lower and from the higher
    of its two voxels: every value rounding allows."""
    flat, inside, lengths, flat2, inside2 = _siddon_segments(source, target, volume.shape, True)
    v1 = volume.reshape(-1)[flat] * inside
    v2 = volume.reshape(-1)[flat2] * inside2
    lo = (torch.minimum(v1, v2) * lengths).sum(dim=1) * weights
    hi = (torch.maximum(v1, v2) * lengths).sum(dim=1) * weights
    return lo, hi


def siddon_density_grad(shape, source, target, weights, g, out: torch.Tensor) -> None:
    """Adds to ``out (X * Y * Z,)`` the density gradient of ``sum(g * siddon)``."""
    flat, inside, lengths = _siddon_segments(source, target, shape)
    contrib = lengths * (weights * g)[:, None]
    out.index_add_(0, flat[inside], contrib[inside])


def _alpha_box(source, target, shape):
    """Entry and exit parameters ``(R, 1)`` of the box [-0.5, n + 0.5], in [0, 1]."""
    d = target - source + EPS
    n = torch.tensor(shape, dtype=source.dtype, device=source.device)
    a0 = (-0.5 - source) / d
    a1 = (n + 0.5 - source) / d
    amin = torch.minimum(a0, a1).amax(dim=1, keepdim=True).clamp_min(0.0)
    amax = torch.maximum(a0, a1).amin(dim=1, keepdim=True).clamp_max(1.0)
    return amin, amax


def _trilinear(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of ``volume`` at ``pts (..., 3)``, 0 outside."""
    shape = volume.shape
    base = torch.floor(pts)
    frac = pts - base
    base = base.to(torch.int64)
    flat_vol = volume.reshape(-1)
    out = 0.0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix, iy, iz = base[..., 0] + cx, base[..., 1] + cy, base[..., 2] + cz
                ok = ((ix >= 0) & (ix < shape[0]) & (iy >= 0) & (iy < shape[1])
                      & (iz >= 0) & (iz < shape[2]))
                flat = ((ix.clamp(0, shape[0] - 1) * shape[1] + iy.clamp(0, shape[1] - 1))
                        * shape[2] + iz.clamp(0, shape[2] - 1))
                w = ((frac[..., 0] if cx else 1 - frac[..., 0])
                     * (frac[..., 1] if cy else 1 - frac[..., 1])
                     * (frac[..., 2] if cz else 1 - frac[..., 2]))
                out = out + torch.where(ok, flat_vol[flat], 0.0) * w
    return out


# A Joseph sample whose parameter lies within this much of the ray's entry
# or exit (the box's faces, or the pixel where the ray ends inside a CT that
# reaches past the detector) is counted on either side by float32 rounding.
EDGE = 1e-6


def joseph_bounds(volume: torch.Tensor, source, target, weights, *, axis: int, h: float,
                  n_steps: int):
    """Joseph line integrals ``(R,)`` without and with the samples that lie
    within ``EDGE`` of the ray's ends: every value the integral takes when
    those samples fall either way (the density is non-negative).
    Differentiable in the rays by autograd."""
    d = target - source + EPS
    ks = torch.arange(n_steps, dtype=source.dtype, device=source.device) * h
    alpha = (ks[None, :] - source[:, axis:axis + 1]) / d[:, axis:axis + 1]
    amin, amax = _alpha_box(source, target, volume.shape)
    edge = ((alpha - amin).abs() <= EDGE) | ((alpha - amax).abs() <= EDGE)
    sure = (alpha >= amin) & (alpha <= amax) & ~edge
    pts = source[:, None, :] + alpha[..., None] * d[:, None, :]
    on_axis = torch.arange(3, device=pts.device) == axis
    pts = torch.where(on_axis, ks[None, :, None].expand_as(pts), pts)
    vals = _trilinear(volume, pts)
    scale = torch.abs(h / d[:, axis]) * weights
    lo = (vals * sure).sum(dim=1) * scale
    return lo, lo + (vals * edge).sum(dim=1) * scale


def joseph(volume: torch.Tensor, source, target, weights, *, axis: int, h: float,
           n_steps: int) -> torch.Tensor:
    """Joseph line integrals ``(R,)``: the middle of ``joseph_bounds``."""
    lo, hi = joseph_bounds(volume, source, target, weights, axis=axis, h=h, n_steps=n_steps)
    return 0.5 * (lo + hi)
