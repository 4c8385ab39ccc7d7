"""Volume sampling with ``grid_sample`` semantics, as plain gathers.

Counterpart of ``diffdrr_tpu/ops/sampling.py``. With the reference's
normalisation (``align_corners=False``) the sampled index along each axis is
``idx = p + voxel_shift - 0.5``; with ``align_corners=True`` it is
``(p + voxel_shift) * (dim - 1) / dim``. Samples outside the volume read 0
(``padding_mode="zeros"``): a trilinear corner outside the volume adds
nothing.

  * ``"nearest"`` rounds half to even (``torch.round``, like
    ``std::nearbyint`` in ``grid_sample``); its gradient with respect to the
    points is zero, as in ``grid_sample``'s nearest mode.
  * ``"trilinear"`` (also ``"bilinear"``, ``"linear"``) weights the eight
    corners by ``(1 - f, f)`` per axis, summed in the JAX package's order.
    It is differentiable by autograd with respect to the volume and the
    points.

This module is an oracle (the renderers' CPU path and the kernels' escape),
not a kernel.
"""

from __future__ import annotations

import torch

__all__ = ["sample_volume", "sample_nearest", "sample_trilinear"]


def _gather(volume: torch.Tensor, ix, iy, iz, valid) -> torch.Tensor:
    """volume[ix, iy, iz] with zero fill where ``valid`` is False."""
    d0, d1, d2 = volume.shape
    flat = (ix.clamp(0, d0 - 1) * d1 + iy.clamp(0, d1 - 1)) * d2 + iz.clamp(0, d2 - 1)
    vals = volume.reshape(-1)[flat]
    return torch.where(valid, vals, torch.zeros_like(vals))


def _inside(i, n):
    return (i >= 0) & (i < n)


def sample_nearest(volume: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample at fractional voxel indices ``idx`` (..., 3)."""
    n = torch.round(idx).to(torch.int64)
    ix, iy, iz = n[..., 0], n[..., 1], n[..., 2]
    d0, d1, d2 = volume.shape
    return _gather(volume, ix, iy, iz, _inside(ix, d0) & _inside(iy, d1) & _inside(iz, d2))


def sample_trilinear(volume: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolated sample at fractional voxel indices (..., 3)."""
    d0, d1, d2 = volume.shape
    x, y, z = idx[..., 0], idx[..., 1], idx[..., 2]
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0f, y - y0f, z - z0f
    x0, y0, z0 = x0f.to(torch.int64), y0f.to(torch.int64), z0f.to(torch.int64)
    x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
    vx0, vx1 = _inside(x0, d0), _inside(x1, d0)
    vy0, vy1 = _inside(y0, d1), _inside(y1, d1)
    vz0, vz1 = _inside(z0, d2), _inside(z1, d2)

    c000 = _gather(volume, x0, y0, z0, vx0 & vy0 & vz0)
    c100 = _gather(volume, x1, y0, z0, vx1 & vy0 & vz0)
    c010 = _gather(volume, x0, y1, z0, vx0 & vy1 & vz0)
    c110 = _gather(volume, x1, y1, z0, vx1 & vy1 & vz0)
    c001 = _gather(volume, x0, y0, z1, vx0 & vy0 & vz1)
    c101 = _gather(volume, x1, y0, z1, vx1 & vy0 & vz1)
    c011 = _gather(volume, x0, y1, z1, vx0 & vy1 & vz1)
    c111 = _gather(volume, x1, y1, z1, vx1 & vy1 & vz1)

    wx0, wx1 = 1.0 - fx, fx
    wy0, wy1 = 1.0 - fy, fy
    wz0, wz1 = 1.0 - fz, fz
    return (c000 * wx0 * wy0 * wz0 + c100 * wx1 * wy0 * wz0
            + c010 * wx0 * wy1 * wz0 + c110 * wx1 * wy1 * wz0
            + c001 * wx0 * wy0 * wz1 + c101 * wx1 * wy0 * wz1
            + c011 * wx0 * wy1 * wz1 + c111 * wx1 * wy1 * wz1)


def sample_volume(volume: torch.Tensor, points: torch.Tensor,
                  mode: str = "trilinear", voxel_shift: float = 0.5,
                  align_corners: bool = False) -> torch.Tensor:
    """Sample ``volume`` at voxel-space ``points`` (..., 3)."""
    if align_corners:
        dims = torch.tensor(volume.shape, dtype=points.dtype, device=points.device)
        idx = (points + voxel_shift) * (dims - 1.0) / dims
    else:
        idx = points + (voxel_shift - 0.5)
    if mode in ("trilinear", "bilinear", "linear"):
        return sample_trilinear(volume, idx)
    if mode == "nearest":
        return sample_nearest(volume, idx)
    raise ValueError(f"Unknown sampling mode {mode!r}")
