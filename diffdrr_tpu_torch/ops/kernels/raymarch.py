"""The trilinear ray march on the Joseph kernels: ``n_points`` to a stride.

Counterpart of ``diffdrr_tpu/ops/pallas/raymarch.py``, which has no kernel of
its own. Where the reference (and the oracle ``ops/trilinear.py``) spaces
``n_points`` samples evenly in the ray parameter between the bundle's entry
and exit, this march spaces them evenly along the march axis, at
``k = p * h`` with ``h = (X - 1) / (n_steps - 1)`` planes, and weights each
by the ray's own step in alpha (``|1/d_axis| * h``). Every ray then samples
the same plane (integer ``h``) or plane pair (fractional ``h``) at each
step, which is what the Joseph kernels march: ``csrc/joseph.cu`` takes both.

``n_steps`` is capped at one sample per plane (``X``) unless
``allow_oversample``, and is at least 2: ``n_points=500`` on an axis of 133
planes gives ``h = 1`` exactly, the integer march; a fractional ``h`` comes
only with ``n_points < X`` or ``allow_oversample``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .joseph import joseph_march_raycast

__all__ = ["raymarch_steps", "raymarch_raycast"]


def raymarch_steps(X: int, n_points: int, allow_oversample: bool = False) -> Tuple[float, int]:
    """``(h, n_steps)`` for ``n_points`` samples along an axis of ``X`` planes."""
    n_steps = int(n_points) if allow_oversample else min(int(n_points), X)
    n_steps = max(n_steps, 2)
    return (X - 1) / (n_steps - 1), n_steps


def raymarch_raycast(density: torch.Tensor, source: torch.Tensor, target: torch.Tensor,
                     weights: torch.Tensor, *, axis: int, n_points: int = 500,
                     allow_oversample: bool = False, voxel_shift: float = 0.5,
                     eps: float = 1e-8, reduce: str = "sum",
                     fused: bool = True) -> torch.Tensor:
    """Trilinear ``(B, 1, N)`` by the plane-aligned march along ``axis``."""
    h, n_steps = raymarch_steps(density.shape[axis], n_points, allow_oversample)
    return joseph_march_raycast(density, source, target, weights, axis=axis, step=h,
                                n_steps=n_steps, voxel_shift=voxel_shift, eps=eps,
                                reduce=reduce, fused=fused)
