"""Per-ray algebra for the march kernels: the 9 packed rows, by autograd.

Counterpart of ``_prep_rays`` in ``diffdrr_tpu/ops/pallas/joseph.py``. For
march axis ``axis`` (``perm3 = (axis, *other)`` names the permuted voxel
axes s, y, z) each ray ``r`` gets

    a  = 1 / d_s           b  = -g_s / d_s        (plane alpha = s a + b)
    gy = g_y   dy = d_y    gz = g_z   dz = d_z    (transverse position)
    sc                                             (the quadrature scale)
    amin, amax                                     (volume entry/exit)

with ``g = source + voxel_shift - 0.5`` and ``d = target - source + eps``.
The entry is the max over axes of the per-axis entries, the exit the MIN
over axes of the per-axis exits (the ray leaves at its first exit). The two
quadratures differ in ``sc`` and the interval:

  * ``"siddon"`` (exact segments): ``sc = w``, the ray weight, and the
    interval is the full line's crossing of the padded box (the reference's
    sort-based Siddon never clips to [source, target]);
  * ``"joseph"`` (one sample per step of ``h`` planes, the Joseph and
    trilinear kernels): ``sc = w * |1 / d_s| * h``, the step in alpha, and
    the interval is clamped to [0, 1], as the oracles' ``alpha_minmax`` is.

The rows keep their autograd graph: the kernels emit d(value)/d(row), and
the pullback through this function turns them into source, target and
weight gradients (the Joseph kernels give amin/amax zero cotangents: they
enter only through the in-slab comparison).

The TPU's detector-tile permutation and padding columns do not exist here:
rows are (9, B*N) in row-major ray order.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["prep_rays", "march_perm", "NROWS", "ROW_NAMES"]

ROW_NAMES = ("a", "b", "gy", "dy", "gz", "dz", "sc", "amin", "amax")
NROWS = len(ROW_NAMES)


def march_perm(axis: int) -> tuple:
    """(axis, *other): the permuted (s, y, z) order of the volume's axes."""
    return (axis,) + tuple(d for d in range(3) if d != axis)


def prep_rays(source: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
              axis: int, dims: Sequence[int], voxel_shift: float = 0.5,
              eps: float = 1e-8, quadrature: str = "siddon",
              h: float = 1.0) -> torch.Tensor:
    """(9, B*N) float32 rows for ``source (B|1, 1, 3)``, ``target (B, N, 3)``
    and ``weights (B, 1, N)``, all in voxel space; ``h`` is the Joseph
    quadrature's step in planes."""
    if quadrature not in ("siddon", "joseph"):
        raise ValueError(f"quadrature must be 'siddon' or 'joseph', not {quadrature!r}")
    B, N, _ = target.shape
    perm3 = list(march_perm(axis))
    off = voxel_shift - 0.5
    gs = source.expand(B, N, 3) + off
    d = target + off - gs + eps
    gs = gs[..., perm3].reshape(B * N, 3)
    d = d[..., perm3].reshape(B * N, 3)
    w = weights.reshape(B * N)

    inv_dx = 1.0 / d[:, 0]
    dims_arr = torch.tensor([float(dims[p]) for p in perm3],
                            dtype=gs.dtype, device=gs.device)
    s_un = gs - off
    a0 = (-voxel_shift - s_un) / d
    a1 = (dims_arr + 1.0 - voxel_shift - s_un) / d
    amin = torch.amax(torch.minimum(a0, a1), dim=-1)
    amax = torch.amin(torch.maximum(a0, a1), dim=-1)
    sc = w
    if quadrature == "joseph":
        sc = w * (torch.abs(inv_dx) * h)
        amin = torch.clamp(amin, min=0.0)
        amax = torch.clamp(amax, max=1.0)
    rows = torch.stack([
        inv_dx, -gs[:, 0] * inv_dx, gs[:, 1], d[:, 1], gs[:, 2], d[:, 2],
        sc, amin, amax,
    ])
    return rows.to(torch.float32)
