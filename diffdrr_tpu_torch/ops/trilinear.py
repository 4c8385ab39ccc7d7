"""Trilinear ray marching at global equispaced alphas: the plain-PyTorch oracle.

Counterpart of ``diffdrr_tpu/ops/trilinear.py`` (the reference's
``Trilinear`` renderer): ``n_points`` samples equispaced in the ray
parameter between the ray bundle's earliest entry and latest exit (or the
given ``alphamin``/``alphamax``), each trilinearly interpolated, summed by
the rectangle rule. It is differentiable by autograd.

This is not what the CUDA path computes: the kernels
(``ops/kernels/raymarch.py``) sample at plane-aligned positions with
per-ray quadrature weights, as the TPU kernel does. ``DRR.render`` uses
this oracle for ray sets that are not the full detector frame, under
``force_xla=True``, and for what the kernels do not take: ``reducefn="max"``
or a callable, ``mode="nearest"``, ``align_corners=True`` and
``alphamin``/``alphamax``.

With a labelmap ``mask`` each sample goes to the channel of the mask's
label at the same point (nearest), a ``(B, n_channels, N)`` sum whatever
``reducefn`` says.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ._raygeom import alpha_minmax, channel_render, points_at_alpha, reduce_img
from .sampling import sample_volume

__all__ = ["trilinear_raycast"]


def trilinear_raycast(
    volume: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    n_points: int = 500,
    voxel_shift: float = 0.5,
    mode: str = "trilinear",
    reducefn: Union[str, Callable] = "sum",
    eps: float = 1e-8,
    align_corners: bool = False,
    mask: Optional[torch.Tensor] = None,
    n_channels: Optional[int] = None,
    alphamin: Optional[torch.Tensor] = None,
    alphamax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Approximate line integrals ``(B, 1, N)`` by ``n_points`` samples a ray
    (``(B, n_channels, N)`` with ``mask``)."""
    dims = tuple(volume.shape)
    B, N, _ = target.shape
    if weights is None:
        weights = volume.new_ones((B, 1, N))
    if alphamin is None or alphamax is None:
        amin, amax = alpha_minmax(source, target, dims, voxel_shift, eps)
        alphamin, alphamax = torch.amin(amin), torch.amax(amax)

    alphas = torch.linspace(0.0, 1.0, n_points, dtype=volume.dtype,
                            device=volume.device)[None, None]
    alphas = alphas * (alphamax - alphamin) + alphamin
    xyzs = points_at_alpha(alphas, source, target, eps)
    img = sample_volume(volume, xyzs, mode=mode, voxel_shift=voxel_shift,
                        align_corners=align_corners)
    img = img * weights.transpose(-1, -2)
    img = img * ((alphamax - alphamin) / max(n_points - 1, 1))
    if mask is not None:
        return channel_render(img, mask, xyzs, n_channels, voxel_shift=voxel_shift,
                              align_corners=align_corners)
    return reduce_img(img, reducefn)[:, None, :]
