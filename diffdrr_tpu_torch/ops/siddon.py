"""Siddon's method by sorted plane crossings: the plain-PyTorch oracle.

Counterpart of ``diffdrr_tpu/ops/siddon.py``, the reference's vectorised
formulation: every ray's crossings with every grid plane are sorted, each
segment's midpoint picks its voxel (nearest), and the line integral is the
sum of voxel value x segment length. It integrates the full line, not only
``[source, target]``. It is differentiable by autograd.

``DRR.render`` uses it for ray sets that are not the full detector frame,
and as the slab-validity escape: a pose whose rays cross two transverse
voxel boundaries inside one slab of the march axis, which the slab
kernels of ``ops/kernels/siddon.py`` cannot represent.

Inputs are in voxel space; memory is O(B * N * (X + Y + Z)). With a
labelmap ``mask`` each segment goes to the channel of the mask's label at
its midpoint, a ``(B, n_channels, N)`` sum whatever ``reducefn`` says; the
DRR renders Siddon channels here, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._raygeom import alpha_minmax, channel_render, points_at_alpha, reduce_img
from .sampling import sample_volume

__all__ = ["siddon_raycast"]


def _get_alphas(source, target, dims, voxel_shift, eps,
                filter_intersections_outside_volume):
    """Sorted parametric intersections of each ray with all grid planes."""
    kw = dict(dtype=source.dtype, device=source.device)
    lead = torch.broadcast_shapes(source.shape[:-1], target.shape[:-1])
    alphas = []
    for a in range(3):
        planes = torch.arange(dims[a] + 1, **kw) - voxel_shift
        s, t = source[..., a:a + 1], target[..., a:a + 1]
        alphas.append(((planes - s) / (t - s + eps)).expand(lead + (dims[a] + 1,)))
    alphas = torch.cat(alphas, dim=-1)
    alphas = torch.sort(alphas, dim=-1).values
    if filter_intersections_outside_volume:
        alphamin, alphamax = alpha_minmax(source, target, dims, voxel_shift, eps)
        alphas = torch.minimum(torch.maximum(alphas, alphamin), alphamax)
    return alphas


def siddon_raycast(
    volume: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    voxel_shift: float = 0.5,
    mode: str = "nearest",
    stop_gradients_through_grid_sample: bool = False,
    filter_intersections_outside_volume: bool = False,
    reducefn="sum",
    eps: float = 1e-8,
    align_corners: bool = False,
    mask: Optional[torch.Tensor] = None,
    n_channels: Optional[int] = None,
) -> torch.Tensor:
    """Render line integrals with Siddon's exact method.

    ``volume (X, Y, Z)``, ``source (B, 1, 3)``, ``target (B, N, 3)`` in voxel
    space, ``weights (B, 1, N)`` (the world-space ray length) -> ``(B, 1, N)``,
    or ``(B, n_channels, N)`` with ``mask``.
    """
    dims = tuple(volume.shape)
    B, N, _ = target.shape
    if weights is None:
        weights = volume.new_ones((B, 1, N))
    source = source.expand(B, 1, 3)
    alphas = _get_alphas(source, target, dims, voxel_shift, eps,
                         filter_intersections_outside_volume)
    alphamid = (alphas[..., :-1] + alphas[..., 1:]) / 2
    xyzs = points_at_alpha(alphamid, source, target, eps)
    img = sample_volume(volume, xyzs, mode=mode, voxel_shift=voxel_shift,
                        align_corners=align_corners)
    img = img * weights.transpose(-1, -2)
    if stop_gradients_through_grid_sample:
        img = img.detach()
    img = img * torch.diff(alphas, dim=-1)
    if mask is not None:
        return channel_render(img, mask, xyzs, n_channels, voxel_shift=voxel_shift,
                              align_corners=align_corners)
    return reduce_img(img, reducefn)[:, None, :]
