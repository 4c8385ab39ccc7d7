"""Shared ray-geometry helpers for the renderers.

Counterpart of ``diffdrr_tpu/ops/_raygeom.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .sampling import sample_volume

__all__ = ["alpha_minmax", "points_at_alpha", "reduce_img", "scatter_channels",
           "channel_render"]


def alpha_minmax(source: torch.Tensor, target: torch.Tensor,
                 dims: Tuple[int, int, int], voxel_shift: float,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry/exit parametric coordinates of each ray with the volume slab.

    Keeps the reference's ``dims + 1`` upper plane and the clamp of the
    result into [0, 1].
    """
    dims_arr = torch.tensor(dims, dtype=source.dtype, device=source.device)
    sdd = target - source + eps
    alpha0 = (-voxel_shift - source) / sdd
    alpha1 = ((dims_arr + 1.0) - voxel_shift - source) / sdd
    alphamin = torch.amax(torch.minimum(alpha0, alpha1), dim=-1, keepdim=True)
    alphamax = torch.amin(torch.maximum(alpha0, alpha1), dim=-1, keepdim=True)
    alphamin = torch.where(alphamin < 0.0, torch.zeros_like(alphamin), alphamin)
    alphamax = torch.where(alphamax > 1.0, torch.ones_like(alphamax), alphamax)
    return alphamin, alphamax


def points_at_alpha(alpha: torch.Tensor, source: torch.Tensor,
                    target: torch.Tensor, eps: float) -> torch.Tensor:
    """Voxel-space points ``source + alpha * (target - source + eps)``.

    ``alpha (B, N, S)``, ``source (B, 1, 3)``, ``target (B, N, 3)`` ->
    ``(B, N, S, 3)``.
    """
    return source[..., None, :] + alpha[..., None] * (target - source + eps)[..., None, :]


def reduce_img(img: torch.Tensor, reducefn) -> torch.Tensor:
    """Combine per-sample contributions along each ray."""
    if reducefn == "sum":
        return torch.sum(img, dim=-1)
    if reducefn == "max":
        return torch.amax(img, dim=-1)
    if callable(reducefn):
        return reducefn(img)
    raise ValueError(f"Only supports reducefn 'sum' or 'max', not {reducefn}")


def scatter_channels(img: torch.Tensor, channels: torch.Tensor, n_channels: int) -> torch.Tensor:
    """Per-sample contributions summed into per-structure channels.

    ``img (B, N, S)``, integer ``channels (B, N, S)`` -> ``(B, C, N)``. A
    sample whose channel lies outside ``[0, n_channels)`` is dropped.
    Differentiable with respect to ``img``.
    """
    B, N, _ = img.shape
    ok = (channels >= 0) & (channels < n_channels)
    idx = torch.clamp(channels, 0, n_channels - 1).to(torch.int64)
    src = torch.where(ok, img, torch.zeros_like(img))
    out = img.new_zeros((B, N, n_channels)).scatter_add(-1, idx, src)
    return out.transpose(1, 2)


def channel_render(img: torch.Tensor, mask: torch.Tensor, points: torch.Tensor,
                   n_channels, **sample_kw) -> torch.Tensor:
    """``img (B, N, S)`` summed by the label of ``mask`` at each sample's
    ``points (B, N, S, 3)``, sampled nearest whatever the value's mode."""
    if n_channels is None:
        raise ValueError("n_channels must be provided when rendering with a mask")
    labels = sample_volume(mask, points, mode="nearest", **sample_kw).to(torch.int64)
    return scatter_channels(img, labels, int(n_channels))
