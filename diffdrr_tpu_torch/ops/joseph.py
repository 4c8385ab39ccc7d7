"""Joseph's method by plane march: the plain-PyTorch oracle.

Counterpart of ``diffdrr_tpu/ops/joseph.py``. Each ray is sampled once per
marched plane of ``axis``: at axis position ``k = p * step`` for ``p`` in
``[0, n_steps)``, the point where the ray reaches that position is sampled
trilinearly (bilinearly in the plane when ``k`` is an integer, lerped
between the two bracketing planes when it is not), kept inside the ray's
entry/exit interval (``alpha_minmax``, clamped to [0, 1]), and weighted by
``|step / d_axis|`` (the quadrature) times the ray weight. The samples are
reduced by sum, max or a callable. It is differentiable by autograd.

``DRR.render`` uses it for ray sets that are not the full detector frame,
for a callable ``reducefn`` and under ``force_xla=True``; the full frame
otherwise runs the CUDA kernels of ``ops/kernels/joseph.py``, which compute
the same function with a hand-written gradient.

Not ported yet (ROADMAP.md): per-structure channels (``mask``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ._raygeom import alpha_minmax, reduce_img
from .sampling import sample_volume

__all__ = ["joseph_raycast", "choose_march_axis"]


def choose_march_axis(source: torch.Tensor, target: torch.Tensor) -> int:
    """The volume axis most aligned with the mean ray direction.

    Reads the answer back to the host: call it outside any traced code.
    """
    d = (torch.as_tensor(target).reshape(-1, 3).mean(0)
         - torch.as_tensor(source).reshape(-1, 3).mean(0))
    return int(torch.argmax(torch.abs(d)))


def joseph_raycast(
    volume: torch.Tensor,
    source: torch.Tensor,
    target: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    axis: int = 0,
    step: float = 1,
    n_steps: Optional[int] = None,
    voxel_shift: float = 0.5,
    reducefn: Union[str, Callable] = "sum",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Line integrals ``(B, 1, N)`` by marching the planes of ``axis``.

    ``volume (X, Y, Z)``, ``source (B, 1, 3)``, ``target (B, N, 3)`` in voxel
    space, ``weights (B, 1, N)``. ``step`` may be fractional: samples then
    sit between planes.
    """
    dims = tuple(volume.shape)
    X = dims[axis]
    B, N, _ = target.shape
    if weights is None:
        weights = volume.new_ones((B, 1, N))

    off = voxel_shift - 0.5
    gs = source + off
    gt = target + off
    d = gt - gs + eps

    if n_steps is None:
        n_steps = int(-(-X // step))
    ks = torch.arange(n_steps, dtype=volume.dtype, device=volume.device) * step  # (K,)
    d_ax = d[..., axis]  # (B, N)
    alpha_k = (ks[None, None, :] - gs[..., axis:axis + 1]) / d_ax[..., None]  # (B, N, K)

    amin, amax = alpha_minmax(source, target, dims, voxel_shift, eps)
    in_slab = (alpha_k >= amin) & (alpha_k <= amax)

    # The exact plane coordinate along ``axis``, the ray's in the other two.
    pts = gs[..., None, :] + alpha_k[..., None] * d[..., None, :]  # (B, N, K, 3)
    on_axis = torch.arange(3, device=pts.device) == axis
    pts = torch.where(on_axis, ks[:, None].expand(n_steps, 3), pts)

    vals = sample_volume(volume, pts - off, mode="trilinear", voxel_shift=voxel_shift)
    dalpha = torch.abs(step / d_ax)[..., None]  # (B, N, 1)
    img = vals * in_slab * dalpha * weights.transpose(-1, -2)
    return reduce_img(img, reducefn)[:, None, :]
