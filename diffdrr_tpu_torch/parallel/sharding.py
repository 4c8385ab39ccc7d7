"""Differentiable CT reconstruction: the density-optimization step.

Counterpart of ``make_reconstruction_step`` in
``diffdrr_tpu/parallel/sharding.py`` on one device. The density is a leaf
tensor optimized by Adam against measured views: each step renders the
views from the current density (``DRR.render``, the explicit-density seam),
takes ``mean((img - measured)**2)``, back-propagates to the density and
updates it in place. The render is the value-only forward of the DRR's
renderer and the backward its density-gradient kernel: ``siddon_fwd`` and
``siddon_bwd_vol`` for ``renderer="siddon"``, ``joseph_fwd`` and
``joseph_bwd_vol`` for ``"joseph"`` and ``"trilinear"``.

``torch.optim.Adam(lr)`` applies the same update as ``optax.adam(lr)``
(``lr * m_hat / (sqrt(v_hat) + eps)``, betas 0.9 and 0.999, eps 1e-8).

Not ported yet (ROADMAP.md): a device mesh (the data and ray axes over
several cards, which needs ``torch.distributed``), ``shard_drr``,
``make_sharded_render`` and the slab-sharded renderers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..drr import DRR
from ..pose import convert

__all__ = ["make_reconstruction_step"]


def make_reconstruction_step(
    drr: DRR,
    mesh=None,
    parameterization: str = "euler_angles",
    convention: Optional[str] = "ZXY",
    lr: float = 1e-2,
    data_axis: str = "data",
    ray_axis: str = "rays",
    **render_kwargs,
):
    """Build ``(init_fn, step_fn)`` for density reconstruction on ``drr.device``.

    ``init_fn(density0) -> (density, opt)`` makes a fresh leaf and its Adam;
    ``step_fn(density, opt, rotation, translation, measured) -> (density,
    opt, loss)`` renders the views at the poses, scores them against
    ``measured (B, 1, H, W)`` and takes one Adam step in place. ``loss`` is
    the loss before the step, a 0-d tensor. ``fused_pose_bwd`` defaults to
    False: only the density needs a gradient, so the forward is the
    value-only kernel. ``data_axis`` and ``ray_axis`` name mesh axes and are
    unused on one device.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh for reconstruction is not ported yet: it waits for the "
            "torch.distributed port of parallel/ (ROADMAP.md, queue 1: parallel/)")
    render_kwargs.setdefault("fused_pose_bwd", False)
    device = drr.device

    def init_fn(density0):
        density = (torch.as_tensor(density0, dtype=torch.float32, device=device)
                   .detach().clone().requires_grad_(True))
        return density, torch.optim.Adam([density], lr=lr)

    def loss_of(density, rotation, translation, measured):
        pose = convert(torch.as_tensor(rotation, dtype=torch.float32, device=device),
                       torch.as_tensor(translation, dtype=torch.float32, device=device),
                       parameterization=parameterization, convention=convention)
        source, target = drr.detector(pose)
        img = drr.render(density, source, target, **render_kwargs)
        img = drr.reshape_transform(img, batch_size=len(pose))
        return torch.mean((img - measured) ** 2)

    def step_fn(density, opt, rotation, translation, measured):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(density, rotation, translation, measured)
        loss.backward()
        opt.step()
        return density, opt, loss.detach()

    return init_fn, step_fn
