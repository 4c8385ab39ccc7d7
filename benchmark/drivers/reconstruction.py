"""Density reconstruction: ``parallel.sharding.make_reconstruction_step``.

Set-up renders the measured views (``views`` poses ``[theta_i, pi/2, 0]``
about the config's pose, theta evenly spaced over ``view_span`` from a
seeded offset), builds the step and takes its first ``reference_steps``
Adam steps from zero density, reading each step's loss, the first
gradient's norm from Adam's first moment after one step and the norm of
the density's change after the last: the same object then runs on in the
window. The timed step is one ``step_fn`` call; after ``n_iters`` steps a
run ends and the next starts from zero density.

The reference follows those steps in float64: its own measured views,
Siddon renders, the mean squared error, the density gradient (a scatter of
segment lengths) and Adam. Compared (the density is one leaf):
``loss_gap``, the widest relative gap of a step's loss; ``grad_gap`` and
``step_gap``, the gaps of the first gradient's norm and of the change's
norm over the reference's. The views are rotations about the principal ray
of a square detector: a quarter turn maps its pixel grid onto itself, so
views spread over more than a quarter turn repeat one another's rays, and
a batch cut in half would change no number. ``view_span`` is a quarter turn
at most.
"""

from __future__ import annotations

import torch

from ..reference import render
from ..reference.adam import Adam
from .common import (POSE_KW, DriverBase, Inputs, Reference, block_rays, costs, program_drr,
                     relative_gap)


class Driver(DriverBase):
    def __init__(self, config: dict, traffic: dict, seed: int, device, storage=None):
        from diffdrr_tpu_torch.parallel.sharding import make_reconstruction_step

        if config["renderer"] != "siddon":
            raise ValueError("the reconstruction reference renders by Siddon")
        self.traffic = traffic
        self.inputs = Inputs(config, seed, device)
        self.rot, self.trans = self.inputs.views((), traffic["views"], traffic["view_span"])
        self.drr = program_drr(self.inputs, storage)
        with torch.no_grad():
            self.measured = self.drr(self.rot, self.trans, **POSE_KW)
        self.init_fn, self.step_fn = make_reconstruction_step(self.drr, lr=traffic["lr"],
                                                              **POSE_KW)
        self.density, self.opt = self.init_fn(torch.zeros_like(self.drr.density))
        self.in_run = 0
        self.readings = {}

    def _step(self):
        self.density, self.opt, loss = self.step_fn(self.density, self.opt, self.rot,
                                                    self.trans, self.measured)
        self.in_run += 1
        return loss

    def setup(self) -> None:
        losses, grad_norm = [], None
        for n in range(self.traffic["reference_steps"]):
            losses.append(float(self._step()))
            if n == 0:
                b1 = self.opt.param_groups[0]["betas"][0]
                m = self.opt.state.get(self.density, {}).get("exp_avg")
                m = torch.zeros_like(self.density) if m is None else m.detach()
                grad_norm = float(torch.linalg.vector_norm(m.double()) / (1 - b1))
        change = float(torch.linalg.vector_norm(self.density.detach().double()))
        self.readings = dict(losses=losses, grad_norm=grad_norm, change_norm=change)

    def step(self) -> int:
        if self.in_run == self.traffic["n_iters"]:
            self.density, self.opt = self.init_fn(torch.zeros_like(self.drr.density))
            self.in_run = 0
        self._step()
        return 1

    def release(self) -> None:
        self.drr = self.init_fn = self.step_fn = self.density = self.opt = None
        self.measured = None

    def mark_trace(self) -> None:
        pass

    def costs(self) -> dict:
        return costs(self.inputs, self.rot, self.trans,
                     {"siddon_fwd": "fwd", "siddon_bwd_vol": "bwd_vol"})

    def compare(self, device) -> dict:
        ref = Reference(self.inputs, device, block_rays(self.inputs))
        got = self.readings
        rot, trans = ref.as_ref(self.rot), ref.as_ref(self.trans)
        measured = ref.render(rot, trans).reshape(rot.shape[0], -1)
        density = torch.zeros_like(ref.density)
        adam = Adam(self.traffic["lr"])
        loss_gap, grad_norm = 0.0, None
        for n in range(self.traffic["reference_steps"]):
            img = ref.render(rot, trans, density).reshape(rot.shape[0], -1)
            resid = img - measured
            loss = float((resid ** 2).mean())
            loss_gap = max(loss_gap, relative_gap(got["losses"][n], loss, 0.0))
            g_img = 2.0 * resid / resid.numel()
            grad = torch.zeros(density.numel(), dtype=density.dtype, device=density.device)
            for b, pix in ref.blocks(rot.shape[0]):
                idx = torch.arange(pix.start, pix.stop, device=ref.device)
                src, tgt, w = ref.geometry.rays(rot[b:b + 1], trans[b:b + 1], idx)
                render.siddon_density_grad(ref.shape, src.expand_as(tgt).reshape(-1, 3),
                                           tgt.reshape(-1, 3), w.reshape(-1), g_img[b, pix],
                                           grad)
            grad = grad.reshape(density.shape)
            if n == 0:
                grad_norm = float(torch.linalg.vector_norm(grad))
            density = adam.step(density, grad)
        change = float(torch.linalg.vector_norm(density))
        return {"loss_gap": loss_gap,
                "grad_gap": relative_gap(got["grad_norm"], grad_norm, 0.0),
                "step_gap": relative_gap(got["change_norm"], change, 0.0)}



