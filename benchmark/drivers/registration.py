"""Batched multistart registration: ``registration.make_multistart_step``.

Set-up renders the target X-ray at the config's pose, draws a pool of runs'
starts (the pose plus seeded offsets, as the registration CLI draws them),
builds the step and takes its first ``reference_steps`` steps from the first
run's starts, reading each step's scores, the Adam state after the first and
the poses after the last: the same object then runs on in the window. The
timed step is one ``step_fn`` call and the read of its scores back to the
host, as a loop that tests convergence reads them; after ``n_iters`` steps a
run ends and the next starts from fresh starts.

The reference follows those first steps in float64 from the same starts:
its own target, renders, multiscale NCC, pose gradients (autograd through
blocks of rays) and Adam. Compared (each start's rotation and translation
are two leaves):

* ``score_gap``: the widest gap of a start's score over the steps;
* ``image_gap``: the images the first step renders, as the render cells
  compare theirs;
* ``grad_gap``: the first gradient as Adam holds it after one step, by
  the worst leaf: a leaf's gap is that of the two norms over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``grad_dir_gap``: the same first gradient, by the worst leaf, as the norm
  of the two vectors' difference over the same scale: it sees a gradient
  whose size is right and whose direction is not (reversed, or wrong for
  a few starts), which no gap of norms and no first Adam step can show;
* ``step_gap``: the poses' change over the steps, by the worst leaf, as
  ``grad_gap``, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's.
"""

from __future__ import annotations

import statistics

import torch

from ..reference import ncc
from ..reference.adam import Adam
from .common import (POSE_KW, DriverBase, Inputs, Reference, block_rays, costs, program_drr,
                     relative_gap, widest_image_gap)


class Driver(DriverBase):
    def __init__(self, config: dict, traffic: dict, seed: int, device, storage=None):
        from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d
        from diffdrr_tpu_torch.registration import make_multistart_step

        self.traffic = traffic
        self.inputs = Inputs(config, seed, device)
        self.rots, self.transs = self.inputs.poses((traffic["pool"], traffic["starts"]), traffic)
        self.drr = program_drr(self.inputs, storage)
        with torch.no_grad():
            target = self.drr(self.inputs.rotation[None], self.inputs.translation[None],
                              **POSE_KW)
        m = traffic["metric"]
        metric = MultiscaleNormalizedCrossCorrelation2d(m["patch_sizes"], m["patch_weights"])
        self.init_fn, self.step_fn = make_multistart_step(
            self.drr, target, **POSE_KW, metric=metric, optimizer="adam",
            lr_rotation=traffic["lr_rotation"], lr_translation=traffic["lr_translation"])
        self.run = 0
        self.params, self.opt = self.init_fn(self.rots[0], self.transs[0])
        self.in_run = self.failed = 0
        self.readings = {}

    def _step(self):
        self.params, self.opt, scores = self.step_fn(self.params, self.opt)
        self.in_run += 1
        return scores.tolist()

    def setup(self) -> None:
        p0 = {k: v.detach().clone() for k, v in self.params.items()}
        scores, grads, images = [], None, []
        forward = self.drr.forward
        # The images the first step renders, as the step renders them.
        self.drr.forward = lambda *a, **kw: _kept(forward(*a, **kw), images)
        for n in range(self.traffic["reference_steps"]):
            scores.append(self._step())
            if n == 0:  # the first gradient, from Adam's first moment
                del self.drr.forward
                b1 = self.opt.param_groups[0]["betas"][0]
                grads = {k: _first_moment(self.opt, v) / (1 - b1)
                         for k, v in self.params.items()}
        self.readings = dict(start=p0, scores=scores, grads=grads, images=images[0],
                             change={k: self.params[k].detach() - p0[k] for k in p0})
        self.readings = {k: _cpu(v) for k, v in self.readings.items()}

    def step(self) -> int:
        if self.in_run == self.traffic["n_iters"]:
            self.run = (self.run + 1) % self.rots.shape[0]
            self.params, self.opt = self.init_fn(self.rots[self.run], self.transs[self.run])
            self.in_run = 0
        scores = self._step()
        self.failed += sum(1 for s in scores if s != s or abs(s) == float("inf"))
        return 1

    def release(self) -> None:
        self.drr = self.init_fn = self.step_fn = self.params = self.opt = None

    def mark_trace(self) -> None:
        self.traced = {k: v.detach().clone() for k, v in self.params.items()}

    def costs(self) -> dict:
        kernel = "siddon_fwdgrad" if self.inputs.config["renderer"] == "siddon" else "joseph_fwdgrad"
        return costs(self.inputs, self.traced["rotation"], self.traced["translation"],
                     {kernel: "fwdgrad"})

    def compare(self, device) -> dict:
        cfg = self.inputs.config
        ref = Reference(self.inputs, device, block_rays(self.inputs))
        tr, got = self.traffic, self.readings
        target = ref.render(self.inputs.rotation[None], self.inputs.translation[None])
        rot = ref.as_ref(got["start"]["rotation"])
        trans = ref.as_ref(got["start"]["translation"])
        start = {"rotation": rot.clone(), "translation": trans.clone()}
        opts = {"rotation": Adam(tr["lr_rotation"]), "translation": Adam(tr["lr_translation"])}
        m = tr["metric"]
        score_gap, first = 0.0, None
        for n in range(tr["reference_steps"]):
            bounds = ref.render(rot, trans, bounds=True)
            if n == 0:
                image_gap = widest_image_gap(got["images"].to(ref.device), bounds)
            scores, grads = _scores_and_grads(ref, rot, trans, target, m,
                                              0.5 * (bounds[0] + bounds[1]))
            score_gap = max(score_gap, float((torch.tensor(got["scores"][n], dtype=scores.dtype)
                                              - scores.cpu()).abs().max()))
            if n == 0:
                first = grads
            rot = opts["rotation"].step(rot, grads["rotation"])
            trans = opts["translation"].step(trans, grads["translation"])
        change = {"rotation": rot - start["rotation"], "translation": trans - start["translation"]}
        return {"score_gap": score_gap, "image_gap": image_gap,
                "grad_gap": _leaf_gap(got["grads"], first, first),
                "grad_dir_gap": _leaf_gap(got["grads"], first, first, apart=True),
                "step_gap": _leaf_gap(got["change"], change, first)}


def _first_moment(opt, param) -> torch.Tensor:
    """Adam's first moment of ``param``; zero where it holds none."""
    state = opt.state.get(param, {})
    return state["exp_avg"].detach() if "exp_avg" in state else torch.zeros_like(param.detach())


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x.cpu() if torch.is_tensor(x) else x


def _kept(img: torch.Tensor, images: list) -> torch.Tensor:
    images.append(img.detach().cpu())
    return img


def _scores_and_grads(ref: Reference, rot, trans, target, metric: dict, img):
    """Each start's score and the gradient of the summed score's negative
    with respect to the poses, through blocks of rays; ``img`` is the
    reference's render of the poses."""
    axis = ref.axis(rot, trans)
    img = img.clone().requires_grad_(True)
    scores = ncc.multiscale_ncc(img, target.expand_as(img), metric["patch_sizes"],
                                metric["patch_weights"])
    (g_img,) = torch.autograd.grad(-scores.sum(), img)
    g_img = g_img.reshape(img.shape[0], -1)
    r, t = rot.clone().requires_grad_(True), trans.clone().requires_grad_(True)
    for b, pix in ref.blocks(img.shape[0]):
        vals = ref.render_block(r, t, b, pix, axis)
        (vals * g_img[b, pix]).sum().backward()
    return scores.detach(), {"rotation": r.grad, "translation": t.grad}


def _leaf_gap(got: dict, want: dict, grads: dict, apart: bool = False) -> float:
    """The worst leaf's gap; a leaf is one start's rotation or translation.
    A leaf's gap is that of its two norms or, ``apart``, the norm of the two
    vectors' difference, over the larger of the reference's norm of that
    leaf and of the median leaf. Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out."""
    keys = [(k, i) for k in ("rotation", "translation") for i in range(want[k].shape[0])]
    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    w = {key: norm(want[key[0]][key[1]]) for key in keys}
    gr = {key: norm(grads[key[0]][key[1]]) for key in keys}
    median_w, median_g = statistics.median(w.values()), statistics.median(gr.values())
    gaps = []
    for k, i in keys:
        if gr[(k, i)] < 1e-3 * median_g:
            continue
        g = got[k][i].to(want[k].device, want[k].dtype)
        if apart:
            gaps.append(norm(g - want[k][i]) / max(w[(k, i)], median_w))
        else:
            gaps.append(relative_gap(norm(g), w[(k, i)], median_w))
    return max(gaps)
