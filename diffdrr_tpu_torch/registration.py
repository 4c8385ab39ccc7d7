"""2D/3D registration by differentiable rendering.

Counterpart of the iterative half of ``diffdrr_tpu/registration.py``:
``Registration``, the split-learning-rate optimizers, and the step/loop
builders. Pose parameters are two leaf tensors, rotation and translation,
each in its own ``torch.optim`` parameter group with its own learning rate:

  * ``"adam"`` is ``torch.optim.Adam``, whose update
    ``lr * m_hat / (sqrt(v_hat) + eps)`` is the same as optax's ``adam``;
  * ``"sgd"`` is ``torch.optim.SGD`` with ``momentum``/``dampening``, whose
    first step sets the buffer to the gradient (no dampening), the rule the
    JAX package reimplements.

A learning rate is a number or a schedule, a callable of the update count
(``exponential_decay``): as optax applies one, the first update uses
``lr(0)`` and the count goes up by one after each update.

The loss is ``-mean(metric(drr(pose), target))`` when maximizing, as in the
JAX package. ``optimize`` is a Python loop over the step;
``optimize_until`` the same loop until the pose is within ``tol_mm`` of the
truth (one read back a step); ``optimize_multistart`` N restarts as one
batched run (the loss the sum of their scores); ``optimize_multiscale``
coarse-to-fine over ``rescaled_drr`` twins, which read the source DRR's
density, so every scale shares one bricked copy.

Not ported yet (ROADMAP.md, queue 1): LBFGS, which needs optax's
two-loop recursion and zoom line search (``torch.optim.LBFGS`` is another
algorithm), and ``PoseRegressor``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .drr import DRR
from .metrics import DoubleGeodesicSE3, MultiscaleNormalizedCrossCorrelation2d
from .pose import RigidTransform, convert

__all__ = ["Registration", "make_registration_step", "optimize", "make_optimizer",
           "exponential_decay", "optimize_until", "make_multistart_step",
           "optimize_multistart", "rescaled_drr", "resize_target", "optimize_multiscale"]

LearningRate = Union[float, Callable[[int], float]]
LBFGS_NOT_PORTED = ("LBFGS registration is not ported yet: it needs optax.lbfgs's two-loop "
                    "recursion and zoom line search (ROADMAP.md, queue 1: LBFGS)")


class Registration:
    """Iterative 2D/3D registration: the DRR and the pose parameters."""

    def __init__(self, drr: DRR, rotation: torch.Tensor, translation: torch.Tensor,
                 parameterization: str, convention: Optional[str] = None):
        self.drr = drr
        self.rotation = torch.as_tensor(rotation, device=drr.device).detach().clone().requires_grad_(True)
        self.translation = torch.as_tensor(translation, device=drr.device).detach().clone().requires_grad_(True)
        self.parameterization = parameterization
        self.convention = convention

    @property
    def pose(self) -> RigidTransform:
        return convert(self.rotation, self.translation,
                       parameterization=self.parameterization, convention=self.convention)

    @property
    def params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.rotation, self.translation

    def __call__(self, **kwargs):
        return self.drr(self.pose, **kwargs)

    forward = __call__


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """The schedule ``count -> init_value * decay_rate ** (count / transition_steps)``
    (optax's ``exponential_decay``, not staircase; constant when
    ``transition_steps <= 0``)."""
    if transition_steps <= 0:
        return lambda count: init_value
    return lambda count: init_value * decay_rate ** (count / transition_steps)


def _group(param: torch.Tensor, lr: LearningRate) -> dict:
    if callable(lr):
        return {"params": [param], "lr": float(lr(0)), "schedule": lr, "count": 0}
    return {"params": [param], "lr": lr}


def make_optimizer(params: Dict[str, torch.Tensor], optimizer: str, lr_rotation: LearningRate,
                   lr_translation: LearningRate, momentum: float = 0.0,
                   dampening: float = 0.0) -> torch.optim.Optimizer:
    """Split-LR optimizer over the ``rotation`` and ``translation`` leaves.

    A callable learning rate is a schedule: its group starts at ``lr(0)``
    and each step moves it on after the update (``_step_optimizer``).
    """
    groups = [_group(params["rotation"], lr_rotation),
              _group(params["translation"], lr_translation)]
    if optimizer == "adam":
        return torch.optim.Adam(groups, lr=groups[0]["lr"])
    if optimizer == "sgd":
        return torch.optim.SGD(groups, lr=groups[0]["lr"], momentum=momentum,
                               dampening=dampening)
    if optimizer == "lbfgs":
        raise NotImplementedError(LBFGS_NOT_PORTED)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def _step_optimizer(opt: torch.optim.Optimizer) -> None:
    """One update, then each scheduled group's count and learning rate move on."""
    opt.step()
    for group in opt.param_groups:
        if "schedule" in group:
            group["count"] += 1
            group["lr"] = float(group["schedule"](group["count"]))


def make_registration_step(
    drr: DRR,
    target_img: torch.Tensor,
    parameterization: str,
    convention: Optional[str] = None,
    metric: Optional[Callable] = None,
    lr_rotation: float = 5e-2,
    lr_translation: float = 1e0,
    optimizer: str = "adam",
    momentum: float = 0.0,
    dampening: float = 0.0,
    maximize: bool = True,
    **render_kwargs,
):
    """Build ``(init_fn, step_fn)`` for a registration loop on ``drr.device``.

    ``init_fn(rotation, translation) -> (params, opt)`` makes fresh leaf
    tensors on the DRR's device and their optimizer;
    ``step_fn(params, opt) -> (params, opt, score)`` renders, scores,
    back-propagates to the pose and takes one optimizer step in place.
    ``score`` is the metric at the pose before the step, a 0-d tensor.
    """
    if metric is None:
        metric = MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5])
    device = drr.device

    def loss_of(params):
        img = drr(params["rotation"], params["translation"],
                  parameterization=parameterization, convention=convention,
                  **render_kwargs)
        score = torch.mean(metric(img, target_img))
        return -score if maximize else score

    def init_fn(rotation, translation):
        params = {
            "rotation": torch.as_tensor(rotation, dtype=torch.float32, device=device)
            .detach().clone().requires_grad_(True),
            "translation": torch.as_tensor(translation, dtype=torch.float32, device=device)
            .detach().clone().requires_grad_(True),
        }
        return params, make_optimizer(params, optimizer, lr_rotation, lr_translation,
                                      momentum, dampening)

    def step_fn(params, opt):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(params)
        loss.backward()
        _step_optimizer(opt)
        score = -loss.detach() if maximize else loss.detach()
        return params, opt, score

    step_fn.loss = loss_of
    step_fn.metric = metric
    return init_fn, step_fn


def optimize(drr: DRR, target_img: torch.Tensor, rotation: torch.Tensor,
             translation: torch.Tensor, parameterization: str,
             convention: Optional[str] = None, n_iters: int = 100,
             verbose: bool = False, **kwargs):
    """Run an iterative registration; returns ``(rotation, translation, trace)``.

    ``trace`` is the list of per-step scores (floats), read back once at the
    end so the loop does not wait on the device every step.
    """
    init_fn, step_fn = make_registration_step(drr, target_img, parameterization,
                                              convention, **kwargs)
    params, opt = init_fn(rotation, translation)
    scores = []
    for it in range(n_iters):
        params, opt, score = step_fn(params, opt)
        scores.append(score)
        if verbose:
            print(f"iter {it:4d}  score {float(score):.5f}")
    trace = torch.stack(scores).tolist() if scores else []
    return params["rotation"].detach(), params["translation"].detach(), trace


def optimize_until(drr: DRR, target_img: torch.Tensor, rotation: torch.Tensor,
                   translation: torch.Tensor, parameterization: str,
                   convention: Optional[str] = None,
                   true_pose: Optional[RigidTransform] = None, tol_mm: float = 1.0,
                   max_iters: int = 500, **kwargs) -> Tuple[torch.Tensor, torch.Tensor, int, float]:
    """Register until the pose is within ``tol_mm`` of ``true_pose``.

    The distance is the largest ``DoubleGeodesicSE3`` over the batch. It is
    checked before the first step and after each, and the loop stops at the
    first check at or below ``tol_mm``, or after ``max_iters`` steps (the
    JAX package's ``lax.while_loop``, which reads nothing back; this loop
    reads the distance back once a step). Returns ``(rotation, translation,
    n_steps, final_mm)``.
    """
    if true_pose is None:
        raise ValueError("optimize_until requires the ground-truth pose")
    geodesic = DoubleGeodesicSE3(sdd=drr.detector.sdd)
    init_fn, step_fn = make_registration_step(drr, target_img, parameterization, convention,
                                              **kwargs)
    params, opt = init_fn(rotation, translation)

    def distance() -> float:
        with torch.no_grad():
            est = convert(params["rotation"], params["translation"],
                          parameterization=parameterization, convention=convention)
            return float(torch.max(geodesic(true_pose, est)[2]))

    n, dist = 0, distance()
    while dist > tol_mm and n < max_iters:
        params, opt, _ = step_fn(params, opt)
        n, dist = n + 1, distance()
    return params["rotation"].detach(), params["translation"].detach(), n, dist


def make_multistart_step(drr: DRR, target_img: torch.Tensor, parameterization: str,
                         convention: Optional[str] = None, metric: Optional[Callable] = None,
                         optimizer: str = "adam", lr_rotation: LearningRate = 5e-2,
                         lr_translation: LearningRate = 1e0, momentum: float = 0.0,
                         dampening: float = 0.0, maximize: bool = True, **render_kwargs):
    """``(init_fn, step_fn)`` for N restarts as one batched registration.

    ``init_fn(rotations, translations)`` takes (N, ...) starts;
    ``step_fn(params, opt) -> (params, opt, scores)`` renders all N poses
    at once, steps on the sum of their scores and returns the (N,) raw
    scores before the step. Adam and SGD update elementwise and each score
    depends only on its own pose, so the batch is N independent runs (each
    restart's trajectory is the same whatever the other starts). It is not
    bit for bit a single-pose run's: on the card a batch of one rounds the
    rays' lengths and the rotation products otherwise in the last bit.
    ``step_fn.scores(params)`` scores poses without a gradient.
    """
    if optimizer == "lbfgs":
        raise NotImplementedError(LBFGS_NOT_PORTED)
    if metric is None:
        metric = MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5])
    init_fn, _ = make_registration_step(drr, target_img, parameterization, convention,
                                        metric=metric, lr_rotation=lr_rotation,
                                        lr_translation=lr_translation, optimizer=optimizer,
                                        momentum=momentum, dampening=dampening)

    def scores_of(params):
        img = drr(params["rotation"], params["translation"],
                  parameterization=parameterization, convention=convention, **render_kwargs)
        return metric(img, target_img.expand_as(img))

    def step_fn(params, opt):
        opt.zero_grad(set_to_none=True)
        per = scores_of(params)
        loss = -torch.sum(per) if maximize else torch.sum(per)
        loss.backward()
        _step_optimizer(opt)
        return params, opt, per.detach()

    def scores(params):
        with torch.no_grad():
            return scores_of(params)

    step_fn.scores = scores
    step_fn.metric = metric
    return init_fn, step_fn


def optimize_multistart(drr: DRR, target_img: torch.Tensor, rotations: torch.Tensor,
                        translations: torch.Tensor, parameterization: str,
                        convention: Optional[str] = None, n_iters: int = 100, **kwargs):
    """Run N restarts as one batched optimization (``make_multistart_step``).

    Returns ``(rotations, translations, final_scores, trace)``: raw metric
    values, ``final_scores`` (N,) at the returned poses and ``trace``
    (n_iters, N) each step's scores before its update. Pick the winner with
    ``argmax`` (``maximize=True``) or ``argmin``. ``optimizer="lbfgs"``
    raises ``NotImplementedError``.
    """
    init_fn, step_fn = make_multistart_step(drr, target_img, parameterization, convention,
                                            **kwargs)
    params, opt = init_fn(rotations, translations)
    trace = []
    for _ in range(n_iters):
        params, opt, per = step_fn(params, opt)
        trace.append(per)
    final = step_fn.scores(params)
    trace = torch.stack(trace) if trace else final.new_zeros((0, final.shape[0]))
    return params["rotation"].detach(), params["translation"].detach(), final, trace


def rescaled_drr(drr: DRR, scale: float) -> DRR:
    """A coarse twin of ``drr`` over the same physical detector plane.

    The pixel pitch comes from the realised pixel count
    (``h * dely == h_s * dely_s`` exactly, ``delx`` scaling the width), so
    rounding ``h * scale`` never changes the field of view. The twin keeps
    the renderer, its options and the constructor's options, and reads the
    source DRR's density and labelmap tensors: every scale renders from
    one bricked copy.
    """
    det = drr.detector
    h_s = max(8, int(round(det.height * scale)))
    w_s = max(8, int(round(det.width * scale)))
    twin = DRR(drr.subject, sdd=det.sdd, height=h_s, width=w_s,
               delx=det.delx * det.width / w_s, dely=det.dely * det.height / h_s,
               x0=det._x0, y0=det._y0, renderer=drr.renderer_name,
               voxel_shift=drr.voxel_shift, reverse_x_axis=det.reverse_x_axis,
               patch_size=drr.patch_size, checkpoint_gradients=drr.checkpoint_gradients,
               cache_volume=drr.cache_volume, device=drr.device, **drr.renderer_kwargs)
    twin.density, twin.mask, twin.n_channels = drr.density, drr.mask, drr.n_channels
    return twin


def resize_target(target_img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``target_img`` (B, C, H, W) resized to (height, width) by antialiased
    bilinear interpolation: ``jax.image.resize(..., "linear")``'s result."""
    return F.interpolate(target_img, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)


def optimize_multiscale(drr: DRR, target_img: torch.Tensor, rotation: torch.Tensor,
                        translation: torch.Tensor, parameterization: str,
                        convention: Optional[str] = None,
                        scales: Sequence[float] = (0.25, 0.5, 1.0),
                        n_iters_per_scale: int = 100, **kwargs):
    """Coarse-to-fine registration over a detector resolution pyramid.

    At each scale below 1 it registers on ``rescaled_drr(drr, scale)``
    against the target resized to that detector (``resize_target``), then
    goes on from the pose reached. Returns ``(rotation, translation,
    traces)``, one trace of scores per scale.
    """
    traces = []
    for scale in scales:
        drr_s, tgt = drr, target_img
        if scale != 1.0:
            drr_s = rescaled_drr(drr, scale)
            tgt = resize_target(target_img, drr_s.detector.height, drr_s.detector.width)
        rotation, translation, trace = optimize(drr_s, tgt, rotation, translation,
                                                parameterization, convention,
                                                n_iters=n_iters_per_scale, **kwargs)
        traces.append(trace)
    return rotation, translation, traces
