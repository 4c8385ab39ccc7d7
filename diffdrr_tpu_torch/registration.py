"""2D/3D registration by differentiable rendering, and the CNN pose regressor.

Counterpart of ``diffdrr_tpu/registration.py``: ``Registration``, the
optimizers, the step/loop builders and ``PoseRegressor``. Pose parameters
are two tensors, rotation and translation:

  * ``"adam"`` is ``torch.optim.Adam``, whose update
    ``lr * m_hat / (sqrt(v_hat) + eps)`` is the same as optax's ``adam``;
  * ``"sgd"`` is ``torch.optim.SGD`` with ``momentum``/``dampening``, whose
    first step sets the buffer to the gradient (no dampening), the rule the
    JAX package reimplements;
  * ``"lbfgs"`` is ``optax.lbfgs()`` in the port's own copy
    (``diffdrr_tpu_torch.lbfgs``): one parameter group, the learning rates
    ignored (the zoom line search sets the step), each step one
    value-and-gradient per line-search evaluation, taken on fresh leaf
    tensors; the next step reuses the line search's last value and
    gradient, as ``optax.value_and_grad_from_state`` does.

Adam and SGD put each leaf in its own ``torch.optim`` parameter group with
its own learning rate.

A learning rate is a number or a schedule, a callable of the update count
(``exponential_decay``): as optax applies one, the first update uses
``lr(0)`` and the count goes up by one after each update.

The loss is ``-mean(metric(drr(pose), target))`` when maximizing, as in the
JAX package. ``optimize`` is a Python loop over the step;
``optimize_until`` the same loop until the pose is within ``tol_mm`` of the
truth (one read back a step); ``optimize_multistart`` N restarts as one
batched run (the loss the sum of their scores; with LBFGS N independent
runs, each with its own state and line search); ``optimize_multiscale``
coarse-to-fine over ``rescaled_drr`` twins, which read the source DRR's
density, so every scale shares one bricked copy.

``PoseRegressor`` is the JAX package's flax CNN as an ``nn.Module``: a
strided convolutional backbone (``_BACKBONE_PRESETS``) and two linear heads
decoded by ``convert``. Its layers compute what flax's do: convolutions
padded as flax's ``SAME`` pads them (by the parity of each side), group
norms of 8 groups with eps 1e-6. ``interop.pose_regressor_state_from_flax``
carries a flax model's weights across.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .drr import DRR
from .lbfgs import LBFGS, value_and_grad_from_state
from .metrics import DoubleGeodesicSE3, MultiscaleNormalizedCrossCorrelation2d
from .pose import RigidTransform, convert

__all__ = ["Registration", "make_registration_step", "optimize", "make_optimizer",
           "exponential_decay", "optimize_until", "make_multistart_step",
           "optimize_multistart", "rescaled_drr", "resize_target", "optimize_multiscale",
           "LBFGSOptimizer", "PoseRegressor", "N_ANGULAR_COMPONENTS"]

LearningRate = Union[float, Callable[[int], float]]

N_ANGULAR_COMPONENTS = {
    "axis_angle": 3,
    "euler_angles": 3,
    "se3_log_map": 3,
    "quaternion": 4,
    "rotation_6d": 6,
    "rotation_9d": 9,
    "rotation_10d": 10,
    "quaternion_adjugate": 10,
}


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


class LBFGSOptimizer:
    """``optax.lbfgs()`` over the pose leaves as one parameter group: the
    transform (``tx``) and its state (``state``), which each step replaces."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.tx = LBFGS()
        self.state = self.tx.init({k: v.detach() for k, v in params.items()})


def make_optimizer(params: Dict[str, torch.Tensor], optimizer: str, lr_rotation: LearningRate,
                   lr_translation: LearningRate, momentum: float = 0.0,
                   dampening: float = 0.0):
    """Split-LR optimizer over the ``rotation`` and ``translation`` leaves.

    A callable learning rate is a schedule: its group starts at ``lr(0)``
    and each step moves it on after the update (``_step_optimizer``).
    ``"lbfgs"`` gives an :class:`LBFGSOptimizer` and ignores the rates.
    """
    groups = [_group(params["rotation"], lr_rotation),
              _group(params["translation"], lr_translation)]
    if optimizer == "adam":
        return torch.optim.Adam(groups, lr=groups[0]["lr"])
    if optimizer == "sgd":
        return torch.optim.SGD(groups, lr=groups[0]["lr"], momentum=momentum,
                               dampening=dampening)
    if optimizer == "lbfgs":
        return LBFGSOptimizer(params)
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
    With ``optimizer="lbfgs"`` the step is functional: it returns new
    parameter tensors, and ``opt.state`` holds the L-BFGS state
    (``num_linesearch_steps``: the last step's line-search evaluations).
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

    def value_and_grad(p):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def lbfgs_step(params, opt):
        # The JAX package's raw_step: value and gradient from the state (the
        # line search's last ones, afresh at the first step), then the step.
        params = {k: v.detach() for k, v in params.items()}
        loss, grads = value_and_grad_from_state(value_and_grad, params, opt.state)
        updates, opt.state = opt.tx.update(grads, opt.state, params, value=loss,
                                           value_and_grad_fn=value_and_grad)
        params = {k: params[k] + updates[k] for k in params}
        return params, opt, -loss if maximize else loss

    if optimizer == "lbfgs":
        step_fn = lbfgs_step
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
    ``optimizer="lbfgs"`` cannot share one batched update (its line search
    would couple the restarts through one step size), so each restart is a
    single-pose registration with its own state and line search
    (``opt`` a list of N :class:`LBFGSOptimizer`), stepped in turn: N
    independent runs, as the JAX package's ``lax.map`` runs them.
    ``step_fn.scores(params)`` scores poses without a gradient.
    """
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

    if optimizer == "lbfgs":
        _, step_one = make_registration_step(drr, target_img, parameterization, convention,
                                             metric=metric, optimizer="lbfgs",
                                             maximize=maximize, **render_kwargs)
        init_batched = init_fn

        def init_fn(rotations, translations):
            params, _ = init_batched(rotations, translations)
            params = {k: v.detach() for k, v in params.items()}
            n = params["rotation"].shape[0]
            return params, [LBFGSOptimizer({k: v[i:i + 1] for k, v in params.items()})
                            for i in range(n)]

        def step_fn(params, opts):
            runs = [step_one({k: v[i:i + 1] for k, v in params.items()}, opt)
                    for i, opt in enumerate(opts)]
            params = {k: torch.cat([p[k] for p, _, _ in runs]) for k in params}
            # Each run's score is its raw metric (negated loss when maximizing).
            return params, opts, torch.stack([s for _, _, s in runs])

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
    runs the N restarts independently (``make_multistart_step``).
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
    the renderer, its options and the constructor's options (``precision``
    and ``storage`` too), and reads the source DRR's density and labelmap
    tensors: every scale renders from one bricked copy.
    """
    det = drr.detector
    h_s = max(8, int(round(det.height * scale)))
    w_s = max(8, int(round(det.width * scale)))
    twin = DRR(drr.subject, sdd=det.sdd, height=h_s, width=w_s,
               delx=det.delx * det.width / w_s, dely=det.dely * det.height / h_s,
               x0=det._x0, y0=det._y0, renderer=drr.renderer_name,
               voxel_shift=drr.voxel_shift, reverse_x_axis=det.reverse_x_axis,
               patch_size=drr.patch_size, checkpoint_gradients=drr.checkpoint_gradients,
               cache_volume=drr.cache_volume, device=drr.device,
               precision=drr.pallas_precision, storage=drr.pallas_storage,
               **drr.renderer_kwargs)
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


# -----------------------------------------------------------------------------
# CNN pose regressor
# -----------------------------------------------------------------------------

_BACKBONE_PRESETS = {
    "default": (32, 64, 128, 256),
    "small": (16, 32, 64),
    "large": (64, 128, 256, 512),
}


def _same_padding(n: int, stride: int, kernel: int = 3) -> Tuple[int, int]:
    """(before, after) padding of flax's ``SAME`` along a side of ``n``: with
    stride 2 and a 3-wide kernel (0, 1) for even ``n`` and (1, 1) for odd."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class _ConvBackbone(nn.Module):
    """Strided CNN feature extractor: per width a stride-2 and a stride-1
    3x3 convolution, each followed by a group norm and a ReLU, then the
    global average over H and W. (B, 1, H, W) -> (B, widths[-1])."""

    def __init__(self, widths: Sequence[int] = _BACKBONE_PRESETS["default"]):
        super().__init__()
        convs, norms, c_in = [], [], 1
        for w in widths:
            convs += [nn.Conv2d(c_in, w, 3, stride=2), nn.Conv2d(w, w, 3)]
            norms += [nn.GroupNorm(8, w, eps=1e-6), nn.GroupNorm(8, w, eps=1e-6)]
            c_in = w
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            stride = conv.stride[0]
            top, bottom = _same_padding(x.shape[-2], stride)
            left, right = _same_padding(x.shape[-1], stride)
            x = F.relu(norm(conv(F.pad(x, (left, right, top, bottom)))))
        return x.mean(dim=(-2, -1))


class PoseRegressor(nn.Module):
    """CNN that regresses a camera pose from an X-ray image.

    Backbone features feed two linear heads, the rotation
    (``N_ANGULAR_COMPONENTS[parameterization]`` outputs) and the translation
    (3), decoded by :func:`convert` into a ``RigidTransform``, end to end
    differentiable for every parameterization. ``model_name`` picks a
    backbone preset (an unknown name is ``"default"``, as in the JAX
    package); ``height`` is kept for the interface and unused (the pooling
    is global). ``generator`` draws the initial weights as flax does:
    kernels from a normal truncated at two standard deviations, of variance
    1 / fan_in, and zero biases.
    """

    def __init__(self, parameterization: str, convention: Optional[str] = None,
                 model_name: str = "default", height: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del height
        self.parameterization = parameterization
        self.convention = convention
        widths = _BACKBONE_PRESETS.get(model_name, _BACKBONE_PRESETS["default"])
        self.backbone = _ConvBackbone(widths)
        self.rotation_head = nn.Linear(widths[-1], N_ANGULAR_COMPONENTS[parameterization])
        self.translation_head = nn.Linear(widths[-1], 3)
        with torch.no_grad():
            for layer in self.modules():
                if isinstance(layer, (nn.Conv2d, nn.Linear)):
                    fan_in = layer.weight[0].numel()
                    # flax's lecun_normal: the truncated normal rescaled to unit variance.
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> RigidTransform:
        features = self.backbone(x)
        return convert(self.rotation_head(features), self.translation_head(features),
                       parameterization=self.parameterization, convention=self.convention)
