"""L-BFGS with a zoom line search, the algorithm of ``optax.lbfgs()``.

A port to PyTorch of optax 0.2.6's default L-BFGS (``optax/_src/transform.py``
``scale_by_lbfgs``, ``optax/_src/linesearch.py`` ``zoom_linesearch`` and
``scale_by_zoom_linesearch``, ``optax/_src/utils.py``
``value_and_grad_from_state``; optax is Copyright DeepMind Technologies
Limited and licensed under the Apache License, Version 2.0). The JAX package
registers by ``optax.lbfgs()``, whose defaults are

    chain(scale_by_lbfgs(memory_size=10, scale_init_precond=True),
          scale(-1.0),
          scale_by_zoom_linesearch(max_linesearch_steps=20,
                                   initial_guess_strategy="one"))

and this module is that chain, step for step:

  * the memory is a ring buffer of ``memory_size`` parameter and gradient
    differences; a slot not yet filled has weight 0 and so no effect on the
    two-loop recursion; the initial inverse Hessian is ``gamma * I``, with
    ``gamma = <dg, dw> / <dg, dg>`` from the newest pair, and at the first
    step ``min(1, 1 / |g|)``;
  * the line search (Nocedal and Wright, algorithms 3.5 and 3.6, with the
    approximate Wolfe decrease of Hager and Zhang) starts at step size 1,
    doubles it until an interval is found, then zooms in by cubic, then
    quadratic interpolation, then bisection; slope_rtol 1e-4, curv_rtol 0.9,
    approx_dec_rtol 1e-6, stepsize_precision 1e-5, increase_factor 2,
    tol 0, no largest step; after 20 evaluations it falls back to the best
    step with sufficient decrease seen, if any;
  * the next step reuses the line search's last value and gradient
    (``value_and_grad_from_state``) unless that value is inf or NaN, as it
    is before the first step.

Parameters are dicts of tensors (a tree); dot products are taken leaf by
leaf and summed over the leaves in sorted key order, JAX's order for a
dict. The line search's scalars stay float32 0-d tensors on the
parameters' device, and its branch decisions are taken there by
``torch.where``, as optax takes them; the host reads three flags back
after each evaluation (whether the interval is found, whether it is done
or failed), one synchronisation an evaluation, to choose the next phase
and to stop. ``torch.optim.LBFGS`` is another algorithm (another line
search and memory rule), which is why this module exists.

``evaluations`` counts, over the process, the evaluations the line
searches made (``"linesearch"``) and those ``value_and_grad_from_state``
made afresh (``"first"``); ``reset_evaluations`` zeroes both.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Tuple

import torch

__all__ = ["LBFGS", "LBFGSState", "value_and_grad_from_state", "evaluations",
           "reset_evaluations"]

Tree = Dict[str, torch.Tensor]
ValueAndGrad = Callable[[Tree], Tuple[torch.Tensor, Tree]]

# scale_by_zoom_linesearch's defaults, as optax.lbfgs() leaves them.
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0

evaluations = {"linesearch": 0, "first": 0}


def reset_evaluations() -> None:
    evaluations["linesearch"] = evaluations["first"] = 0


def tree_vdot(x: Tree, y: Tree) -> torch.Tensor:
    """Sum over the leaves (sorted keys) of each leaf's dot product."""
    total = 0
    for k in sorted(x):
        total = total + torch.dot(x[k].reshape(-1), y[k].reshape(-1))
    return total


def _tree_sqnorm(x: Tree) -> torch.Tensor:
    total = 0
    for k in sorted(x):
        total = total + torch.sum(torch.square(x[k]))
    return total


def _add_scale(x: Tree, scalar, y: Tree) -> Tree:
    """``x + scalar * y``."""
    return {k: x[k] + scalar * y[k] for k in x}


def _where(cond: torch.Tensor, a, b):
    """``torch.where`` over matching lists of tensors or trees."""
    out = []
    for u, v in zip(a, b):
        if isinstance(u, dict):
            out.append({k: torch.where(cond, u[k], v[k]) for k in u})
        else:
            out.append(torch.where(cond, u, v))
    return out


@dataclass
class LBFGSState:
    """State of :class:`LBFGS` (optax's ``ScaleByLBFGSState`` and
    ``ScaleByZoomLinesearchState`` together)."""

    count: int
    params: Tree
    updates: Tree
    diff_params_memory: Tree
    diff_updates_memory: Tree
    weights_memory: torch.Tensor
    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: Tree
    num_linesearch_steps: int
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc ** 2 * r1 + (-(db ** 2)) * r2) / denom
    B = ((-(dc ** 3)) * r1 + db ** 3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


@dataclass
class _Search:
    """``ZoomLinesearchState`` (``count`` on the host)."""

    count: int
    params: Tree
    updates: Tree
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: Tree
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: Tree


class LBFGS:
    """``optax.lbfgs(memory_size=...)`` with a zoom line search of at most
    ``max_linesearch_steps`` evaluations (the defaults are optax's):
    ``init(params)`` and ``update(grad, state, params, value=...,
    value_and_grad_fn=...)``, which returns the step to add to ``params``
    and the new state."""

    def __init__(self, memory_size: int = 10, max_linesearch_steps: int = 20):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = memory_size
        self.max_linesearch_steps = max_linesearch_steps

    def init(self, params: Tree) -> LBFGSState:
        leaf = params[sorted(params)[0]]
        f32 = dict(dtype=leaf.dtype, device=leaf.device)
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        stacked = {k: torch.zeros((self.memory_size,) + v.shape, dtype=v.dtype, device=v.device)
                   for k, v in params.items()}
        inf = torch.tensor(float("inf"), **f32)
        return LBFGSState(
            count=0, params=zeros, updates=dict(zeros), diff_params_memory=stacked,
            diff_updates_memory=dict(stacked), weights_memory=torch.zeros(self.memory_size, **f32),
            learning_rate=torch.tensor(1.0, **f32), value=inf, grad=dict(zeros),
            num_linesearch_steps=0, decrease_error=inf, curvature_error=inf)

    # -- scale_by_lbfgs --------------------------------------------------------

    def _precondition(self, updates, dw_mem, du_mem, rhos, identity_scale, memory_idx):
        """The two-loop recursion over the memory, newest pair first."""
        m = self.memory_size
        indices = [(memory_idx + i) % m for i in range(m)]
        vec, alphas = updates, {}
        for idx in reversed(indices):
            dwi = {k: v[idx] for k, v in dw_mem.items()}
            dui = {k: v[idx] for k, v in du_mem.items()}
            alpha = rhos[idx] * tree_vdot(dwi, vec)
            vec = _add_scale(vec, -alpha, dui)
            alphas[idx] = alpha
        vec = {k: identity_scale * v for k, v in vec.items()}
        for idx in indices:
            dwi = {k: v[idx] for k, v in dw_mem.items()}
            dui = {k: v[idx] for k, v in du_mem.items()}
            beta = rhos[idx] * tree_vdot(dui, vec)
            vec = _add_scale(vec, alphas[idx] - beta, dwi)
        return vec

    def _scale_by_lbfgs(self, updates: Tree, state: LBFGSState, params: Tree):
        m = self.memory_size
        memory_idx = state.count % m
        prev_idx = (state.count - 1) % m
        if state.count > 0:
            diff_params = {k: params[k] - state.params[k] for k in params}
            diff_updates = {k: updates[k] - state.updates[k] for k in updates}
            vdot = tree_vdot(diff_updates, diff_params)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        else:
            diff_params = {k: torch.zeros_like(v) for k, v in params.items()}
            diff_updates = {k: torch.zeros_like(v) for k, v in updates.items()}
            weight = torch.zeros_like(state.weights_memory[0])
        dw_mem = {k: v.clone() for k, v in state.diff_params_memory.items()}
        du_mem = {k: v.clone() for k, v in state.diff_updates_memory.items()}
        rhos = state.weights_memory.clone()
        for k in dw_mem:
            dw_mem[k][prev_idx] = diff_params[k]
            du_mem[k][prev_idx] = diff_updates[k]
        rhos[prev_idx] = weight

        if state.count > 0:
            numerator = tree_vdot(diff_updates, diff_params)
            denominator = _tree_sqnorm(diff_updates)
            identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                         torch.ones_like(denominator))
        else:
            update_norm = torch.sqrt(_tree_sqnorm(updates))
            identity_scale = torch.minimum(torch.ones_like(update_norm), 1.0 / update_norm)
        precond = self._precondition(updates, dw_mem, du_mem, rhos, identity_scale, memory_idx)
        return precond, replace(state, count=state.count + 1, params=params, updates=updates,
                                diff_params_memory=dw_mem, diff_updates_memory=du_mem,
                                weights_memory=rhos)

    # -- zoom_linesearch -------------------------------------------------------

    def _on_line(self, value_and_grad_fn, params, stepsize, updates):
        value, grad = value_and_grad_fn(_add_scale(params, stepsize, updates))
        evaluations["linesearch"] += 1
        return value, grad, tree_vdot(grad, updates)

    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        # Hager and Zhang's approximate decrease, near a minimum.
        approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        error = torch.minimum(torch.maximum(approx, delta), error)
        error = torch.clamp(error, min=0.0)
        return torch.where(torch.isnan(error), torch.full_like(error, float("inf")), error)

    def _curvature_error(self, slope_step, slope_init):
        error = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
        error = torch.clamp(error, min=0.0)
        return torch.where(torch.isnan(error), torch.full_like(error, float("inf")), error)

    def _try_safe_step(self, s: _Search) -> _Search:
        outside_domain = torch.isinf(s.decrease_error)
        stepsize, value, grad = _where((s.safe_stepsize > 0.0) | outside_domain,
                                       [s.safe_stepsize, s.safe_value, s.safe_grad],
                                       [s.stepsize, s.value, s.grad])
        return replace(s, stepsize=stepsize, value=value, grad=grad)

    def _search_interval(self, s: _Search, value_and_grad_fn) -> _Search:
        """Algorithm 3.5 of Nocedal and Wright: grow the step until an
        interval holding an acceptable step is found."""
        if s.count == 0:
            new_stepsize = torch.ones_like(s.stepsize)  # initial_guess_strategy="one"
        else:
            new_stepsize = INCREASE_FACTOR * s.stepsize
        new_value, new_grad, new_slope = self._on_line(value_and_grad_fn, s.params,
                                                       new_stepsize, s.updates)
        decrease_error = self._decrease_error(new_stepsize, new_value, new_slope, s.value_init,
                                              s.slope_init)
        curvature_error = self._curvature_error(new_slope, s.slope_init)
        new_error = torch.maximum(decrease_error, curvature_error)
        safe_stepsize, safe_value, safe_grad = _where(
            decrease_error <= TOL, [new_stepsize, new_value, new_grad],
            [s.safe_stepsize, s.safe_value, s.safe_grad])
        set_high_to_new = decrease_error > 0.0
        if s.count > 0:
            set_high_to_new = set_high_to_new | (new_value >= s.value)
        set_low_to_new = (new_slope >= 0.0) & ~set_high_to_new
        low, value_low, slope_low, high, value_high, slope_high = _where(
            set_low_to_new,
            [new_stepsize, new_value, new_slope, s.stepsize, s.value, s.slope],
            [s.stepsize, s.value, s.slope, new_stepsize, new_value, new_slope])
        interval_found = set_high_to_new | set_low_to_new | (new_error <= TOL)
        done = new_error <= TOL  # no largest step: it is never reached
        failed = torch.tensor(s.count + 1 >= self.max_linesearch_steps,
                              device=done.device) & ~done
        return replace(
            s, count=s.count + 1, stepsize=new_stepsize, value=new_value, grad=new_grad,
            slope=new_slope, decrease_error=decrease_error, curvature_error=curvature_error,
            interval_found=interval_found, done=done, failed=failed, low=low,
            value_low=value_low, slope_low=slope_low, high=high, value_high=value_high,
            slope_high=slope_high, cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=safe_stepsize, safe_value=safe_value, safe_grad=safe_grad)

    def _zoom_into_interval(self, s: _Search, value_and_grad_fn) -> _Search:
        """Algorithm 3.6 of Nocedal and Wright: shrink the interval by
        cubic, quadratic or bisection steps."""
        low, value_low, slope_low = s.low, s.value_low, s.slope_low
        high, value_high, slope_high = s.high, s.value_high, s.slope_high
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = delta <= STEPSIZE_PRECISION

        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high, s.cubic_ref,
                                 s.value_cubic_ref)
        use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = ~use_cubic & (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk)
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, middle_cubic, s.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)

        value_middle, grad_middle, slope_middle = self._on_line(value_and_grad_fn, s.params,
                                                                middle, s.updates)
        decrease_error = self._decrease_error(middle, value_middle, slope_middle, s.value_init,
                                              s.slope_init)
        curvature_error = self._curvature_error(slope_middle, s.slope_init)
        new_error = torch.maximum(decrease_error, curvature_error)
        update_safe = (decrease_error <= TOL) & (value_middle < s.safe_value)
        safe_stepsize, safe_value, safe_grad = _where(
            update_safe, [middle, value_middle, grad_middle],
            [s.safe_stepsize, s.safe_value, s.safe_grad])
        done = new_error <= TOL

        set_high_to_middle = (decrease_error > 0.0) | (value_middle >= value_low)
        set_high_to_low = (slope_middle * (high - low) >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle
        new_high, new_value_high, new_slope_high = _where(
            set_high_to_middle, [middle, value_middle, slope_middle],
            [high, value_high, slope_high])
        new_high, new_value_high, new_slope_high = _where(
            set_high_to_low, [low, value_low, slope_low],
            [new_high, new_value_high, new_slope_high])
        new_low, new_value_low, new_slope_low = _where(
            set_low_to_middle, [middle, value_middle, slope_middle],
            [low, value_low, slope_low])
        new_cubic_ref, new_value_cubic_ref = _where(
            set_high_to_middle | set_high_to_low, [high, value_high], [low, value_low])
        max_iter_reached = s.count + 1 >= self.max_linesearch_steps
        presumably_failed = too_small_int & (safe_stepsize > 0.0)
        if max_iter_reached:
            presumably_failed = torch.ones_like(presumably_failed)
        return replace(
            s, count=s.count + 1, stepsize=middle, value=value_middle, grad=grad_middle,
            slope=slope_middle, decrease_error=decrease_error, curvature_error=curvature_error,
            done=done, failed=presumably_failed & ~done, low=new_low, value_low=new_value_low,
            slope_low=new_slope_low, high=new_high, value_high=new_value_high,
            slope_high=new_slope_high, cubic_ref=new_cubic_ref,
            value_cubic_ref=new_value_cubic_ref, safe_stepsize=safe_stepsize,
            safe_value=safe_value, safe_grad=safe_grad)

    def _linesearch(self, updates: Tree, params: Tree, value: torch.Tensor, grad: Tree,
                    value_and_grad_fn: ValueAndGrad) -> _Search:
        slope = tree_vdot(updates, grad)
        zero = torch.zeros_like(slope)
        inf = torch.full_like(slope, float("inf"))
        false = torch.zeros((), dtype=torch.bool, device=slope.device)
        s = _Search(count=0, params=params, updates=updates, stepsize=zero, value=value,
                    grad=grad, slope=slope, value_init=value, slope_init=slope,
                    decrease_error=inf, curvature_error=inf, interval_found=false, done=false,
                    failed=false, low=zero, value_low=value, slope_low=slope, high=zero,
                    value_high=value, slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
                    safe_stepsize=zero, safe_value=value, safe_grad=grad)
        interval_found = False
        while True:
            if interval_found:
                s = self._zoom_into_interval(s, value_and_grad_fn)
            else:
                s = self._search_interval(s, value_and_grad_fn)
            # The one read back of an evaluation: the next phase and the stop.
            interval_found, done, failed = torch.stack(
                [s.interval_found, s.done, s.failed]).tolist()
            if failed:
                s = self._try_safe_step(s)
            if done or failed:
                return s

    # -- the chain -------------------------------------------------------------

    def update(self, grad: Tree, state: LBFGSState, params: Tree, *, value: torch.Tensor,
               value_and_grad_fn: ValueAndGrad) -> Tuple[Tree, LBFGSState]:
        """One L-BFGS step from ``params``, where the loss is ``value`` and its
        gradient ``grad``: the preconditioned direction, negated, scaled by
        the line search's step. Returns ``(updates, state)``; the new
        parameters are ``params + updates``."""
        precond, state = self._scale_by_lbfgs(grad, state, params)
        direction = {k: -1.0 * v for k, v in precond.items()}
        s = self._linesearch(direction, params, value, grad, value_and_grad_fn)
        updates = {k: s.stepsize * v for k, v in direction.items()}
        return updates, replace(state, learning_rate=s.stepsize, value=s.value, grad=s.grad,
                                num_linesearch_steps=s.count,
                                decrease_error=s.decrease_error,
                                curvature_error=s.curvature_error)


def value_and_grad_from_state(value_and_grad_fn: ValueAndGrad, params: Tree,
                              state: LBFGSState) -> Tuple[torch.Tensor, Tree]:
    """The line search's last value and gradient if that value is finite,
    else ``value_and_grad_fn(params)`` (optax's ``value_and_grad_from_state``;
    its check reads the value back to the host)."""
    if bool(torch.isfinite(state.value)):
        return state.value, state.grad
    evaluations["first"] += 1
    return value_and_grad_fn(params)
