"""Registration experiment: recover perturbed poses by gradient descent.

Counterpart of ``experiments/registration.py`` (the JAX package's CLI), with
the same flags, defaults and CSV files, on ``argparse``: draw random initial
offsets from the true pose of the example CT, register with split
rotation/translation learning rates, and record the similarity and the
double geodesic to the truth (converged: below 1 mm).

    python -m diffdrr_tpu_torch.experiments.registration --n-runs 10 --n-iters 250
    python -m diffdrr_tpu_torch.experiments.registration --cpu --volume-size 32 \\
        --height 16 --n-runs 2 --n-iters 5 --outdir "$(mktemp -d)"
    python -m diffdrr_tpu_torch.experiments.registration --multiscale 0.25,0.5,1.0 \\
        --iters-per-scale 20,20,20 --lr-decay 0.1 --polish-iters 20 --n-runs 2

Three branches, as in the JAX CLI:

  * serial runs (the default), each stopping at 1 mm or ``--n-iters``;
    ``run_NNN.csv`` per run (iter, score, rotational, translational and
    double geodesic in mm, elapsed seconds) and ``summary.csv``;
  * ``--multistart``: all runs as one batched optimization
    (``optimize_multistart``), after one warm-up run; ``multistart.csv``;
  * ``--multiscale s1,s2,...``: coarse-to-fine over ``rescaled_drr`` twins
    with the target resized to each, ``--iters-per-scale`` steps each, an
    exponential learning-rate decay of ``--lr-decay`` per scale, and with
    ``--polish-iters`` a full-scale gradient-NCC stage; one warm-up run,
    then ``multiscale_summary.csv``.

Each run draws its rotation offset (1, 3) and then its translation offset
(1, 3) from ``np.random.default_rng(seed)`` (multistart: (n_runs, 3) each),
in the JAX CLI's order, so both CLIs start from the same poses. It steps
one step at a time (the JAX CLI's 5-step scan chunks work around a TPU
worker fault). As in the JAX CLI, ``--polish-iters`` acts only with
``--multiscale``; here a warning says when it is dropped. It runs on the
CUDA card unless ``--cpu``. ``main(argv)`` returns the run's record: each
run's start, final pose, final double geodesic, scores and per-step times
(CUDA events on the card, the host clock on the CPU), and the DRR and
target it used; with ``--optimizer lbfgs`` also each serial run's (and each
stage's) ``linesearch_steps``: each step's line-search evaluations and
whether its step met the sufficient-decrease criterion.

``--optimizer lbfgs`` (``optax.lbfgs()`` in the port's copy) takes every
branch. As in the JAX CLI it ignores the learning rates and so the
``--lr-decay`` and ``--polish-lr-decay`` schedules.
"""

from __future__ import annotations

import argparse
import csv
import time
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import StepClock
from ..data import load_example_ct
from ..drr import DRR
from ..metrics import (DoubleGeodesicSE3, GradientNormalizedCrossCorrelation2d,
                       MultiscaleNormalizedCrossCorrelation2d)
from ..pose import convert
from ..registration import (exponential_decay, make_registration_step, optimize_multistart,
                            rescaled_drr, resize_target)

__all__ = ["parse_args", "main"]

KW = dict(parameterization="euler_angles", convention="ZXY")
CONVERGED_MM = 1.0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    flag = argparse.BooleanOptionalAction
    p.add_argument("--cpu", action=flag, default=False,
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--n-runs", type=int, default=10, help="number of random initializations")
    p.add_argument("--n-iters", type=int, default=250, help="max iterations per run")
    p.add_argument("--height", type=int, default=128, help="DRR height/width in pixels")
    p.add_argument("--volume-size", type=int, default=256, help="phantom volume XY size")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "lbfgs"])
    p.add_argument("--momentum", type=float, default=0.0, help="SGD momentum")
    p.add_argument("--dampening", type=float, default=0.0, help="SGD dampening")
    p.add_argument("--lr-rotation", type=float, default=5e-3)
    p.add_argument("--lr-translation", type=float, default=5e-1)
    p.add_argument("--renderer", default="trilinear", choices=["siddon", "trilinear", "joseph"])
    p.add_argument("--outdir", default="experiments/results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--multistart", action=flag, default=False,
                   help="run all inits as ONE batched optimization (optimize_multistart) "
                        "instead of serial runs")
    p.add_argument("--multiscale", default="",
                   help="comma-separated detector scales for coarse-to-fine (e.g. "
                        "'0.25,0.5,1.0'); empty = single scale")
    p.add_argument("--iters-per-scale", default="",
                   help="comma-separated per-scale iteration counts (default: n-iters "
                        "split evenly across scales)")
    p.add_argument("--lr-decay", type=float, default=1.0,
                   help="exponential LR decay: final LR = initial * lr_decay (per scale); "
                        "1.0 disables the schedule")
    p.add_argument("--var-floor", type=float, default=0.0,
                   help="relative patch-variance floor of the NCC metric (0 = the "
                        "reference's metric)")
    p.add_argument("--polish-iters", type=int, default=0,
                   help="append a full-scale gradient-NCC polish stage of this many "
                        "iterations after the multiscale schedule (with --multiscale only)")
    p.add_argument("--polish-lr-rotation", type=float, default=1e-3)
    p.add_argument("--polish-lr-translation", type=float, default=1e-1)
    p.add_argument("--polish-lr-decay", type=float, default=0.1,
                   help="exponential LR decay over the polish stage")
    return p.parse_args(argv)


def _lrs(lr_rot: float, lr_trans: float, n: int, decay: float, optimizer: str) -> dict:
    if optimizer != "lbfgs" and decay < 1.0:
        return dict(lr_rotation=exponential_decay(lr_rot, n, decay),
                    lr_translation=exponential_decay(lr_trans, n, decay))
    return dict(lr_rotation=lr_rot, lr_translation=lr_trans)


def _linesearch_steps(opt) -> Optional[Tuple[int, bool]]:
    """The step just taken's line-search evaluations and whether its step
    met the sufficient-decrease criterion (LBFGS; else None). A line search
    that fails without such a step returns its last step all the same."""
    state = getattr(opt, "state", None)
    if not hasattr(state, "num_linesearch_steps"):
        return None
    return state.num_linesearch_steps, bool(state.decrease_error == 0)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.polish_iters > 0 and not args.multiscale:
        warnings.warn(f"--polish-iters {args.polish_iters} acts only with --multiscale "
                      f"(as in the JAX CLI); no polish stage runs", stacklevel=2)
    device = "cpu" if args.cpu else None
    vs = args.volume_size
    subject = load_example_ct(shape=(vs, vs, max(16, vs // 4)), device=device)
    drr = DRR(subject, sdd=1020.0, height=args.height, delx=2.0, renderer=args.renderer,
              device=device)
    dev = drr.device
    geo = DoubleGeodesicSE3(sdd=1020.0)
    metric = MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5],
                                                    var_floor=args.var_floor)

    rot_true = torch.tensor([[0.0, np.pi / 2, 0.0]], dtype=torch.float32, device=dev)
    trans_true = torch.tensor([[0.0, 850.0, 0.0]], dtype=torch.float32, device=dev)
    pose_true = convert(rot_true, trans_true, **KW)
    with torch.no_grad():
        target = drr(rot_true, trans_true, **KW)

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    def offset(shape, scale):
        return torch.tensor(rng.normal(0, scale, shape).astype(np.float32), device=dev)

    def geodesic_mm(rot, trans):
        with torch.no_grad():
            return [v.tolist() for v in geo(pose_true, convert(rot, trans, **KW))]

    record = {"drr": drr, "target": target, "rot_true": rot_true, "trans_true": trans_true}
    opt_kw = dict(optimizer=args.optimizer, momentum=args.momentum, dampening=args.dampening)

    if args.multiscale:
        scales = tuple(float(s) for s in args.multiscale.split(","))
        if args.iters_per_scale:
            its = tuple(int(i) for i in args.iters_per_scale.split(","))
            if len(its) != len(scales):
                raise ValueError("--iters-per-scale needs one count per scale")
        else:
            its = (args.n_iters // len(scales),) * len(scales)
        # Stages: (drr, target, steps, metric, lr_rot, lr_trans, decay, label).
        stages = []
        for s, n_s in zip(scales, its):
            d_s, t_s = drr, target
            if s != 1.0:
                d_s = rescaled_drr(drr, s)
                t_s = resize_target(target, d_s.detector.height, d_s.detector.width)
            stages.append((d_s, t_s, n_s, metric, args.lr_rotation, args.lr_translation,
                           args.lr_decay, str(s)))
        if args.polish_iters > 0:
            stages.append((drr, target, args.polish_iters,
                           GradientNormalizedCrossCorrelation2d(), args.polish_lr_rotation,
                           args.polish_lr_translation, args.polish_lr_decay, "polish"))
        runners = [(make_registration_step(d_s, t_s, "euler_angles", "ZXY", metric=m_s,
                                           **_lrs(lr_r, lr_t, n_s, decay, args.optimizer),
                                           **opt_kw),
                    n_s, label)
                   for d_s, t_s, n_s, m_s, lr_r, lr_t, decay, label in stages]

        def one_run(rot0, trans0, echo=False):
            rot_c, trans_c = rot0, trans0
            scores, step_ms, ls_steps = [], [], []
            for (init_fn, step_fn), n_s, label in runners:
                params, opt = init_fn(rot_c, trans_c)
                clock, stage, ls = StepClock(dev), [], []
                for _ in range(n_s):
                    begin = clock.start()
                    params, opt, score = step_fn(params, opt)
                    clock.stop(begin)
                    stage.append(score)
                    ls.append(_linesearch_steps(opt))
                stage = torch.stack(stage).tolist() if stage else []
                scores.append(stage)
                step_ms.append(clock.ms())
                ls_steps.append(ls)
                rot_c, trans_c = params["rotation"].detach(), params["translation"].detach()
                if echo and stage:
                    print(f"    scale {label}: {geodesic_mm(rot_c, trans_c)[2][0]:8.3f} mm, "
                          f"score {stage[0]:.4f} -> {stage[-1]:.4f}", flush=True)
            return rot_c, trans_c, scores, step_ms, ls_steps

        # A warm-up run, as the JAX CLI's (there it compiles every scale).
        one_run(rot_true + 1e-3, trans_true + 1e-2)

        iters_total = sum(its) + args.polish_iters
        runs, summary = [], []
        for run in range(args.n_runs):
            rot0 = rot_true + offset((1, 3), 0.06)
            trans0 = trans_true + offset((1, 3), 12.0)
            t0 = time.perf_counter()
            rot_f, trans_f, scores, step_ms, ls_steps = one_run(rot0, trans0, echo=True)
            elapsed = time.perf_counter() - t0
            start_mm = geodesic_mm(rot0, trans0)[2][0]
            final_mm = geodesic_mm(rot_f, trans_f)[2][0]
            summary.append([run, final_mm < CONVERGED_MM, iters_total, final_mm,
                            iters_total / elapsed])
            runs.append(dict(rotation0=rot0, translation0=trans0, rotation=rot_f,
                             translation=trans_f, start_mm=start_mm, final_mm=final_mm,
                             scores=scores, step_ms=step_ms, seconds=elapsed,
                             linesearch_steps=ls_steps))
            print(f"run {run:3d}: {'converged' if final_mm < CONVERGED_MM else 'FAILED '}"
                  f" final {final_mm:8.3f} mm, {iters_total / elapsed:6.1f} it/s", flush=True)
        with open(outdir / "multiscale_summary.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["run", "converged", "iters", "final_mm", "iters_per_s"])
            w.writerows(summary)
        n_conv = sum(1 for s in summary if s[1])
        print(f"converged {n_conv}/{args.n_runs} (scales {scales}, iters {its}, lr_decay "
              f"{args.lr_decay}, polish {args.polish_iters})", flush=True)
        return dict(record, mode="multiscale", runs=runs,
                    stages=[label for _, _, label in runners])

    if args.multistart:
        rots = rot_true + offset((args.n_runs, 3), 0.06)
        transs = trans_true + offset((args.n_runs, 3), 12.0)
        ms_kw = dict(n_iters=args.n_iters, metric=metric, lr_rotation=args.lr_rotation,
                     lr_translation=args.lr_translation, **opt_kw)
        # One same-shape warm-up, perturbed, as the JAX CLI's.
        optimize_multistart(drr, target, rots + 1e-3, transs, "euler_angles", "ZXY", **ms_kw)
        t0 = time.perf_counter()
        rots_f, transs_f, scores, trace = optimize_multistart(drr, target, rots, transs,
                                                              "euler_angles", "ZXY", **ms_kw)
        scores = scores.tolist()
        elapsed = time.perf_counter() - t0
        double_geo = geodesic_mm(rots_f, transs_f)[2]
        with open(outdir / "multistart.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["run", "final_score", "double_geodesic_mm"])
            for i in range(args.n_runs):
                w.writerow([i, scores[i], double_geo[i]])
        n_conv = sum(1 for d in double_geo if d < CONVERGED_MM)
        total_iters = args.n_runs * args.n_iters
        print(f"multistart: {args.n_runs} restarts x {args.n_iters} iters in {elapsed:.1f} s "
              f"({total_iters / elapsed:.1f} pose-iters/s), best {max(scores):.4f}, "
              f"converged {n_conv}/{args.n_runs}", flush=True)
        return dict(record, mode="multistart", rotation0=rots, translation0=transs,
                    rotations=rots_f, translations=transs_f, final_scores=scores,
                    final_mm=double_geo, trace=trace.tolist(), seconds=elapsed)

    init_fn, step_fn = make_registration_step(drr, target, "euler_angles", "ZXY", metric=metric,
                                              lr_rotation=args.lr_rotation,
                                              lr_translation=args.lr_translation, **opt_kw)
    runs, summary = [], []
    for run in range(args.n_runs):
        rot0 = rot_true + offset((1, 3), 0.06)
        trans0 = trans_true + offset((1, 3), 12.0)
        params, opt = init_fn(rot0, trans0)
        rows, converged_at, clock, ls_steps = [], None, StepClock(dev), []
        t0 = time.perf_counter()
        for it in range(args.n_iters):
            begin = clock.start()
            params, opt, score = step_fn(params, opt)
            clock.stop(begin)
            ls_steps.append(_linesearch_steps(opt))
            rot_geo, xyz_geo, double_geo = geodesic_mm(params["rotation"], params["translation"])
            rows.append([it, float(score), rot_geo[0], xyz_geo[0], double_geo[0],
                         time.perf_counter() - t0])
            if double_geo[0] < CONVERGED_MM:
                converged_at = it
                break
        with open(outdir / f"run_{run:03d}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["iter", "score", "rot_geodesic_mm", "xyz_geodesic_mm",
                        "double_geodesic_mm", "elapsed_s"])
            w.writerows(rows)
        final = rows[-1]
        iters_per_s = (final[0] + 1) / final[5] if final[5] > 0 else 0.0
        summary.append([run, converged_at is not None, final[0] + 1, final[4], iters_per_s])
        runs.append(dict(rotation0=rot0, translation0=trans0,
                         rotation=params["rotation"].detach(),
                         translation=params["translation"].detach(),
                         start_mm=geodesic_mm(rot0, trans0)[2][0], final_mm=final[4],
                         scores=[r[1] for r in rows], step_ms=clock.ms(), seconds=final[5],
                         linesearch_steps=ls_steps))
        print(f"run {run:3d}: {'converged' if converged_at is not None else 'max-iters'}"
              f" after {final[0] + 1:4d} iters, final {final[4]:8.3f} mm,"
              f" {iters_per_s:6.1f} it/s", flush=True)
    with open(outdir / "summary.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run", "converged", "iters", "final_mm", "iters_per_s"])
        w.writerows(summary)
    n_conv = sum(1 for s in summary if s[1])
    print(f"converged {n_conv}/{args.n_runs}", flush=True)
    return dict(record, mode="serial", runs=runs)


if __name__ == "__main__":
    main()
