"""Gradient-free registration baseline with scipy.optimize.

Counterpart of ``experiments/reg_scipy.py`` (the JAX package's script), with
the same flags and defaults, on ``argparse``: recover the bench pose of the
example CT from random starts by Nelder-Mead or Powell on the negated global
NCC of a forward-only render (one render, no gradient, per function
evaluation), the classical baseline that differentiable rendering beats.

    python -m diffdrr_tpu_torch.experiments.reg_scipy                 # on the card
    python -m diffdrr_tpu_torch.experiments.reg_scipy --cpu --volume-size 32 \\
        --height 16 --n-runs 2 --maxiter 10

Each run starts at the truth plus ``N(0, 0.06)`` rad and ``N(0, 12)`` mm,
drawn from ``np.random.default_rng(seed)`` in the JAX script's order, and
prints its method, function evaluations, final double geodesic and seconds.
It runs on the CUDA card unless ``--cpu``. ``main(argv)`` returns the
record: each run's start, final parameters, nfev, final double geodesic in
mm and seconds, and the DRR and target.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import scipy.optimize
import torch

from ..data import load_example_ct
from ..drr import DRR
from ..metrics import DoubleGeodesicSE3, NormalizedCrossCorrelation2d
from ..pose import convert

__all__ = ["parse_args", "main"]

KW = dict(parameterization="euler_angles", convention="ZXY")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action=argparse.BooleanOptionalAction, default=False,
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--n-runs", type=int, default=5)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--volume-size", type=int, default=128)
    p.add_argument("--method", default="Nelder-Mead", choices=["Nelder-Mead", "Powell"])
    p.add_argument("--maxiter", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    vs = args.volume_size
    subject = load_example_ct(shape=(vs, vs, max(16, vs // 4)), device=device)
    drr = DRR(subject, sdd=1020.0, height=args.height, delx=2.0, renderer="trilinear",
              device=device)
    dev = drr.device
    metric = NormalizedCrossCorrelation2d()
    geo = DoubleGeodesicSE3(sdd=1020.0)

    rot_true = np.array([0.0, np.pi / 2, 0.0], np.float32)
    trans_true = np.array([0.0, 850.0, 0.0], np.float32)

    def as_pose(x):
        return (torch.tensor(np.asarray(x[:3], np.float32)[None], device=dev),
                torch.tensor(np.asarray(x[3:], np.float32)[None], device=dev))

    with torch.no_grad():
        target = drr(*as_pose(np.concatenate([rot_true, trans_true])), **KW)
    pose_true = convert(*as_pose(np.concatenate([rot_true, trans_true])), **KW)

    def objective(x):
        with torch.no_grad():
            return float(-torch.mean(metric(drr(*as_pose(x), **KW), target)))

    rng = np.random.default_rng(args.seed)
    runs = []
    for run in range(args.n_runs):
        x0 = np.concatenate([rot_true + rng.normal(0, 0.06, 3),
                             trans_true + rng.normal(0, 12.0, 3)])
        t0 = time.perf_counter()
        res = scipy.optimize.minimize(objective, x0, method=args.method,
                                      options={"maxiter": args.maxiter})
        with torch.no_grad():
            err = float(geo(pose_true, convert(*as_pose(res.x), **KW))[2][0])
        elapsed = time.perf_counter() - t0
        runs.append(dict(x0=x0, x=res.x, nfev=int(res.nfev), final_mm=err, seconds=elapsed))
        print(f"run {run}: {args.method} nfev={res.nfev} final={err:8.3f} mm"
              f" ({elapsed:.1f} s)", flush=True)
    return dict(runs=runs, drr=drr, target=target)


if __name__ == "__main__":
    main()
