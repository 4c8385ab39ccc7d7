"""Differentiable CT reconstruction from multi-view DRRs, on one card.

Counterpart of ``experiments/reconstruction.py`` (the JAX package's CLI),
with the same flags and defaults, on ``argparse``: render ``--n-views``
views of the example CT on a circular trajectory, then recover the voxel
densities from zero by Adam through the renderer (trilinear by default).

    python -m diffdrr_tpu_torch.experiments.reconstruction            # on the card
    python -m diffdrr_tpu_torch.experiments.reconstruction --cpu --volume-size 32 \\
        --height 16 --n-iters 4 --ckpt-dir "$(mktemp -d)" --ckpt-every 2

It runs on the CUDA card unless ``--cpu``. With ``--ckpt-dir`` it resumes
from the newest checkpoint there and saves every ``--ckpt-every`` steps
(``diffdrr_tpu_torch.checkpoint``, keeping two); a directory that already
holds step ``--n-iters`` resumes there and runs no step, so a fresh run
needs a fresh directory. ``main(argv)`` returns the
run's record: the losses, the voxel RMSE, the seconds, the per-step times
and the step itself, so a caller can check and time them.

Not ported yet (ROADMAP.md): ``--mesh``, which shards views and rays over
several cards.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import StepClock
from ..checkpoint import CheckpointManager
from ..data import load_example_ct
from ..drr import DRR
from ..parallel import make_reconstruction_step

__all__ = ["parse_args", "main"]

KW = dict(parameterization="euler_angles", convention="ZXY")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action=argparse.BooleanOptionalAction, default=False,
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--n-views", type=int, default=8, help="number of training views")
    p.add_argument("--n-iters", type=int, default=100)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--volume-size", type=int, default=96)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=False,
                   help="shard views/rays across all devices (not ported yet)")
    p.add_argument("--renderer", default="trilinear", choices=["trilinear", "joseph"])
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory; resumes from the latest step if one exists")
    p.add_argument("--ckpt-every", type=int, default=25, help="checkpoint interval (steps)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet: it waits for the torch.distributed port of "
            "parallel/ (ROADMAP.md, queue 1: parallel/)")
    device = "cpu" if args.cpu else None
    vs = args.volume_size
    subject = load_example_ct(shape=(vs, vs, max(16, vs // 4)), device=device)
    drr = DRR(subject, sdd=1020.0, height=args.height, delx=3.0, renderer=args.renderer,
              device=device)
    dev = drr.device

    # Ground-truth views on a circular trajectory about the z-axis.
    thetas = np.linspace(0, np.pi, args.n_views, endpoint=False)
    rot = torch.tensor(np.stack([thetas, np.full_like(thetas, np.pi / 2),
                                 np.zeros_like(thetas)], axis=1),
                       dtype=torch.float32, device=dev)
    trans = torch.tensor([[0.0, 850.0, 0.0]], device=dev).repeat(args.n_views, 1)
    with torch.no_grad():
        measured = drr(rot, trans, **KW)

    init_fn, step_fn = make_reconstruction_step(drr, lr=args.lr)
    density, opt = init_fn(torch.zeros_like(drr.density))

    def step(density, opt):
        return step_fn(density, opt, rot, trans, measured)

    mgr, start = None, 0
    if args.ckpt_dir is not None:
        mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2)
        resumed = mgr.latest(like={"density": density, "opt_state": opt.state_dict()})
        if resumed is not None:
            start, state = resumed
            with torch.no_grad():
                density.copy_(state["density"])
            opt.load_state_dict(state["opt_state"])
            print(f"resumed from step {start} in {args.ckpt_dir}", flush=True)

    clock, losses = StepClock(dev), []
    t0 = time.perf_counter()
    for it in range(start, args.n_iters):
        begin = clock.start()
        density, opt, loss = step(density, opt)
        clock.stop(begin)
        losses.append(loss)
        if it % 10 == 0 or it == args.n_iters - 1:
            print(f"iter {it:4d}  mse {float(loss):.6f}", flush=True)
        if mgr is not None:
            mgr.maybe_save(it + 1, {"density": density, "opt_state": opt.state_dict()},
                           every=args.ckpt_every)
    step_ms = clock.ms()
    elapsed = time.perf_counter() - t0
    if mgr is not None:
        mgr.wait()
        mgr.close()

    with torch.no_grad():
        err = float(torch.sqrt(torch.mean((density - drr.density) ** 2)))
        base = float(torch.sqrt(torch.mean(drr.density ** 2)))
    ran = max(0, args.n_iters - start)
    print(f"done in {elapsed:.1f} s ({ran} steps from step {start}, "
          f"{ran / max(elapsed, 1e-9):.2f} it/s); "
          f"voxel RMSE {err:.4f} (volume RMS {base:.4f})", flush=True)
    return {"losses": torch.stack(losses).tolist() if losses else [], "rmse": err,
            "rms": base, "seconds": elapsed, "start": start, "step_ms": step_ms,
            "step": step, "state": (density, opt), "drr": drr}


if __name__ == "__main__":
    main()
