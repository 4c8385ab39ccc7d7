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

``--mesh`` shards the views and rays over every rank of the process group
(``parallel.make_reconstruction_step``): under ``torchrun`` the group is
``torchrun``'s (``initialize_distributed``), otherwise a world of one. The
mesh is ``(data, rays)`` with ``data`` 2 when the views and the ranks are
both even, as in the JAX CLI. Only rank 0 prints and only rank 0 writes and
reads ``--ckpt-dir``; a resumed run broadcasts rank 0's density and Adam
state, so every rank resumes from the same bits:

    torchrun --nproc-per-node 4 -m diffdrr_tpu_torch.experiments.reconstruction --mesh
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import StepClock
from ..checkpoint import CheckpointManager, _to_cpu
from ..data import load_example_ct
from ..drr import DRR
from ..parallel import initialize_distributed, make_mesh, make_reconstruction_step

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
                   help="shard views/rays across every rank of the process group")
    p.add_argument("--renderer", default="trilinear", choices=["trilinear", "joseph"])
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory; resumes from the latest step if one exists")
    p.add_argument("--ckpt-every", type=int, default=25, help="checkpoint interval (steps)")
    return p.parse_args(argv)


def _mesh_shape(n_views: int) -> tuple:
    """(data, rays) over the world: data 2 when the views and ranks are even."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = 2 if n_views % 2 == 0 and world % 2 == 0 and world > 1 else 1
    return data, world // data


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.mesh:  # before anything reaches the card: it picks each rank's card
        initialize_distributed(device=device)
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

    mesh, rank = None, 0
    if args.mesh:
        mesh = make_mesh(_mesh_shape(args.n_views), ("data", "rays"), devices=dev)
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    init_fn, step_fn = make_reconstruction_step(drr, mesh, lr=args.lr)
    density, opt = init_fn(torch.zeros_like(drr.density))

    def step(density, opt):
        return step_fn(density, opt, rot, trans, measured)

    mgr, start = None, 0
    if args.ckpt_dir is not None:
        resumed = None
        if rank == 0:
            mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2)
            resumed = mgr.latest(like={"density": density, "opt_state": opt.state_dict()})
        if mesh is not None and dist.get_world_size() > 1:  # rank 0's state, on every rank
            box = [None if resumed is None else (resumed[0], _to_cpu(resumed[1]))]
            dist.broadcast_object_list(box, src=0)
            resumed = box[0]
        if resumed is not None:
            start, state = resumed
            with torch.no_grad():
                density.copy_(state["density"])
            opt.load_state_dict(state["opt_state"])
            say(f"resumed from step {start} in {args.ckpt_dir}", flush=True)

    clock, losses = StepClock(dev), []
    t0 = time.perf_counter()
    for it in range(start, args.n_iters):
        begin = clock.start()
        density, opt, loss = step(density, opt)
        clock.stop(begin)
        losses.append(loss)
        if it % 10 == 0 or it == args.n_iters - 1:
            say(f"iter {it:4d}  mse {float(loss):.6f}", flush=True)
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
    say(f"done in {elapsed:.1f} s ({ran} steps from step {start}, "
          f"{ran / max(elapsed, 1e-9):.2f} it/s); "
          f"voxel RMSE {err:.4f} (volume RMS {base:.4f})", flush=True)
    return {"losses": torch.stack(losses).tolist() if losses else [], "rmse": err,
            "rms": base, "seconds": elapsed, "start": start, "step_ms": step_ms,
            "step": step, "state": (density, opt), "drr": drr}


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
