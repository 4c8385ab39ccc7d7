"""Train a CNN pose regressor on DRRs rendered on the fly.

Counterpart of ``experiments/pose_regressor.py`` (the JAX package's
trainer), with the same flags and defaults, on ``argparse``: each step draws
``--batch-size`` random poses about the bench pose (rotation
``[0, pi/2, 0] + N(0, 0.1)`` rad, translation ``[0, 850, 0] + N(0, 15)``
mm, ZXY Euler angles), renders them in one batch with the trilinear
renderer (no gradient reaches the renderer), normalises each image to zero
mean and unit standard deviation, and takes one Adam step of
``PoseRegressor`` (the "small" preset) on the squared Frobenius rotation
error plus 1e-4 times the squared translation error.

    python -m diffdrr_tpu_torch.experiments.pose_regressor            # on the card
    python -m diffdrr_tpu_torch.experiments.pose_regressor --cpu --volume-size 32 \\
        --height 16 --batch-size 2 --n-steps 4 --ckpt-dir "$(mktemp -d)" --ckpt-every 2

The weights start from ``torch.Generator`` seed 0 and the poses are drawn
from a CPU generator of seed 1 (the JAX script's ``PRNGKey(0)`` and
``PRNGKey(1)``), then moved to the device. With ``--ckpt-dir`` it resumes from
the newest checkpoint there (the model, Adam and the pose generator's
state) and saves every ``--ckpt-every`` steps, keeping two. It runs on the
CUDA card unless ``--cpu``. ``main(argv)`` returns the run's record: the
losses, the step it started at, the steps, the per-step times (CUDA events
on the card, the host clock on the CPU), the seconds, the model and the DRR.
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
from ..pose import convert
from ..registration import PoseRegressor

__all__ = ["parse_args", "main", "sample_batch", "loss_fn"]

KW = dict(parameterization="euler_angles", convention="ZXY")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action=argparse.BooleanOptionalAction, default=False,
                   help="run on the CPU instead of the CUDA card")
    p.add_argument("--n-steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--volume-size", type=int, default=96)
    p.add_argument("--parameterization", default="rotation_6d")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory; resumes from the latest step")
    p.add_argument("--ckpt-every", type=int, default=50)
    return p.parse_args(argv)


def sample_batch(drr: DRR, generator: torch.Generator, batch_size: int):
    """``batch_size`` random poses about the bench pose, rendered in one
    batch and normalised per image: ``(images, true pose)``."""
    dev = drr.device
    drot = 0.1 * torch.randn(batch_size, 3, generator=generator)
    dtrans = 15.0 * torch.randn(batch_size, 3, generator=generator)
    rot = torch.tensor([[0.0, np.pi / 2, 0.0]]) + drot
    trans = torch.tensor([[0.0, 850.0, 0.0]]) + dtrans
    rot, trans = rot.to(dev), trans.to(dev)
    with torch.no_grad():
        imgs = drr(rot, trans, **KW)
        mu = imgs.mean(dim=(1, 2, 3), keepdim=True)
        sd = imgs.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-6
    return (imgs - mu) / sd, convert(rot, trans, **KW)


def loss_fn(model: PoseRegressor, imgs: torch.Tensor, pose_true) -> torch.Tensor:
    """Mean over the batch of the squared Frobenius rotation error plus
    1e-4 times the squared translation error."""
    pose_pred = model(imgs)
    dR = torch.sum((pose_pred.rotation - pose_true.rotation) ** 2, dim=(1, 2))
    dt = torch.sum((pose_pred.translation - pose_true.translation) ** 2, dim=1)
    return torch.mean(dR + 1e-4 * dt)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    vs = args.volume_size
    subject = load_example_ct(shape=(vs, vs, max(16, vs // 4)), device=device)
    drr = DRR(subject, sdd=1020.0, height=args.height, delx=3.0, renderer="trilinear",
              device=device)
    dev = drr.device
    model = PoseRegressor(args.parameterization, model_name="small",
                          generator=torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    poses = torch.Generator().manual_seed(1)

    def state():
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "generator": poses.get_state()}

    mgr, start = None, 0
    if args.ckpt_dir is not None:
        mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2)
        resumed = mgr.latest(like=state())
        if resumed is not None:
            start, saved = resumed
            model.load_state_dict(saved["model"])
            opt.load_state_dict(saved["opt"])
            poses.set_state(saved["generator"])
            print(f"resumed from step {start} in {args.ckpt_dir}", flush=True)

    losses, clock = [], StepClock(dev)
    t0 = time.perf_counter()
    for it in range(start, args.n_steps):
        begin = clock.start()
        imgs, pose_true = sample_batch(drr, poses, args.batch_size)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, imgs, pose_true)
        loss.backward()
        opt.step()
        clock.stop(begin)
        losses.append(loss.detach())
        if it % 20 == 0 or it == args.n_steps - 1:
            print(f"step {it:4d}  loss {float(loss):.4f}", flush=True)
        if mgr is not None:
            mgr.maybe_save(it + 1, state(), every=args.ckpt_every)
    losses = torch.stack(losses).tolist() if losses else []
    elapsed = time.perf_counter() - t0
    ran = max(1, args.n_steps - start)
    print(f"done in {elapsed:.1f} s ({ran / elapsed:.2f} steps/s)", flush=True)
    return dict(losses=losses, start=start, steps=len(losses), step_ms=clock.ms(),
                seconds=elapsed, model=model, drr=drr)


if __name__ == "__main__":
    main()
