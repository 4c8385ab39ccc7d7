"""Differentiable CT reconstruction: optimizing voxel densities.

The reference's ``reconstruction.ipynb`` workload on the port: DRRs are
differentiable with respect to the *volume* too, so given X-rays from known
poses the densities can be recovered by gradient descent on the
re-rendering error. This is why ``DRR.render`` takes the density as an
explicit argument rather than always reading the stored one: the
optimization parameter flows through that seam. On the card each step is
one forward kernel and one density-gradient (scatter) kernel.

Run:  python diffdrr_tpu_torch/tutorials/03_reconstruction.py [--full] [--cpu]
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

FULL = "--full" in sys.argv
DEVICE = "cpu" if "--cpu" in sys.argv else None

from diffdrr_tpu_torch import DRR, convert, load_example_ct

# ---------------------------------------------------------------------------
# 1. Ground truth: the phantom CT and a ring of views around it.
# ---------------------------------------------------------------------------
shape = (96, 96, 48) if FULL else (48, 48, 24)
subject = load_example_ct(shape=shape, device=DEVICE)
H = 128 if FULL else 64
drr = DRR(subject, sdd=1020.0, height=H, delx=6.0, renderer="trilinear", device=DEVICE)
dev = drr.device

n_views = 32 if FULL else 16
angles = np.linspace(0, np.pi, n_views, endpoint=False)
rotations = torch.tensor([[float(a), np.pi / 2, 0.0] for a in angles], device=dev)
translations = torch.tensor([[0.0, 850.0, 0.0]], device=dev).repeat(n_views, 1)
pose = convert(rotations, translations, parameterization="euler_angles", convention="ZXY")

n_points = 200 if FULL else 150
with torch.no_grad():
    measured = drr(pose, n_points=n_points)
print(f"{n_views} measured views of {shape} volume:", tuple(measured.shape))

# ---------------------------------------------------------------------------
# 2. The reconstruction loop: the density grid is the parameter. Note the
# explicit-density render, `drr.render(density, source, target)`, while the
# detector geometry comes from the stored DRR. Only the density needs a
# gradient (fused_pose_bwd=False skips the pose kernels).
# ---------------------------------------------------------------------------
density_true = drr.density
density = torch.zeros_like(density_true, requires_grad=True)
with torch.no_grad():
    source, target = drr.detector(pose, None)
opt = torch.optim.Adam([density], lr=5e-2)


def loss_fn(density):
    img = drr.render(density, source, target, n_points=n_points, fused_pose_bwd=False)
    img = drr.reshape_transform(img, batch_size=n_views)
    return torch.mean((img - measured) ** 2)


n_iters = 200 if FULL else 120
losses = []
for it in range(n_iters):
    loss = loss_fn(density)
    opt.zero_grad()
    loss.backward()
    opt.step()
    with torch.no_grad():
        # Densities are physical attenuation: project onto the nonnegative cone.
        density.clamp_(min=0.0)
    losses.append(loss.detach())
    if it % max(1, n_iters // 6) == 0:
        print(f"iter {it:4d}  mse {float(losses[-1]):.5f}")
losses = torch.stack(losses).tolist()

print(f"final mse {losses[-1]:.5f} (from {losses[0]:.5f})")
assert losses[-1] < losses[0] * 0.05

# ---------------------------------------------------------------------------
# 3. How good is the recovered volume? Limited-view cone-beam reconstruction
# is underdetermined: a handful of projections constrain line integrals,
# not voxels, so expect structural agreement that improves with view count
# (and with regularizers you can add directly to `loss_fn`), not voxel
# equality.
# ---------------------------------------------------------------------------
with torch.no_grad():
    err = (density - density_true).abs()
    corr = torch.corrcoef(torch.stack([density.ravel(), density_true.ravel()]))[0, 1]
print(f"voxel correlation with ground truth: {float(corr):.3f}, mean |err| "
      f"{float(err.mean()):.4f}")
assert float(corr) > 0.4

# ---------------------------------------------------------------------------
# 4. Checkpoint / resume. Long reconstructions should checkpoint:
# `diffdrr_tpu_torch.checkpoint` writes step-indexed checkpoints atomically
# and keeps the newest few; a restore moves each tensor to its `like`
# counterpart's device. (`python -m diffdrr_tpu_torch.experiments.reconstruction
# --ckpt-dir` wires this into the CLI.)
# ---------------------------------------------------------------------------
from diffdrr_tpu_torch.checkpoint import CheckpointManager

with tempfile.TemporaryDirectory() as td:
    with CheckpointManager(td, max_to_keep=2) as mgr:
        mgr.save(n_iters, {"density": density.detach(), "opt_state": opt.state_dict()})
        mgr.wait()
        step_back, state = mgr.latest(like={"density": torch.zeros_like(density)})
    assert step_back == n_iters
    torch.testing.assert_close(state["density"], density.detach(), rtol=0, atol=0)
    opt.load_state_dict(state["opt_state"])
print("checkpoint save/restore round trip: OK")

print("tutorial 03: all checks passed")
