"""2D/3D registration: recovering a camera pose from one X-ray.

The flagship workload (the reference's ``registration.ipynb`` +
``metrics.ipynb``) on the port: render a synthetic target X-ray at an
unknown pose, start from a perturbed initial guess, and drive the pose by
gradient ascent on image similarity until the estimate is within
millimetres. On the card each step is one fused forward-and-pose-gradient
kernel; ``--cpu`` runs the kernels' plain versions.

Run:  python diffdrr_tpu_torch/tutorials/02_registration.py [--full] [--cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

FULL = "--full" in sys.argv
DEVICE = "cpu" if "--cpu" in sys.argv else None

from diffdrr_tpu_torch import DRR, convert, load_example_ct
from diffdrr_tpu_torch.metrics import (
    DoubleGeodesicSE3,
    GradientNormalizedCrossCorrelation2d,
    MultiscaleNormalizedCrossCorrelation2d,
    MutualInformation,
    NormalizedCrossCorrelation2d,
)
from diffdrr_tpu_torch.registration import optimize, optimize_multistart, optimize_until

KW = dict(parameterization="euler_angles", convention="ZXY")

# ---------------------------------------------------------------------------
# 1. The problem: a ground-truth pose renders a target image; we only get the
# image and must recover the pose. Use the trilinear renderer with a modest
# n_points: fast forward/backward, smooth gradients. Its kernel path takes
# at most one sample per plane unless allow_oversample=True, which honours
# n_points literally (the reference's semantics): at this small detector
# the 200 samples matter, and 80 Adam steps end ~7 mm from the truth with
# them against ~17 mm (mostly rotation) with one sample per plane.
# ---------------------------------------------------------------------------
SAMPLES = dict(n_points=200, allow_oversample=True)
subject = load_example_ct(shape=(512, 512, 133) if FULL else (96, 96, 48), device=DEVICE)
H = 128 if FULL else 48
drr = DRR(subject, sdd=1020.0, height=H, delx=800.0 / H, renderer="trilinear", device=DEVICE)
dev = drr.device

rot_true = torch.tensor([[0.05, np.pi / 2 + 0.03, -0.02]], device=dev)
trans_true = torch.tensor([[10.0, 850.0, -5.0]], device=dev)
with torch.no_grad():
    target = drr(rot_true, trans_true, **SAMPLES, **KW)
pose_true = convert(rot_true, trans_true, **KW)

# ---------------------------------------------------------------------------
# 2. Image similarity metrics. All of the reference's losses are available;
# multiscale NCC is the standard registration objective.
# ---------------------------------------------------------------------------
rot0 = rot_true + torch.tensor([[0.03, -0.03, 0.02]], device=dev)
trans0 = trans_true + torch.tensor([[8.0, -6.0, 7.0]], device=dev)
with torch.no_grad():
    moving = drr(rot0, trans0, **SAMPLES, **KW)


def norm01(x):
    # MutualInformation (like the reference's kornia histograms) expects
    # [0, 1]-range images; NCC variants are scale-invariant already.
    return (x - x.min()) / (x.max() - x.min())


for name, metric, prep in [
    ("NCC", NormalizedCrossCorrelation2d(), lambda x: x),
    ("multiscale NCC", MultiscaleNormalizedCrossCorrelation2d([None, 9], [0.5, 0.5]),
     lambda x: x),
    ("gradient NCC", GradientNormalizedCrossCorrelation2d(), lambda x: x),
    # MI magnitudes are small on background-dominated X-rays (the histogram
    # is one big air peak); what matters for registration is the ordering.
    ("mutual information", MutualInformation(sigma=0.01), norm01),
]:
    a, b = prep(target), prep(moving)
    print(f"{name:20s} target-vs-init {float(metric(a, b).squeeze()): .4f}  "
          f"target-vs-target {float(metric(a, a).squeeze()): .4f}")

# Pose-space error in millimetres (rotation geodesic scaled to the detector
# arm + translation distance): the convergence criterion.
geo = DoubleGeodesicSE3(sdd=1020.0)
d0 = float(geo(pose_true, convert(rot0, trans0, **KW))[2][0])
print(f"initial double-geodesic error: {d0:.1f} mm")

# ---------------------------------------------------------------------------
# 3. Iterative registration. `optimize` steps one render, backward and
# optimizer step at a time and reads the scores back once, at the end.
# Split learning rates for rotation/translation, like the reference's
# experiments. Optimizers: "adam", "sgd" (momentum/dampening), "lbfgs".
# ---------------------------------------------------------------------------
rot, trans, trace = optimize(drr, target, rot0, trans0, "euler_angles", "ZXY",
                             n_iters=150 if FULL else 80, optimizer="adam",
                             lr_rotation=2e-3, lr_translation=5e-1, **SAMPLES)
d_adam = float(geo(pose_true, convert(rot, trans, **KW))[2][0])
print(f"adam:  NCC {trace[0]:.4f} -> {trace[-1]:.4f}, error {d0:.1f} -> "
      f"{d_adam:.1f} mm in {len(trace)} iters")
assert trace[-1] > trace[0] and d_adam < d0 / 3

# ---------------------------------------------------------------------------
# 4. LBFGS refinement: second-order steps shine near the optimum (far from
# it, the mixed radian/millimetre parameter scales make line searches
# overshoot; the reference experiments see the same). The standard pattern
# is coarse Adam -> LBFGS polish.
# ---------------------------------------------------------------------------
rot_l, trans_l, trace_l = optimize(drr, target, rot, trans, "euler_angles", "ZXY",
                                   n_iters=15, optimizer="lbfgs", **SAMPLES)
d_lbfgs = float(geo(pose_true, convert(rot_l, trans_l, **KW))[2][0])
print(f"lbfgs polish: NCC {trace_l[0]:.4f} -> {trace_l[-1]:.4f}, error "
      f"{d_adam:.1f} -> {d_lbfgs:.1f} mm in {len(trace_l)} iters")
assert trace_l[-1] >= trace[-1] - 1e-4

# ---------------------------------------------------------------------------
# 5. Run-to-convergence: `optimize_until` stops at the first step whose
# double geodesic to the true pose is at or below the tolerance. (In a real
# workload you do not know the true pose; here it demonstrates the
# reference experiments' "double geodesic < threshold" protocol.)
# ---------------------------------------------------------------------------
tol, max_iters = (3.0, 300) if FULL else (8.0, 150)
rot_u, trans_u, n_used, d_final = optimize_until(
    drr, target, rot0, trans0, "euler_angles", "ZXY", true_pose=pose_true, tol_mm=tol,
    max_iters=max_iters, optimizer="adam", lr_rotation=2e-3, lr_translation=5e-1,
    **SAMPLES)
print(f"optimize_until: {n_used} iters, final error {d_final:.2f} mm")
assert d_final < tol or n_used == max_iters

# ---------------------------------------------------------------------------
# 6. Random restarts, batched. The reference's experiments loop over random
# initializations one at a time; here the restarts are a batch axis:
# `optimize_multistart` renders all N candidate poses per iteration in ONE
# call, and (elementwise optimizer + summed per-restart loss) is exactly N
# independent optimizations.
# ---------------------------------------------------------------------------
offsets_r = torch.tensor([[0.02, -0.02, 0.01], [-0.06, 0.05, -0.04], [0.10, 0.08, -0.09]],
                         device=dev)
offsets_t = torch.tensor([[5.0, -4.0, 3.0], [-12.0, 9.0, -8.0], [20.0, -15.0, 18.0]],
                         device=dev)
rots_ms, transs_ms, scores_ms, _ = optimize_multistart(
    drr, target, rot_true + offsets_r, trans_true + offsets_t, "euler_angles", "ZXY",
    n_iters=60 if FULL else 40, lr_rotation=2e-3, lr_translation=5e-1, **SAMPLES)
best = int(torch.argmax(scores_ms))
d_best = float(geo(pose_true, convert(rots_ms[best:best + 1], transs_ms[best:best + 1],
                                      **KW))[2][0])
print(f"multistart: scores {np.round(scores_ms.cpu().numpy(), 3)}, winner {best} at "
      f"{d_best:.1f} mm")
assert float(scores_ms[best]) >= float(scores_ms.max()) - 1e-6

print("tutorial 02: all checks passed")
