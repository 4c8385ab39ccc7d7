"""Registration loss landscapes: image similarity vs pose perturbation.

The reference's ``metrics.ipynb`` tutorial simulates hundreds of moving
DRRs one at a time in a Python loop to map how multiscale NCC behaves
around the true pose. Here the sweep is a single *batched* render: poses
are a leading batch axis, so a whole line of perturbations renders in one
call (on the card, one kernel launch). Reproduces the reference's findings:

  * the landscape is locally convex in all six pose parameters, and
  * depth translation (y, the source-to-isocenter axis) is nearly flat:
    mNCC can barely disambiguate camera depth (the residual error axis in
    every registration experiment).

Run:  python diffdrr_tpu_torch/tutorials/08_loss_landscapes.py [--full] [--cpu] [--plot]
"""

import importlib.util
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

FULL = "--full" in sys.argv
DEVICE = "cpu" if "--cpu" in sys.argv else None

from diffdrr_tpu_torch import DRR, load_example_ct
from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d

# ---------------------------------------------------------------------------
# 1. Target: a DRR at a known ground-truth pose.
# ---------------------------------------------------------------------------
subject = load_example_ct(shape=(512, 512, 133) if FULL else (96, 96, 48), device=DEVICE)
H = 100 if FULL else 48
drr = DRR(subject, sdd=1020.0, height=H, delx=800.0 / H, renderer="trilinear", device=DEVICE)
dev = drr.device

rot_true = np.array([0.0, np.pi / 2, 0.0])
trans_true = np.array([0.0, 850.0, 0.0])
KW = dict(parameterization="euler_angles", convention="ZXY", n_points=150)
with torch.no_grad():
    target = drr(torch.tensor(rot_true[None], dtype=torch.float32, device=dev),
                 torch.tensor(trans_true[None], dtype=torch.float32, device=dev), **KW)

metric = MultiscaleNormalizedCrossCorrelation2d([None, 9], [0.5, 0.5])

# ---------------------------------------------------------------------------
# 2. One batched render per parameter line: perturb a single pose component
# across N values and score every frame against the target in one call.
# ---------------------------------------------------------------------------
N = 21 if FULL else 13
ANGLE_SPAN = 0.35  # radians, ~20 degrees
MM_SPAN = 15.0


@torch.no_grad()
def score(poses):
    imgs = drr(poses[:, :3], poses[:, 3:], **KW)
    return metric(target.expand_as(imgs), imgs)


def line_scores(param_idx):
    offs = torch.linspace(-1.0, 1.0, N, device=dev)
    span = ANGLE_SPAN if param_idx < 3 else MM_SPAN
    base = torch.tensor(np.concatenate([rot_true, trans_true]), dtype=torch.float32,
                        device=dev)
    poses = base.repeat(N, 1)
    poses[:, param_idx] += offs * span
    return score(poses).reshape(N).cpu().numpy()


names = ["alpha", "beta", "gamma", "x", "y (depth)", "z"]
scores = [line_scores(i) for i in range(6)]

center = N // 2
print(f"{'param':12s} {'peak idx':>8s} {'score range':>12s}")
ranges = []
for name, s in zip(names, scores):
    rng = float(s.max() - s.min())
    ranges.append(rng)
    print(f"{name:12s} {int(np.argmax(s)):8d} {rng:12.4f}")

# ---------------------------------------------------------------------------
# 3. The reference's two findings, as assertions.
# ---------------------------------------------------------------------------
# (a) Locally convex: the true pose is the best (or adjacent to it: the
# sweep grid is coarse) along every axis.
for name, s in zip(names, scores):
    peak = int(np.argmax(s))
    assert abs(peak - center) <= 1, (name, peak)
    # and the score decays toward both edges
    assert s[0] < s[peak] and s[-1] < s[peak], name

# (b) Depth (y) is the flattest translation axis by a wide margin.
assert ranges[4] < 0.3 * ranges[3], (ranges[3], ranges[4])
assert ranges[4] < 0.3 * ranges[5], (ranges[5], ranges[4])
print(f"depth flatness: y range {ranges[4]:.4f} vs x {ranges[3]:.4f} / z {ranges[5]:.4f}")

# ---------------------------------------------------------------------------
# 4. Optional: the landscape plots (matplotlib, where it is installed).
# ---------------------------------------------------------------------------
if "--plot" in sys.argv:
    if importlib.util.find_spec("matplotlib"):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(2, 3, figsize=(12, 6))
        for ax, name, s in zip(axs.ravel(), names, scores):
            ax.plot(np.linspace(-1, 1, N), s)
            ax.set_title(name)
            ax.axvline(0.0, color="k", lw=0.5)
        fig.suptitle("mNCC loss landscape around the true pose")
        out = Path(__file__).with_suffix(".png")
        fig.savefig(out, dpi=80)
        print(f"wrote {out}")
    else:
        print("plot: skipped (matplotlib not installed)")

print("tutorial 08: all checks passed")
