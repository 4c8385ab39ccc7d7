"""Introduction: rendering your first DRR.

The port's walk through the core API (the reference's ``introduction.ipynb``
+ ``trilinear.ipynb`` + ``geometry.ipynb`` ground): load a CT, build a
``DRR``, render from a pose, try all three renderers, and see how poses are
parameterized. Everything runs on the CUDA card unless ``--cpu``.

Run:  python diffdrr_tpu_torch/tutorials/01_introduction.py [--full] [--cpu] [--plot]
"""

import importlib.util
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

FULL = "--full" in sys.argv
DEVICE = "cpu" if "--cpu" in sys.argv else None

# ---------------------------------------------------------------------------
# 1. Load a CT volume.
#
# `load_example_ct` returns a Subject: density volume (HU already mapped to
# linear attenuation), world affine, a labelmap of anatomic structures, and
# fiducials; the density and labelmap are tensors on the device. Pass
# `shape=` to downsample for quick experiments. To load your own scan use
# `diffdrr_tpu_torch.read("ct.nii.gz", ...).to(device)`.
# ---------------------------------------------------------------------------
from diffdrr_tpu_torch import DRR, convert, load_example_ct

subject = load_example_ct(shape=(512, 512, 133) if FULL else (96, 96, 48), device=DEVICE)
print("volume:", subject.volume.data.shape, "spacing:", subject.volume.spacing,
      "density on", subject.density.data.device)

# ---------------------------------------------------------------------------
# 2. Build the DRR renderer.
#
# The constructor mirrors the reference (sdd = source-to-detector distance in
# mm, height/width = detector pixels, delx/dely = pixel size in mm). The
# default renderer is exact Siddon; on the card the render runs the
# hand-written CUDA kernels (built by nvcc at first use).
# ---------------------------------------------------------------------------
H = 200 if FULL else 64
drr = DRR(subject, sdd=1020.0, height=H, delx=800.0 / H, device=DEVICE)

# ---------------------------------------------------------------------------
# 3. Pose and render.
#
# Poses are SE(3) transforms built from any of 9 parameterizations. The
# canonical AP view: rotate 90 deg about X (ZXY Euler), translate the source
# 850 mm along Y.
# ---------------------------------------------------------------------------
rotations = torch.tensor([[0.0, np.pi / 2, 0.0]], device=drr.device)
translations = torch.tensor([[0.0, 850.0, 0.0]], device=drr.device)
img = drr(rotations, translations, parameterization="euler_angles", convention="ZXY")
print("siddon DRR:", tuple(img.shape), "intensity range", float(img.min()), "-",
      float(img.max()))
assert img.shape == (1, 1, H, H) and float(img.max()) > 0

# The same pose as an explicit RigidTransform object:
pose = convert(rotations, translations, parameterization="euler_angles", convention="ZXY")
img2 = drr(pose)
assert torch.allclose(img, img2)

# ---------------------------------------------------------------------------
# 4. The three renderers.
#
# * "siddon"    - exact radiological path length (reference Siddon).
# * "trilinear" - equispaced trilinear samples per ray (reference
#                 Trilinear); the kernel path takes one sample per plane
#                 at most and says so when `n_points` asks for more.
# * "joseph"    - plane-marching with in-plane bilinear weights (no
#                 reference counterpart; converges to Siddon as step ->
#                 spacing).
# ---------------------------------------------------------------------------
imgs = {}
for name, kwargs in [("siddon", {}), ("trilinear", {"n_points": 300}), ("joseph", {})]:
    d = DRR(subject, sdd=1020.0, height=H, delx=800.0 / H, renderer=name, device=DEVICE)
    imgs[name] = d(rotations, translations, parameterization="euler_angles",
                   convention="ZXY", **kwargs)[0, 0].cpu().numpy()
    print(f"{name:10s} mean intensity {imgs[name].mean():8.3f}")


def ncc(a, b):
    a = (a - a.mean()) / a.std()
    b = (b - b.mean()) / b.std()
    return float((a * b).mean())


# All three agree on the image structure:
assert ncc(imgs["siddon"], imgs["trilinear"]) > 0.99
assert ncc(imgs["siddon"], imgs["joseph"]) > 0.99
print("renderer cross-correlations > 0.99: OK")

# ---------------------------------------------------------------------------
# 5. Pose parameterizations.
#
# Every parameterization converts differentiably to SE(3): networks can
# regress any of them. Render the same physical pose from a quaternion:
# ---------------------------------------------------------------------------
quat, trans_cam = pose.convert("quaternion")
img_q = drr(quat, trans_cam, parameterization="quaternion")
assert torch.allclose(img, img_q, atol=1e-3)
print("euler == quaternion render: OK")

# ---------------------------------------------------------------------------
# 6. Batched rendering: a batch of poses renders in one call (and shards
# across devices with diffdrr_tpu_torch.parallel; see tutorial 04).
# ---------------------------------------------------------------------------
B = 4
rot_b = rotations.repeat(B, 1) + 0.05 * torch.arange(B, device=drr.device)[:, None]
trans_b = translations.repeat(B, 1)
batch = drr(rot_b, trans_b, parameterization="euler_angles", convention="ZXY")
assert batch.shape == (B, 1, H, H)
print("batched render:", tuple(batch.shape))

if "--plot" in sys.argv:
    if importlib.util.find_spec("matplotlib"):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from diffdrr_tpu_torch.viz import plot_drr

        plot_drr(batch, title=[f"pose {i}" for i in range(B)])
        out = Path(__file__).with_name("tutorial01_drrs.png")
        plt.savefig(out, dpi=120)
        print(f"wrote {out}")
    else:
        print("plot: skipped (matplotlib not installed)")

print("tutorial 01: all checks passed")
