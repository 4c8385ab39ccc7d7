"""Geometry: poses, the C-arm camera model, and projection round trips.

The reference's ``geometry.ipynb`` ground on the port: how SE(3) poses are
parameterized and composed, how the detector turns a pose into rays, and
how to move between DRR conventions and standard computer-vision pinhole
cameras (for NeRF/3DGS-style pipelines). Runs on the CUDA card unless
``--cpu``.

Run:  python diffdrr_tpu_torch/tutorials/05_geometry.py [--cpu]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from diffdrr_tpu_torch import DRR, convert, load_example_ct
from diffdrr_tpu_torch.pose import PARAMETERIZATIONS

DEVICE = "cpu" if "--cpu" in sys.argv else None

# ---------------------------------------------------------------------------
# 1. Poses. `convert` builds a RigidTransform from any of 9 rotation
# parameterizations. Translations follow the reference's camera-center
# convention: the stored matrix translation is R @ t.
# ---------------------------------------------------------------------------
subject = load_example_ct(shape=(48, 48, 24), device=DEVICE)
H = 32
drr = DRR(subject, sdd=1020.0, height=H, delx=8.0, device=DEVICE)
dev = drr.device

rot = torch.tensor([[0.1, np.pi / 2, -0.05]], device=dev)
trans = torch.tensor([[10.0, 850.0, -20.0]], device=dev)
pose = convert(rot, trans, parameterization="euler_angles", convention="ZXY")
print("pose matrix:\n", pose.matrix[0].cpu().numpy().round(3))

# Round-trip through every parameterization: convert out, convert back in,
# recover the same SE(3) matrix.
for param in PARAMETERIZATIONS:
    conv = "ZXY" if param == "euler_angles" else None
    r, t = pose.convert(param, convention=conv)
    back = convert(r, t, parameterization=param, convention=conv)
    err = float((back.matrix - pose.matrix).abs().max())
    print(f"  {param:22s} round-trip max err {err:.2e}")
    assert err < 5e-3, param  # float32 at ~850 mm translations

# Composition, inverse, and application to points:
delta = convert(torch.tensor([[0.01, 0.0, 0.0]], device=dev), torch.zeros(1, 3, device=dev),
                parameterization="axis_angle")
composed = pose.compose(delta)
identity = composed.compose(composed.inverse())
err = (identity.matrix - torch.eye(4, device=dev)).abs()[0]
print(f"pose @ pose^-1 - I: rotation {float(err[:3, :3].max()):.2e}, "
      f"translation {float(err[:3, 3].max()):.2e} mm")
# The translation cancels ~850 mm terms, where a float32 ulp is 6.1e-5 mm:
# a few ulps, in whatever order the device sums them.
assert float(err[:3, :3].max()) < 1e-5 and float(err[:3, 3].max()) < 4 * 6.1e-5
pts = torch.tensor([[[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]]], device=dev)
print("pose applied to points:", pose(pts)[0].cpu().numpy().round(2))

# ---------------------------------------------------------------------------
# 2. The C-arm detector. A DRR owns a Detector: source at the origin of the
# canonical frame, detector plane sdd away, pixels delx/dely mm. The pose
# maps the canonical frame into world space.
# ---------------------------------------------------------------------------
source, target = drr.detector(pose, None)
print("source:", source[0, 0].cpu().numpy().round(2),
      "detector center:", target[0].mean(0).cpu().numpy().round(2))
# Principal ray length == source-to-detector distance:
center = target[0].reshape(H, H, 3)[H // 2 - 1:H // 2 + 1, H // 2 - 1:H // 2 + 1].mean((0, 1))
assert abs(float(torch.linalg.vector_norm(center - source[0, 0])) - 1020.0) < drr.detector.delx
print("principal ray length == sdd: OK")

# ---------------------------------------------------------------------------
# 3. Projection round trip: world points -> pixels -> world. The DRR's
# perspective_projection/inverse_projection implement the reference's
# pixel conventions exactly (drr.py:269-312).
# ---------------------------------------------------------------------------
world = torch.as_tensor(subject.fiducials, dtype=torch.float32, device=dev)  # (1, n, 3)
pix = drr.perspective_projection(pose, world)
back = drr.inverse_projection(pose, pix)
# inverse_projection returns points ON the detector plane along each ray;
# they must project back to the same pixels.
pix2 = drr.perspective_projection(pose, back)
err = float((pix - pix2).abs().max())
print(f"pixel -> world -> pixel round trip err {err:.2e}")
assert err < 1e-2

# ---------------------------------------------------------------------------
# 4. The pinhole-camera bridge: recover standard CV intrinsics/extrinsics
# (K, R|t) for any DRR view, the interop path to NeRF/3DGS pipelines.
# ---------------------------------------------------------------------------
from diffdrr_tpu_torch.utils import get_pinhole_camera

cam = get_pinhole_camera(drr, pose)
center = np.asarray(cam.center).ravel()
src = source[0, 0].cpu().numpy()
print("pinhole camera center vs ray source:", center.round(2), src.round(2))
assert np.abs(center - src).max() < 1.0

print("tutorial 05: all checks passed")
