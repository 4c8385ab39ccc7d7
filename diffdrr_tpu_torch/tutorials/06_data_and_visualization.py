"""Data pipeline and visualization: HU physics, structures, meshes, movies.

The port's walk through the reference's ``metamorphasis.ipynb`` (morphing
the bone attenuation multiplier), per-structure channel rendering, mesh
extraction (Surface Nets and marching cubes, this package's native C++
meshers), and optimization-trace animation. The renders run on the CUDA
card (``--cpu``: on the CPU); the meshes are made on the host.

Run:  python diffdrr_tpu_torch/tutorials/06_data_and_visualization.py [--cpu]
"""

import importlib.util
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from diffdrr_tpu_torch import DRR, convert, load_example_ct

DEVICE = "cpu" if "--cpu" in sys.argv else None
KW = dict(parameterization="euler_angles", convention="ZXY")

# ---------------------------------------------------------------------------
# 1. The HU -> density transfer. CT scans store Hounsfield units; rendering
# wants linear attenuation. `read`/`load_example_ct` apply a 3-segment
# piecewise map (air / soft tissue / bone; the native C++ transfer, with a
# NumPy route beside it), and `bone_attenuation_multiplier` morphs the bone
# contribution: the reference's "metamorphasis" knob.
# ---------------------------------------------------------------------------
H = 48
imgs = {}
for bam in [0.5, 1.0, 2.0]:
    subject = load_example_ct(shape=(48, 48, 24), bone_attenuation_multiplier=bam,
                              device=DEVICE)
    drr = DRR(subject, sdd=1020.0, height=H, delx=8.0, device=DEVICE)
    rot = torch.tensor([[0.0, np.pi / 2, 0.0]], device=drr.device)
    trans = torch.tensor([[0.0, 850.0, 0.0]], device=drr.device)
    imgs[bam] = drr(rot, trans, **KW)[0, 0].cpu().numpy()
    contrast = imgs[bam].max() / imgs[bam].mean()
    print(f"bone_attenuation_multiplier={bam}: mean {imgs[bam].mean():.3f} "
          f"bone contrast {contrast:.1f}x")
# Densities are min-max normalized after the bone multiply (reference
# data.py:214-227), so a higher multiplier raises bone CONTRAST over soft
# tissue, not absolute intensity:
assert imgs[2.0].max() / imgs[2.0].mean() > imgs[0.5].max() / imgs[0.5].mean()

# ---------------------------------------------------------------------------
# 2. Per-structure channels. With a labelmap, `mask_to_channels=True`
# renders each structure's contribution into its own output channel
# (channel 0 = background): the basis for structure-aware losses.
# ---------------------------------------------------------------------------
subject = load_example_ct(shape=(48, 48, 24), device=DEVICE)
print("structures:", [name for _, name in subject.structures])
drr = DRR(subject, sdd=1020.0, height=H, delx=8.0, device=DEVICE)
channels = drr(rot, trans, mask_to_channels=True, **KW)
n_structures = int(subject.mask.data.max()) + 1
assert channels.shape == (1, n_structures, H, H)
total = drr(rot, trans, **KW)
torch.testing.assert_close(channels.sum(dim=1, keepdim=True), total, rtol=1e-3,
                           atol=1e-3 * float(total.max()))
print("per-structure channels sum to the full DRR: OK")

# Maximum-intensity projection (reducefn="max"): the radiologist's MIP view
# instead of the line integral; on the card the Siddon MIP kernel renders it.
mip = drr(rot, trans, reducefn="max", **KW)
assert mip.shape == total.shape
assert float(mip.max()) <= float(total.max())
print("MIP render (reducefn='max'): OK")

# ---------------------------------------------------------------------------
# 3. Meshes. Extract bone surfaces with either mesher and export OBJ:
# Surface Nets (smoothed, quad-dominant) or marching cubes (edge-exact).
# The volume comes to the host once; the meshers are native C++.
# ---------------------------------------------------------------------------
from diffdrr_tpu_torch.native import build
from diffdrr_tpu_torch.viz import drr_to_mesh, img_to_mesh, labelmap_to_mesh

build.reset_call_counts()
mesh_sn = drr_to_mesh(subject, method="surface_nets", threshold=300.0)
mesh_mc = drr_to_mesh(subject, method="marching_cubes", threshold=300.0)
print(f"surface nets: {mesh_sn.n_faces} faces; marching cubes: {mesh_mc.n_faces} faces")
assert mesh_sn.n_faces > 0 and mesh_mc.n_faces > 0
counts = build.call_counts()
print("native calls:", counts)
assert counts["surface_nets"] == counts["marching_cubes"] == counts["qem_decimate"] == 1

heart = labelmap_to_mesh(subject, labels=4)
with tempfile.TemporaryDirectory() as td:
    heart.save_obj(Path(td) / "heart.obj")
    print("OBJ export: OK")

# Camera geometry for scene display: frustum + detector plane + principal ray
pose = convert(rot, trans, **KW)
frustum, det_verts, principal = img_to_mesh(drr, pose)
assert np.allclose(frustum.vertices[0], principal[0])  # apex == source

# ---------------------------------------------------------------------------
# 4. Animating an optimization. `animation_frames` re-renders each row of a
# registration trace (a pandas DataFrame, or rows as csv.DictReader gives
# them); `animate` draws the frames with matplotlib and writes a GIF with
# imageio, where they are installed.
# ---------------------------------------------------------------------------
from diffdrr_tpu_torch.viz import animate, animation_frames

r, t = rot[0].tolist(), trans[0].tolist()
trace = [dict(zip(["r1", "r2", "r3", "tx", "ty", "tz"], [r[0] + 0.02 * k, r[1], r[2], *t]))
         for k in range(3)]
frames = animation_frames(trace, drr)
assert len(frames) == 3 and frames[0].shape == (H, H)
np.testing.assert_array_equal(frames[0], total[0, 0].cpu().numpy())
print("animation frames: OK")
if all(importlib.util.find_spec(m) for m in ("matplotlib", "imageio")):
    import matplotlib

    matplotlib.use("Agg")
    with tempfile.TemporaryDirectory() as td:
        out = animate(Path(td) / "reg.gif", trace, drr, verbose=False, **KW)
        assert out.exists() and out.stat().st_size > 0
        print("animation GIF: OK")
else:
    print("animation GIF: skipped (matplotlib or imageio not installed)")

print("tutorial 06: all checks passed")
