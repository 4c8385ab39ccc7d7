"""3D scene export: mesh post-processing and the standalone HTML viewer.

The reference's demo surface is its interactive pyvista scenes
(``visualize_scene`` + the tutorial HTML exports). Here that pipeline is
native: QEM decimation / hole filling / cleaning on the package's own Mesh
type (``diffdrr_tpu_torch.meshops``, on the host), and a self-contained
vanilla-WebGL HTML export (``diffdrr_tpu_torch.scene_html``): one file, no
external assets, opens offline in any browser with orbit / pan / zoom, a
Lambert-shaded anatomy mesh, the camera frustum, the principal ray, and the
DRR, rendered on the CUDA card (``--cpu``: on the CPU), textured onto the
detector plane.

Run:  python diffdrr_tpu_torch/tutorials/09_scene_export.py [--cpu]
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

from diffdrr_tpu_torch import DRR, convert, load_example_ct, meshops
from diffdrr_tpu_torch.scene_html import visualize_scene_html
from diffdrr_tpu_torch.viz import drr_to_mesh

DEVICE = "cpu" if "--cpu" in sys.argv else None

# ---------------------------------------------------------------------------
# 1. Mesh extraction + the reference's post-processing pipeline.
# drr_to_mesh runs: extract_largest -> smooth -> decimate (marching cubes)
# -> fill_holes -> clean (reference visualization.py:246-279). Each step is
# also available standalone in diffdrr_tpu_torch.meshops.
# ---------------------------------------------------------------------------
subject = load_example_ct(shape=(96, 96, 48), device=DEVICE)

raw = drr_to_mesh(subject, method="marching_cubes", threshold=300.0,
                  extract_largest=False, decimate_reduction=0.0, fill_hole_size=0.0)
processed = drr_to_mesh(subject, method="marching_cubes", threshold=300.0)
print(f"raw bone mesh: {raw.n_vertices} verts / {raw.n_faces} faces")
print(f"post-processed: {processed.n_vertices} verts / "
      f"{processed.n_faces} faces (decimated 25%, holes filled, cleaned)")
assert processed.n_faces < raw.n_faces

# Aggressive decimation for web export: QEM keeps the shape.
light = meshops.decimate(processed, 0.75)
print(f"75% decimated for export: {light.n_faces} faces")
assert light.n_faces < processed.n_faces

# ---------------------------------------------------------------------------
# 2. The interactive scene. One self-contained HTML file: anatomy mesh,
# camera frustum, principal ray, and the DRR image textured on the
# detector plane. Open it in any browser: no server, no internet.
# ---------------------------------------------------------------------------
drr = DRR(subject, sdd=1020.0, height=64, delx=6.0, renderer="trilinear", device=DEVICE)
pose = convert(torch.tensor([[0.0, np.pi / 2, 0.0]], device=drr.device),
               torch.tensor([[0.0, 850.0, 0.0]], device=drr.device),
               parameterization="euler_angles", convention="ZXY")

out = Path(tempfile.mkdtemp()) / "scene.html"
visualize_scene_html(drr, pose, out, threshold=300.0, max_faces=20_000)
size_kb = out.stat().st_size // 1024
print(f"wrote {out} ({size_kb} KB, self-contained)")
assert size_kb < 4096, "export unexpectedly large"
assert "http" not in out.read_text().replace("http-equiv", "")

print("tutorial 09: all checks passed")
