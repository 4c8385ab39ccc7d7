"""The benchmark's CT: the example chest phantom, made on the device from a seed.

A frozen copy of the recipe of ``diffdrr_tpu_torch.data._chest_phantom``
(air, a soft-tissue thorax, lungs, heart, spine and ribs in HU), written in
PyTorch so that a 512^3 volume is made on the card in a few calls. The seed
draws the recipe's smooth intensity variation: an 8 x 8 x 4 grid of
N(0, 12) HU, trilinearly upsampled over the volume (``scipy.ndimage.zoom``
with ``order=1``, corners on corners, as the recipe does) and added inside
the body. ``benchmark/tests`` holds this copy to the program's recipe at a
tiny size on the CPU, given the same low-resolution grid.

``hu_to_density`` is the reference's own HU -> density transfer (upstream
DiffDRR's piecewise map, min-max normalised); the program makes its density
from the same HU through its subject constructor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def chest_hu(shape, low: torch.Tensor) -> torch.Tensor:
    """The phantom's HU ``shape`` float32 volume, on ``low``'s device, with
    the intensity variation upsampled from ``low (8, 8, 4)``."""
    X, Y, Z = (int(n) for n in shape)
    kw = dict(dtype=torch.float32, device=low.device)
    x = torch.linspace(-1, 1, X, **kw)[:, None, None]
    y = torch.linspace(-1, 1, Y, **kw)[None, :, None]
    z = torch.linspace(-1, 1, Z, **kw)[None, None, :]
    hu = torch.full((X, Y, Z), -1024.0, **kw)
    inside = torch.zeros((X, Y, Z), dtype=torch.bool, device=low.device)

    body = ((x / 0.85) ** 2 + (y / 0.65) ** 2 <= 1.0) & (z.abs() <= 0.95)
    hu = torch.where(body, torch.tensor(30.0, **kw), hu)
    inside |= body
    for sx in (-0.42, 0.42):
        lung = (((x - sx) / 0.3) ** 2 + (y / 0.38) ** 2 + (z / 0.8) ** 2 <= 1.0) & body
        hu = torch.where(lung, torch.tensor(-780.0, **kw), hu)
    heart = (((x - 0.08) / 0.22) ** 2 + ((y + 0.18) / 0.25) ** 2 + (z / 0.45) ** 2 <= 1.0) & body
    hu = torch.where(heart, torch.tensor(45.0, **kw), hu)
    spine = ((x / 0.09) ** 2 + ((y - 0.45) / 0.09) ** 2 <= 1.0) & body
    hu = torch.where(spine, torch.tensor(700.0, **kw), hu)
    r2 = (x / 0.82) ** 2 + (y / 0.62) ** 2
    bands = torch.sin(z * math.pi * 6.0) > 0.55
    ribs = (r2 <= 1.0) & (r2 >= 0.88) & body & bands & (y < 0.5)
    hu = torch.where(ribs, torch.tensor(500.0, **kw), hu)

    noise = F.interpolate(low[None, None], size=(X, Y, Z), mode="trilinear",
                          align_corners=True)[0, 0]
    return hu + noise * inside


def hu_to_density(hu: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Air (<= -800 HU) at the softest tissue's HU, soft tissue as is, bone
    (> 350 HU) as is, then shifted and scaled to [0, 1]."""
    hu = hu.to(dtype)
    air, bone = hu <= -800, hu > 350
    soft = ~air & ~bone
    soft_min = hu[soft].min() if bool(soft.any()) else hu.new_tensor(-800.0)
    density = torch.where(air, soft_min, hu)
    density = density - density.min()
    peak = density.max()
    return density / peak if float(peak) > 0 else density
