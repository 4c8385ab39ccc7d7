"""What every driver shares: the seeded CT handed to both sides, the
program's DRR, the reference's geometry, and rays cut into blocks."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import geometry, phantom, render

REF_DTYPE = torch.float64


class Inputs:
    """The cell's CT and pose draws, made from ``seed``: the HU volume on
    ``device``, kept for the reference, and one generator for the draws that
    follow, consumed in a fixed order. The draws are few and small; they
    are made on the host, so a seed gives the same inputs on every device,
    and the volume is made from them on the device."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.device = config, torch.device(device)
        self.generator = torch.Generator().manual_seed(int(seed))
        ct = config["ct"]
        if ct["recipe"] != "chest":
            raise ValueError(f"unknown CT recipe {ct['recipe']!r}")
        low = torch.randn((8, 8, 4), generator=self.generator) * 12.0
        self.hu = phantom.chest_hu(ct["shape"], low.to(self.device))
        pose = config["pose"]
        if (pose["parameterization"], pose["convention"]) != ("euler_angles", "ZXY"):
            raise ValueError("the benchmark draws Euler ZXY poses")
        self.rotation = torch.tensor(pose["rotation"], dtype=torch.float32, device=self.device)
        self.translation = torch.tensor(pose["translation"], dtype=torch.float32,
                                        device=self.device)

    def normal(self, shape, std: float) -> torch.Tensor:
        """N(0, std) draws."""
        return (torch.randn(shape, generator=self.generator) * std).to(self.device)

    def poses(self, shape, traffic: dict):
        """``(rotation, translation)`` of ``shape + (3,)``: the configured
        pose plus the traffic's seeded offsets."""
        shape = tuple(shape) + (3,)
        rot = self.rotation + self.normal(shape, traffic["rotation_sigma"])
        trans = self.translation + self.normal(shape, traffic["translation_sigma"])
        return rot, trans

    def views(self, lead, n: int, span: float):
        """``(rotation, translation)`` of ``lead + (n, 3)``: batches of ``n``
        views, the configured pose turned by theta_i about its first Euler
        angle, theta evenly spaced over ``span`` from a seeded offset, one
        offset a batch (the reconstruction CLI's ``[theta, pi/2, 0]``)."""
        lead = tuple(lead)
        offset = torch.rand(lead, generator=self.generator) * (span / n)
        theta = offset[..., None] + torch.arange(n) * (span / n)
        rot = self.rotation.cpu().expand(*lead, n, 3).clone()
        rot[..., 0] = rot[..., 0] + theta
        trans = self.translation.cpu().expand(*lead, n, 3).clone()
        return rot.to(self.device), trans.to(self.device)


class DriverBase:
    """What the harness calls on every driver besides its own ``setup``,
    ``step``, ``mark_trace``, ``costs``, ``release`` and ``compare``."""

    inputs: Inputs
    failed = 0  # timed steps whose read-back was not finite

    def sync(self) -> None:
        if self.inputs.device.type == "cuda":
            torch.cuda.synchronize()


def program_drr(inputs: Inputs, storage=None):
    """The program's DRR of the config, built through its public subject
    constructor from the same HU the reference gets."""
    from diffdrr_tpu_torch import DRR
    from diffdrr_tpu_torch.data import Image, read

    cfg = inputs.config
    ct, det = cfg["ct"], cfg["detector"]
    affine = np.diag([*ct["spacing"], 1.0])
    subject = read(Image(inputs.hu.cpu().numpy(), affine), orientation=ct["orientation"])
    subject.to(inputs.device)
    kw = dict(cfg.get("render_options", {}))
    if storage is not None:
        kw["storage"] = storage
    return DRR(subject, sdd=det["sdd"], height=det["height"], width=det["width"],
               delx=det["delx"], dely=det["dely"], renderer=cfg["renderer"],
               device=inputs.device, **kw)


POSE_KW = dict(parameterization="euler_angles", convention="ZXY")
# Rays a block of the reference: a few GB of float64 intermediates on the card.
BLOCK_RAYS = {"cuda": {"siddon": 16384, "trilinear": 32768}, "cpu": {"siddon": 4096,
                                                                     "trilinear": 4096}}


def block_rays(inputs: "Inputs") -> int:
    return BLOCK_RAYS[inputs.device.type][inputs.config["renderer"]]


def geometry_of(config: dict, device) -> geometry.Geometry:
    """The reference's detector and CT frame of a config, float64."""
    ct, det = config["ct"], config["detector"]
    return geometry.Geometry(
        sdd=det["sdd"], height=det["height"], width=det["width"], delx=det["delx"],
        dely=det["dely"], shape=ct["shape"], spacing=ct["spacing"],
        orientation=ct["orientation"], dtype=REF_DTYPE, device=device)


class Reference:
    """The plain reference of a config on ``device`` in float64: the density
    from the HU, the geometry, and renders of pose batches in blocks of rays."""

    def __init__(self, inputs: Inputs, device, block_rays: int):
        cfg = inputs.config
        self.device, self.block = torch.device(device), int(block_rays)
        self.density = phantom.hu_to_density(inputs.hu.to(self.device), REF_DTYPE)
        self.shape = tuple(cfg["ct"]["shape"])
        self.geometry = geometry_of(cfg, self.device)
        self.renderer = cfg["renderer"]
        self.n_points = cfg.get("render_options", {}).get("n_points", 500)
        if self.renderer not in ("siddon", "trilinear"):
            raise ValueError(f"no reference for renderer {self.renderer!r}")

    def as_ref(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=REF_DTYPE)

    def blocks(self, n_poses: int):
        """``(pose, pixel slice)`` pairs covering every ray of a batch."""
        N = self.geometry.height * self.geometry.width
        for b in range(n_poses):
            for lo in range(0, N, self.block):
                yield b, slice(lo, min(lo + self.block, N))

    def render_block(self, rotation, translation, b, pix, axis, density=None, bounds=False):
        """Line integrals of pose ``b``'s pixels ``pix``, ``(n,)``; with
        ``bounds``, the lowest and highest values rounding allows, ``(2, n)``."""
        idx = torch.arange(pix.start, pix.stop, device=self.device)
        src, tgt, w = self.geometry.rays(rotation[b:b + 1], translation[b:b + 1], idx)
        src, tgt, w = src.expand_as(tgt).reshape(-1, 3), tgt.reshape(-1, 3), w.reshape(-1)
        density = self.density if density is None else density
        if self.renderer == "siddon":
            if bounds:
                return torch.stack(render.siddon_bounds(density, src, tgt, w))
            return render.siddon(density, src, tgt, w)
        h, n_steps = render.march_steps(self.shape[axis], self.n_points)
        lo, hi = render.joseph_bounds(density, src, tgt, w, axis=axis, h=h, n_steps=n_steps)
        return torch.stack([lo, hi]) if bounds else 0.5 * (lo + hi)

    def axis(self, rotation, translation) -> int:
        return self.geometry.march_axis(rotation, translation)[0]

    def render(self, rotation, translation, density=None, bounds=False) -> torch.Tensor:
        """``(B, 1, H, W)`` images of a pose batch, no gradient; with
        ``bounds``, ``(2, B, 1, H, W)``: the lowest and highest values."""
        rotation, translation = self.as_ref(rotation), self.as_ref(translation)
        axis = self.axis(rotation, translation)
        B, H, W = rotation.shape[0], self.geometry.height, self.geometry.width
        out = torch.empty((2, B, H * W), dtype=REF_DTYPE, device=self.device)
        with torch.no_grad():
            for b, pix in self.blocks(B):
                out[:, b, pix] = self.render_block(rotation, translation, b, pix, axis, density,
                                                   bounds=True)
        out = out.reshape(2, B, 1, H, W)
        return out if bounds else 0.5 * (out[0] + out[1])


def costs(inputs: Inputs, rotation, translation, kinds) -> dict:
    """``{kernel: (bytes, flops)}`` of one launch of each ``kinds`` entry
    (``{"siddon_fwd": "fwd", ...}``) over a pose batch's rays."""
    from ..yardstick import cost

    cfg = inputs.config
    geo, shape = geometry_of(cfg, inputs.device), tuple(cfg["ct"]["shape"])
    rot = rotation.to(REF_DTYPE).reshape(-1, 3)
    trans = translation.to(REF_DTYPE).reshape(-1, 3)
    axis = geo.march_axis(rot, trans)[0]
    with torch.no_grad():
        src, tgt, _ = geo.rays(rot, trans)
        if cfg["renderer"] == "siddon":
            work = cost.siddon_work(src, tgt, shape, axis)
        else:
            n_points = cfg.get("render_options", {}).get("n_points", 500)
            h, n_steps = render.march_steps(shape[axis], n_points)
            work = cost.joseph_work(src, tgt, shape, axis, h, n_steps)
    return {kernel: cost.kernel_cost(work, kind) for kernel, kind in kinds.items()}


def relative_gap(got: float, want: float, scale: float) -> float:
    """|got - want| over the larger of |want| and ``scale``."""
    return abs(got - want) / max(abs(want), scale)


def widest_image_gap(image: torch.Tensor, bounds: torch.Tensor) -> float:
    """The widest distance of a pixel from the reference's ``bounds`` (the
    lowest and highest value that rounding allows it), over the reference's
    largest magnitude."""
    image = image.to(bounds.dtype)
    lo, hi = bounds[0], bounds[1]
    excess = torch.maximum(lo - image, image - hi).clamp_min(0.0)
    return float(excess.max() / hi.abs().max())
