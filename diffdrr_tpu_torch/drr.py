"""The DRR orchestrator: differentiable X-ray rendering, end to end.

Counterpart of ``diffdrr_tpu/drr.py`` for the exact Siddon, Joseph and
trilinear renderers. ``DRR(subject, sdd, height, delx, renderer=...)`` holds
the density and the detector on one device; ``drr(pose)`` or
``drr(rotation, translation, parameterization=..., convention=...)`` renders
``(B, 1, H, W)`` images, and ``render(density, source, target)`` is the
explicit-density seam.

Dispatch for a full-frame render (the path a registration runs):

  1. the march axis is ``axis=`` if the caller pins one, else the axis whose
     worst ray has the smallest transverse/axial slope (``worst_ratios``,
     from the four corner rays; this reads three numbers back to the host);
  2. ``renderer="siddon"``: if that worst slope exceeds 1 the slab
     decomposition cannot represent the rays, and the pose goes to the
     sort-based oracle (``ops/siddon.py``), as the JAX package's slab guard
     does; each such render adds one to ``siddon_escapes``. Otherwise
     ``prep_rays`` packs the rays and ``SiddonSlab`` runs the CUDA kernels
     (the plain versions on the CPU), by sum or, with ``reducefn="max"``,
     by max (the MIP);
  3. ``renderer="joseph"`` marches every ``step`` planes (default
     ``joseph_steps[axis]``, one sample per largest voxel spacing) and
     ``renderer="trilinear"`` takes ``n_points`` (default 500, capped at one
     sample per plane unless ``allow_oversample``) to a stride
     (``ops/kernels/raymarch.py``); both run ``JosephMarch`` over the
     Joseph kernels, by sum or (joseph) max, with no slab guard.

``render(density, source, target)`` differentiates with respect to the
density it is given, so a free density leaf receives its gradient
(reconstruction); ``stop_gradients_through_grid_sample`` (Siddon) detaches
it. ``fused_pose_bwd`` (default True) takes the pose gradient from the fused
forward; False runs the value-only forward and the two-pass pose backward,
the cheaper choice when only the density needs a gradient.

The oracles (``ops/siddon.py``, ``ops/joseph.py``, ``ops/trilinear.py``)
render, in ``patch_size`` chunks when that is set: ray sets that are not the
full detector frame, ``force_xla=True``, a callable ``reducefn``, and what
the trilinear kernels do not take (``reducefn="max"``, ``mode``,
``align_corners``, ``alphamin``/``alphamax``). The Joseph oracle chooses
its axis, when none is pinned, from the mean ray direction of the whole
ray set, as the JAX package's does. None of the JAX package's TPU planning
(tile windows, the footprint guard, bf16 storage) exists here: the volume is
stored once, in float32.

Not ported yet (ROADMAP.md): ``mask_to_channels`` and ``p_subsample``.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .data import Subject
from .detector import Detector
from .ops.joseph import joseph_raycast
from .ops.kernels.joseph import joseph_march_raycast
from .ops.kernels.raymarch import raymarch_raycast
from .ops.kernels.siddon import siddon_slab_raycast
from .ops.siddon import siddon_raycast
from .ops.trilinear import trilinear_raycast
from .pose import RigidTransform, convert

__all__ = ["DRR"]

_TODO = "{} is not ported to diffdrr_tpu_torch yet; see ROADMAP.md"
_ORACLES = {"siddon": siddon_raycast, "joseph": joseph_raycast,
            "trilinear": trilinear_raycast}
# Render options each renderer understands; anything else raises.
_COMMON = {"axis", "eps", "reducefn", "fused_pose_bwd", "force_xla"}
_OPTIONS = {
    "siddon": _COMMON | {"mode", "align_corners", "stop_gradients_through_grid_sample",
                         "slab_guard"},
    "joseph": _COMMON | {"step"},
    "trilinear": _COMMON | {"n_points", "allow_oversample", "mode", "align_corners",
                            "alphamin", "alphamax"},
}
# Options that only steer the kernel path, dropped before an oracle call.
_KERNEL_ONLY = {"axis", "step", "allow_oversample", "fused_pose_bwd", "force_xla",
                "slab_guard"}


class DRR:
    """Computes differentiable digitally reconstructed radiographs."""

    def __init__(
        self,
        subject: Subject,
        sdd: float,
        height: int,
        delx: float,
        width: Optional[int] = None,
        dely: Optional[float] = None,
        x0: float = 0.0,
        y0: float = 0.0,
        p_subsample: Optional[float] = None,
        reshape: bool = True,
        reverse_x_axis: bool = True,
        patch_size: Optional[int] = None,
        renderer: str = "siddon",
        voxel_shift: float = 0.5,
        device: DeviceLike = None,
        **renderer_kwargs,
    ):
        if renderer not in _OPTIONS:
            raise ValueError(f"renderer must be one of {sorted(_OPTIONS)}, not {renderer!r}")
        if p_subsample is not None:
            raise NotImplementedError(_TODO.format("p_subsample"))
        unknown = set(renderer_kwargs) - _OPTIONS[renderer]
        if unknown:
            raise TypeError(f"unexpected renderer option(s) {sorted(unknown)}")
        self.device = resolve_device(device)
        width = height if width is None else width
        dely = delx if dely is None else dely

        self.detector = Detector(sdd, height, width, delx, dely, x0, y0,
                                 subject.reorient, reverse_x_axis, device=self.device)
        self.subject = subject
        affine = np.asarray(subject.volume.affine, np.float32)[None]
        self._affine = torch.as_tensor(affine, device=self.device)
        self._affine_inverse = torch.as_tensor(np.linalg.inv(affine), device=self.device)
        self.density = torch.as_tensor(subject.density.data, dtype=torch.float32,
                                       device=self.device).contiguous()
        self.renderer_name = renderer
        self.voxel_shift = voxel_shift
        self.renderer_kwargs = dict(renderer_kwargs)
        self.reshape = reshape
        self.patch_size = patch_size
        # Renders that took the slab-validity escape to the sort oracle.
        self.siddon_escapes = 0

        # The volume axis most aligned with the principal ray at the identity
        # pose (the n_points cap's axis when none is pinned), and the Joseph
        # stride of each axis: one sample per largest voxel spacing.
        affine64 = np.asarray(subject.volume.affine, np.float64)
        principal = (np.linalg.inv(affine64)[:3, :3]
                     @ np.asarray(subject.reorient, np.float64)[:3, :3]
                     @ np.array([0.0, 0.0, 1.0]))
        self.march_axis = int(np.argmax(np.abs(principal)))
        spacing = np.sqrt((affine64[:3, :3] ** 2).sum(axis=0))
        ref_sp = float(spacing.max())
        self.joseph_steps = tuple(max(1, int(round(ref_sp / float(spacing[a]))))
                                  for a in range(3))

    @property
    def affine(self) -> RigidTransform:
        return RigidTransform(self._affine)

    @property
    def affine_inverse(self) -> RigidTransform:
        return RigidTransform(self._affine_inverse)

    @property
    def n_patches(self) -> int:
        return max(1, (self.detector.height * self.detector.width) // (self.patch_size ** 2))

    @property
    def dtype(self):
        return self.density.dtype

    # ----------------------------------------------------------------- forward
    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, parameterization: Optional[str] = None,
                convention: Optional[str] = None,
                calibration: Optional[RigidTransform] = None,
                mask_to_channels: bool = False, degrees: bool = False,
                **kwargs) -> torch.Tensor:
        """Render DRR(s) for a pose, or for pose parameters."""
        if parameterization is None:
            pose = args[0]
        else:
            pose = convert(*args, parameterization=parameterization,
                           convention=convention, degrees=degrees)
        source, target = self.detector(pose, calibration)
        img = self.render(self.density, source, target,
                          mask_to_channels=mask_to_channels, **kwargs)
        return self.reshape_transform(img, batch_size=len(pose))

    def worst_ratios(self, source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Worst-ray transverse/axial slope per march axis, voxel space, (3,).

        From the four corner rays, which is exact: every ray is affine in
        the detector's pixel coordinates, so each ratio is linear-fractional
        on the detector rectangle and peaks at a corner whenever the axial
        component keeps one sign there; a sign change among the corners
        means some ray runs parallel to the planes, and the axis is invalid.
        """
        H, W = self.detector.height, self.detector.width
        cidx = torch.tensor([0, W - 1, (H - 1) * W, H * W - 1], device=target.device)
        d = target[:, cidx] - source.expand_as(target)[:, cidx]  # (B, 4, 3)
        da = torch.abs(d)
        same_sign = (torch.amax(d, dim=1) * torch.amin(d, dim=1)) > 0.0
        trans_max = torch.stack([
            torch.maximum(da[..., 1], da[..., 2]),
            torch.maximum(da[..., 0], da[..., 2]),
            torch.maximum(da[..., 0], da[..., 1]),
        ], dim=-1)
        r = torch.amax(trans_max / torch.clamp(da, min=1e-12), dim=1)
        r = torch.where(same_sign, r, torch.full_like(r, 1e12))
        return torch.amax(r, dim=0)

    def render(self, density: torch.Tensor, source: torch.Tensor,
               target: torch.Tensor, mask_to_channels: bool = False,
               **kwargs) -> torch.Tensor:
        """Line integrals ``(B, 1, N)`` of world-space rays through ``density``."""
        if mask_to_channels:
            raise NotImplementedError(_TODO.format("mask_to_channels"))
        opts = {**self.renderer_kwargs, **kwargs}
        unknown = set(opts) - _OPTIONS[self.renderer_name]
        if unknown:
            raise TypeError(f"unexpected renderer option(s) {sorted(unknown)}")

        weights = torch.linalg.vector_norm(target - source, dim=-1)[:, None, :]
        source = self.affine_inverse(source)
        target = self.affine_inverse(target)

        H, W = self.detector.height, self.detector.width
        if target.shape[1] == H * W and not opts.get("force_xla", False):
            if self.renderer_name == "siddon":
                img = self._render_slab(density, source, target, weights, opts)
            else:
                img = self._render_march(density, source, target, weights, opts)
            if img is not None:
                return img
        return self._render_oracle(density, source, target, weights, opts)

    def _render_slab(self, density, source, target, weights, opts):
        """Siddon's slab kernels, or None for the oracle."""
        reducefn = opts.get("reducefn", "sum")
        if not (reducefn in ("sum", "max") and opts.get("mode", "nearest") == "nearest"
                and not opts.get("align_corners", False)):
            return None
        if opts.get("stop_gradients_through_grid_sample", False):
            density = density.detach()
        axis = opts.get("axis")
        slab_guard = opts.get("slab_guard", True)
        ratios = None
        if axis is None or slab_guard:
            ratios = self.worst_ratios(source, target).tolist()
        if axis is None:
            axis = int(np.argmin(ratios))
        if slab_guard and not ratios[axis] <= 1.0 + 1e-6:
            self.siddon_escapes += 1
            return None
        return siddon_slab_raycast(density, source, target, weights, axis=axis,
                                   voxel_shift=self.voxel_shift, eps=opts.get("eps", 1e-8),
                                   reduce=reducefn, fused=opts.get("fused_pose_bwd", True))

    def _render_march(self, density, source, target, weights, opts):
        """The Joseph kernels (joseph, trilinear), or None for the oracle."""
        reducefn = opts.get("reducefn", "sum")
        trilinear = self.renderer_name == "trilinear"
        if trilinear:
            ok = (reducefn == "sum" and opts.get("mode", "trilinear") == "trilinear"
                  and not opts.get("align_corners", False)
                  and opts.get("alphamin") is None and opts.get("alphamax") is None)
        else:
            ok = reducefn in ("sum", "max")
        if not ok:
            return None
        axis = opts.get("axis")
        n_points = opts.get("n_points", 500)
        allow_oversample = opts.get("allow_oversample", False)
        if (trilinear and not allow_oversample
                and n_points > density.shape[self.march_axis if axis is None else axis]):
            warnings.warn(
                f"trilinear kernel caps n_points={n_points} at one sample per plane "
                f"({density.shape[self.march_axis if axis is None else axis]}); accuracy is "
                f"already saturated there; pass allow_oversample=True to honor n_points "
                f"literally (reference semantics, proportionally slower)", stacklevel=4)
        if axis is None:
            axis = int(np.argmin(self.worst_ratios(source, target).tolist()))
        common = dict(axis=axis, voxel_shift=self.voxel_shift, eps=opts.get("eps", 1e-8),
                      reduce=reducefn, fused=opts.get("fused_pose_bwd", True))
        if trilinear:
            return raymarch_raycast(density, source, target, weights, n_points=n_points,
                                    allow_oversample=allow_oversample, **common)
        step = opts.get("step")
        return joseph_march_raycast(density, source, target, weights,
                                    step=self.joseph_steps[axis] if step is None else step,
                                    **common)

    def _render_oracle(self, density, source, target, weights, opts):
        renderer = _ORACLES[self.renderer_name]
        if self.renderer_name == "joseph":
            axis, step = opts.get("axis"), opts.get("step")
            if axis is None:  # from the whole ray set, before any chunking
                axis = int(torch.argmax(torch.abs(torch.mean(target - source, dim=(0, 1)))))
            renderer = partial(renderer, axis=axis,
                               step=self.joseph_steps[axis] if step is None else step)
        opts = {k: v for k, v in opts.items() if k not in _KERNEL_ONLY}
        if self.patch_size is None:
            return renderer(density, source, target, weights,
                            voxel_shift=self.voxel_shift, **opts)
        N = target.shape[1]
        size = -(-N // self.n_patches)
        parts = [renderer(density, source, target[:, i:i + size], weights[..., i:i + size],
                          voxel_shift=self.voxel_shift, **opts)
                 for i in range(0, N, size)]
        return torch.cat(parts, dim=-1)

    def reshape_transform(self, img: torch.Tensor, batch_size: int) -> torch.Tensor:
        if self.reshape:
            img = img.reshape(batch_size, -1, self.detector.height, self.detector.width)
        return img
