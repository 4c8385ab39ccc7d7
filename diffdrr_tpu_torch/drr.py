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

Per-structure channels (``mask_to_channels=True``, with a labelmap on the
subject): the labelmap goes to the device once, as int32, and the render is
``(B, n_channels, H, W)``, ``n_channels = max label + 1``. joseph and
trilinear render them with the Joseph kernels' channel mode (always a sum;
trilinear only where its kernels take the options); Siddon, and a DRR
without a labelmap, render on the oracle, as the JAX package routes them.

``p_subsample``: the detector keeps ``int(H * W * p_subsample)`` seeded
random pixels. ``forward`` renders only those rays, on the kernels with the
march axis (and Siddon's slab guard) judged from the full frame's corner
rays, and scatters them into a zeroed ``(B, C, H, W)`` image.

The oracles (``ops/siddon.py``, ``ops/joseph.py``, ``ops/trilinear.py``)
render, in ``patch_size`` chunks when that is set: ray sets that ``render``
is given directly and that are not the full detector frame,
``force_xla=True``, a callable ``reducefn``, and what the trilinear kernels
do not take (``reducefn="max"``, ``mode``, ``align_corners``,
``alphamin``/``alphamax``). The Joseph oracle chooses its axis, when none
is pinned, from the mean ray direction of the whole ray set, as the JAX
package's does. None of the JAX package's TPU planning (tile windows, the
footprint guard, sparse-render strategies) exists here.

``storage`` and ``precision`` are the JAX package's renderer options.
``storage="bf16"`` keeps the kernels' bricked copy of the density in bf16
(each voxel rounded to the nearest bf16, ties to even) instead of float32:
every kernel render then equals, bit for bit, the float32 render of the
density rounded to bf16, and its density gradient stays float32 (straight
through the rounding). It halves the copy's memory and the gathers'
density bytes; on the H100 its forwards are nonetheless slower than the
float32 ones (PERF.md), so what it saves is device memory. As in the JAX
package it applies to the kernel path only: the oracles
(``force_xla``, Siddon's slab-guard escapes, Siddon channels, a callable
``reducefn``, ray sets that are not the full frame) read the float32
density. The default storage is float32 whatever ``precision`` says, where
the JAX package defaults to bf16: on its chip's default matmul policy bf16
storage gives the same bits, here it moves the image by ~9e-4 of its
maximum. ``precision`` is ``"f32"`` (the default) or ``"highest"``, the
same function here: the kernels do scalar float32 arithmetic and
``pin_f32`` keeps TF32 off. The attribute ``pallas_precision`` exists only
for parity with the JAX package (``rescaled_drr`` and the sharded renders
carry it) and selects nothing. ``precision="bf16"`` (which rounds the TPU
matrix unit's inputs) raises.

Constructor options of the reference: ``persistent`` and
``compile_renderer`` are accepted and do nothing, as in the JAX package.
``checkpoint_gradients=True`` runs the render under
``torch.utils.checkpoint`` (non-reentrant): the backward renders again
instead of keeping the forward's saved tensors, so a kernel forward
launches twice a step; the rerun finds the density's bricked copy in the
cache and makes none. ``cache_volume=False`` drops the rendered density's
bricked copy (of either storage) from the cache before each render, so every
render makes its copy anew (the counterpart of the JAX package's
prepped-volume cache).
``set_density`` swaps the stored density; the copy cache, keyed on the
tensor, then bricks the new one at its first render.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ._device import DeviceLike, pin_f32, resolve_device
from .data import Subject
from .detector import Detector
from .ops._raygeom import alpha_minmax
from .ops.joseph import joseph_raycast
from .ops.kernels import brick
from .ops.kernels._launch import check_precision, check_storage
from .ops.kernels.joseph import as_labels, joseph_march_raycast
from .ops.kernels.raymarch import raymarch_raycast
from .ops.kernels.siddon import siddon_slab_raycast
from .ops.siddon import siddon_raycast
from .ops.trilinear import trilinear_raycast
from .pose import RigidTransform, convert
from .profiling import annotate

__all__ = ["DRR", "reshape_subsampled_drr"]

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
        persistent: bool = True,  # the reference's module option; nothing to persist
        compile_renderer: bool = False,  # the reference's option; the kernels are compiled
        checkpoint_gradients: bool = False,
        cache_volume: bool = True,
        device: DeviceLike = None,
        **renderer_kwargs,
    ):
        del persistent, compile_renderer
        if renderer not in _OPTIONS:
            raise ValueError(f"renderer must be one of {sorted(_OPTIONS)}, not {renderer!r}")
        # The JAX package's names: the arithmetic's precision and the
        # density copy's element type.
        self.pallas_precision = renderer_kwargs.pop("precision", "f32")
        self.pallas_storage = renderer_kwargs.pop("storage", None)
        check_precision(self.pallas_precision)
        check_storage(self.pallas_storage)
        unknown = set(renderer_kwargs) - _OPTIONS[renderer]
        if unknown:
            raise TypeError(f"unexpected renderer option(s) {sorted(unknown)}")
        self.device = resolve_device(device)
        width = height if width is None else width
        dely = delx if dely is None else dely
        n_subsample = None if p_subsample is None else int(height * width * p_subsample)

        self.detector = Detector(sdd, height, width, delx, dely, x0, y0, subject.reorient,
                                 n_subsample, reverse_x_axis, device=self.device)
        self.subject = subject
        affine = np.asarray(subject.volume.affine, np.float32)[None]
        self._affine = torch.as_tensor(affine, device=self.device)
        self._affine_inverse = torch.as_tensor(np.linalg.inv(affine), device=self.device)
        self.density = torch.as_tensor(subject.density.data, dtype=torch.float32,
                                       device=self.device).contiguous()
        # The labelmap, int32 on the device, and its channel count (one host read).
        self.mask = self.n_channels = None
        if subject.mask is not None:
            mask = torch.as_tensor(subject.mask.data)
            self.n_channels = int(mask.max()) + 1
            self.mask = as_labels(mask.to(self.device)).contiguous()
        self.renderer_name = renderer
        self.voxel_shift = voxel_shift
        self.renderer_kwargs = dict(renderer_kwargs)
        self.reshape = reshape
        self.patch_size = patch_size
        self.checkpoint_gradients = bool(checkpoint_gradients)
        self.cache_volume = bool(cache_volume)
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

    def set_density(self, density) -> None:
        """Replace the stored density (float32 on the DRR's device)."""
        self.density = torch.as_tensor(density, dtype=torch.float32,
                                       device=self.device).contiguous()

    @property
    def cone_tan(self) -> float:
        """tan of the widest angle any detector ray makes with the principal
        ray (pose-independent). Above 1 no pose can pass Siddon's slab
        guard: the geometry itself is too wide."""
        d = self.detector
        half_w = d.width / 2 * d.delx + abs(d._x0)
        half_h = d.height / 2 * d.dely + abs(d._y0)
        return float(np.hypot(half_w, half_h) / d.sdd)

    def pallas_ray_compatibility(self, pose: RigidTransform) -> Tuple[int, float]:
        """``(best_axis, worst_ratio)`` of a pose for the slab march (host helper).

        ``worst_ratio`` is the largest transverse/axial slope of any ray,
        in voxel space, at the axis where it is least; above 1 some rays
        break the slab assumption and the Siddon kernels' integrals would be
        inexact for them (the slab guard sends such poses to the oracle).
        Judged over the full detector frame, whatever ``p_subsample``.
        """
        diagnosis = self.diagnose_pose(pose)
        best = diagnosis["best_axis"]
        return best, diagnosis["worst_ratio"][best]

    def diagnose_pose(self, pose: RigidTransform) -> dict:
        """How the kernel dispatch treats a pose (host helper).

        ``worst_ratio``: per march axis, the worst ray's transverse/axial
        slope in voxel space (``worst_ratios``, from the four corner rays,
        which bound every ray of the frame; the JAX package takes the max
        over all rays); ``best_axis`` the axis where it is least;
        ``slab_valid`` whether it is at most 1 there, so that Siddon's slab
        guard keeps the pose on the kernels; ``cone_tan`` the geometry's
        pose-independent cone bound. Judged on the full detector frame,
        whatever ``p_subsample``, as the kernels are. The JAX package's
        ``footprint_fits``, ``pallas_ok`` and ``fp_guard_active`` describe
        its TPU tile windows, which have no counterpart here: they are
        absent.
        """
        source, _ = self.detector(pose, None)
        target = self.detector.full_plane_target(pose, None)
        ratios = self.worst_ratios(self.affine_inverse(source),
                                   self.affine_inverse(target)).tolist()
        best = int(np.argmin(ratios))
        return {"best_axis": best, "worst_ratio": [float(r) for r in ratios],
                "slab_valid": ratios[best] <= 1.0 + 1e-6, "cone_tan": self.cone_tan}

    # ----------------------------------------------------------------- forward
    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, parameterization: Optional[str] = None,
                convention: Optional[str] = None,
                calibration: Optional[RigidTransform] = None,
                mask_to_channels: bool = False, degrees: bool = False,
                **kwargs) -> torch.Tensor:
        """Render DRR(s) for a pose, or for pose parameters."""
        with annotate("drr.pose"):
            if parameterization is None:
                pose = args[0]
            else:
                pose = convert(*args, parameterization=parameterization,
                               convention=convention, degrees=degrees)
            source, target = self.detector(pose, calibration)
            sample = None
            if self.detector.n_subsample is not None:
                # Only the sampled rays are rendered, taken from the full frame
                # (whose corner rays judge the march axis, as in the JAX package).
                target = self.detector.full_plane_target(pose, calibration)
                sample = self.detector.subsample_index
        if self.checkpoint_gradients:
            img = checkpoint(self._render, self.density, source, target, mask_to_channels,
                             sample, kwargs, use_reentrant=False)
        else:
            img = self._render(self.density, source, target, mask_to_channels, sample, kwargs)
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
        """Line integrals ``(B, 1, N)`` of world-space rays through ``density``
        (``(B, n_channels, N)`` with ``mask_to_channels``)."""
        return self._render(density, source, target, mask_to_channels, None, kwargs)

    def _render(self, density, source, target, mask_to_channels, sample, kwargs, share=None):
        """``render``; with ``sample`` (indices into the full frame ``target``)
        only those rays are rendered. They are gathered after the transforms,
        so each is bit for bit the full render's ray. With ``share``, a pair
        ``((b0, b1), (lo, hi))`` of ranges of that ray set's poses and rays,
        only rays ``lo:hi`` of poses ``b0:b1`` are rendered, and every choice
        the render makes from its rays (the march axis, the slab guard, the
        oracles' axis and sampling interval) comes from the whole set: the
        rays are the whole render's, bit for bit on the kernels (so
        ``parallel`` splits a render over several devices)."""
        with annotate("drr.render"):
            opts = {**self.renderer_kwargs, **kwargs}
            unknown = set(opts) - _OPTIONS[self.renderer_name]
            if unknown:
                raise TypeError(f"unexpected renderer option(s) {sorted(unknown)}")
            if not self.cache_volume:
                brick.forget(density)

            weights = torch.linalg.vector_norm(target - source, dim=-1)[:, None, :]
            source = self.affine_inverse(source)
            target = self.affine_inverse(target)

            H, W = self.detector.height, self.detector.width
            frame = (source, target) if target.shape[1] == H * W else None
            if sample is not None:
                target, weights = target[:, sample], weights[..., sample]
            whole = (source, target)
            if share is not None:
                (b0, b1), (lo, hi) = share
                if source.shape[0] > 1:
                    source = source[b0:b1]
                target, weights = target[b0:b1, lo:hi], weights[b0:b1, :, lo:hi]
            # Channels take the kernels for joseph and trilinear with a labelmap;
            # Siddon channels, and channels without a labelmap, take the oracle.
            channels = mask_to_channels and self.mask is not None
            kernels = not mask_to_channels or (channels and self.renderer_name != "siddon")
            if frame is not None and kernels and not opts.get("force_xla", False):
                if self.renderer_name == "siddon":
                    img = self._render_slab(density, source, target, weights, opts, frame)
                else:
                    img = self._render_march(density, source, target, weights, opts, frame,
                                             channels)
                if img is not None:
                    return img
            if channels:
                opts.update(mask=self.mask, n_channels=self.n_channels)
            return self._render_oracle(density, source, target, weights, opts, whole, share)

    def _render_slab(self, density, source, target, weights, opts, frame):
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
            ratios = _read(self.worst_ratios(*frame))
        if axis is None:
            axis = int(np.argmin(ratios))
        if slab_guard and not ratios[axis] <= 1.0 + 1e-6:
            self.siddon_escapes += 1
            return None
        return siddon_slab_raycast(density, source, target, weights, axis=axis,
                                   voxel_shift=self.voxel_shift, eps=opts.get("eps", 1e-8),
                                   reduce=reducefn, fused=opts.get("fused_pose_bwd", True),
                                   storage=self.pallas_storage)

    def _render_march(self, density, source, target, weights, opts, frame, channels):
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
                f"literally (reference semantics, proportionally slower)", stacklevel=5)
        if axis is None:
            axis = int(np.argmin(_read(self.worst_ratios(*frame))))
        common = dict(axis=axis, voxel_shift=self.voxel_shift, eps=opts.get("eps", 1e-8),
                      reduce=reducefn, fused=opts.get("fused_pose_bwd", True),
                      storage=self.pallas_storage)
        if channels:
            common.update(mask=self.mask, n_channels=self.n_channels)
        if trilinear:
            return raymarch_raycast(density, source, target, weights, n_points=n_points,
                                    allow_oversample=allow_oversample, **common)
        step = opts.get("step")
        return joseph_march_raycast(density, source, target, weights,
                                    step=self.joseph_steps[axis] if step is None else step,
                                    **common)

    def _render_oracle(self, density, source, target, weights, opts, whole=None, share=None):
        """The oracle over ``target``, in ``patch_size`` chunks when that is
        set; with ``share``, ``target`` is that share of the ray set
        ``whole`` (its source and target), whose chunks and choices (the
        Joseph axis, the trilinear interval) are taken."""
        renderer = _ORACLES[self.renderer_name]
        w_source, w_target = (source, target) if whole is None else whole
        if self.renderer_name == "joseph":
            axis, step = opts.get("axis"), opts.get("step")
            if axis is None:  # from the whole ray set, before any chunking
                axis = _read(torch.argmax(torch.abs(torch.mean(w_target - w_source, dim=(0, 1)))))
            renderer = partial(renderer, axis=axis,
                               step=self.joseph_steps[axis] if step is None else step)
        opts = {k: v for k, v in opts.items() if k not in _KERNEL_ONLY}
        # The trilinear oracle samples over its rays' earliest entry and latest
        # exit: those of the whole chunk, when it renders a share of it.
        interval = (share is not None and self.renderer_name == "trilinear"
                    and (opts.get("alphamin") is None or opts.get("alphamax") is None))
        N = w_target.shape[1]
        lo, hi = (0, N) if share is None else share[1]
        size = N if self.patch_size is None else -(-N // self.n_patches)
        parts = []
        for i in range(0, N, size):
            a, b = max(i, lo), min(i + size, hi)  # this chunk's rays in the share
            if a >= b:
                continue
            if interval:
                amin, amax = alpha_minmax(w_source, w_target[:, i:i + size], tuple(density.shape),
                                          self.voxel_shift, opts.get("eps", 1e-8))
                opts.update(alphamin=torch.amin(amin), alphamax=torch.amax(amax))
            parts.append(renderer(density, source, target[:, a - lo:b - lo],
                                  weights[..., a - lo:b - lo], voxel_shift=self.voxel_shift,
                                  **opts))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def reshape_transform(self, img: torch.Tensor, batch_size: int) -> torch.Tensor:
        if self.reshape:
            if self.detector.n_subsample is None:
                img = img.reshape(batch_size, -1, self.detector.height, self.detector.width)
            else:
                img = reshape_subsampled_drr(img, self.detector, batch_size)
        return img

    # ----------------------------------------------- runtime intrinsics swaps
    def set_intrinsics_(self, sdd: Optional[float] = None, height: Optional[int] = None,
                        width: Optional[int] = None, delx: Optional[float] = None,
                        dely: Optional[float] = None, x0: Optional[float] = None,
                        y0: Optional[float] = None, n_subsample: Optional[int] = None,
                        reverse_x_axis: Optional[bool] = None) -> None:
        """Set new intrinsic parameters in place (``None`` keeps the current one;
        ``x0``/``y0`` are the calibration entries, as the constructor takes them)."""
        d = self.detector
        self.detector = Detector(
            d.sdd if sdd is None else sdd,
            d.height if height is None else height,
            d.width if width is None else width,
            d.delx if delx is None else delx,
            d.dely if dely is None else dely,
            d._x0 if x0 is None else x0,
            d._y0 if y0 is None else y0,
            d._reorient.cpu().numpy(),
            d.n_subsample if n_subsample is None else n_subsample,
            d.reverse_x_axis if reverse_x_axis is None else reverse_x_axis,
            device=self.device)

    def rescale_detector_(self, scale: float) -> None:
        """Rescale the detector plane in place: ``scale`` times the pixels, each
        ``1 / scale`` times as large."""
        self.set_intrinsics_(height=int(self.detector.height * scale),
                             width=int(self.detector.width * scale),
                             delx=float(self.detector.delx / scale),
                             dely=float(self.detector.dely / scale))

    # ------------------------------------------------------------- projections
    def perspective_projection(self, pose: RigidTransform, pts: torch.Tensor) -> torch.Tensor:
        """Project world points ``(B, N, 3)`` onto the pixel plane, ``(B, N, 2)``."""
        pin_f32()
        extrinsic = self.detector.reorient.compose(pose).inverse()
        x = extrinsic(pts)
        x = torch.einsum("ij,bnj->bni", self.detector.intrinsic, x)
        x = x / x[..., -1:]
        x1 = self.detector.height - x[..., 1]
        x0 = x[..., 0]
        if self.detector.reverse_x_axis:
            x0 = self.detector.width - x0
        return torch.stack([x0, x1], dim=-1)

    def inverse_projection(self, pose: RigidTransform, pts: torch.Tensor) -> torch.Tensor:
        """Backproject pixel points ``(B, N, 2)`` onto the detector plane in
        world coordinates, ``(B, N, 3)``."""
        pin_f32()
        x1 = self.detector.height - pts[..., 1]
        x0 = pts[..., 0]
        if self.detector.reverse_x_axis:
            x0 = self.detector.width - x0
        homogeneous = torch.stack([x0, x1, torch.ones_like(x0)], dim=-1)
        intrinsic_inv = torch.linalg.inv(self.detector.intrinsic)
        x = self.detector.sdd * torch.einsum("ij,bnj->bni", intrinsic_inv, homogeneous)
        return self.detector.reorient.compose(pose)(x)


def _read(value: torch.Tensor):
    """``value.tolist()``: a device value the render's host code needs, read
    under a ``drr.sync`` span, whose length is the host's wait for the card."""
    with annotate("drr.sync"):
        return value.tolist()


def reshape_subsampled_drr(img: torch.Tensor, detector: Detector,
                           batch_size: int) -> torch.Tensor:
    """The sampled rays ``(B, C, n)`` scattered into a zeroed ``(B, C, H, W)``."""
    C = img.shape[1]
    drr = img.new_zeros((batch_size, C, detector.height * detector.width))
    drr = drr.index_copy(2, detector.subsample_index, img.reshape(batch_size, C, -1))
    return drr.reshape(batch_size, C, detector.height, detector.width)
