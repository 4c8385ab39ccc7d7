"""C-arm detector / camera model.

Counterpart of ``diffdrr_tpu/detector.py``: the X-ray source sits at the
origin and the detector plane is centred on (0, 0, 1), scaled to world units
by a 4x4 calibration holding the intrinsics. The canonical plane is built on
the host in NumPy (the same code as the JAX package, so pixel order and the
odd-size centring agree bit for bit) and moved to the device once.

With ``n_subsample`` the detector keeps a random subset of its pixels,
``np.random.default_rng(seed).permutation(H * W)[:n_subsample]``, drawn once
at construction (the same indices as the JAX package's for the same seed):
``__call__`` then returns only those rays, ``subsamples[-1]`` lists their
indices and ``full_plane_target`` gives the whole frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .pose import RigidTransform

__all__ = [
    "Detector",
    "get_focal_length",
    "get_principal_point",
    "parse_intrinsic_matrix",
    "make_intrinsic_matrix",
]


def _canonical_plane(height: int, width: int, reverse_x_axis: bool,
                     dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical source (origin) + unit detector plane centred at (0, 0, 1).

    Row-major pixel order (t outer, s inner). Odd sizes span
    ``[-(h+1)//2, h//2)`` shifted by +1.0, even sizes by +0.5, which centres
    both on the principal axis.
    """
    source = np.zeros((1, 1, 3), dtype=dtype)
    h_off = 1.0 if height % 2 else 0.5
    w_off = 1.0 if width % 2 else 0.5
    t = np.arange(-((height + 1) // 2), height // 2, dtype=dtype) + h_off
    s = np.arange(-((width + 1) // 2), width // 2, dtype=dtype) + w_off
    t = -t
    if reverse_x_axis:
        s = -s
    tt, ss = np.meshgrid(t, s, indexing="ij")
    target = np.stack([ss.ravel(), tt.ravel(), np.ones(height * width, dtype)], -1)
    return source, target[None]


class Detector:
    """X-ray C-arm detector model on one device."""

    def __init__(
        self,
        sdd: float,
        height: int,
        width: int,
        delx: float,
        dely: float,
        x0: float,
        y0: float,
        reorient,
        n_subsample: Optional[int] = None,
        reverse_x_axis: bool = False,
        *,
        seed: int = 0,
        device: torch.device,
    ):
        self.height = int(height)
        self.width = int(width)
        self.n_subsample = None if n_subsample is None else int(n_subsample)
        self.reverse_x_axis = bool(reverse_x_axis)
        self._sdd = float(sdd)
        self._delx = float(delx)
        self._dely = float(dely)
        self._x0 = float(x0)
        self._y0 = float(y0)
        self.seed = seed
        self.device = torch.device(device)

        source, target = _canonical_plane(self.height, self.width, self.reverse_x_axis)
        self.source = torch.as_tensor(source, device=self.device)
        self.target_full = torch.as_tensor(target, device=self.device)
        self.target = self.target_full
        self.subsamples = []
        self.subsample_index = None
        if self.n_subsample is not None:
            sample = np.random.default_rng(seed).permutation(self.height * self.width)
            sample = sample[:self.n_subsample]
            self.subsamples.append(sample.tolist())
            self.subsample_index = torch.as_tensor(sample, device=self.device)
            self.target = self.target_full[:, self.subsample_index]
        self._reorient = torch.as_tensor(
            np.asarray(reorient, np.float32), device=self.device)
        self._calibration = torch.tensor(
            [
                [self._delx, 0, 0, self._x0],
                [0, self._dely, 0, self._y0],
                [0, 0, self._sdd, 0],
                [0, 0, 0, 1],
            ],
            dtype=torch.float32,
            device=self.device,
        )

    @property
    def sdd(self) -> float:
        return self._sdd

    @property
    def delx(self) -> float:
        return self._delx

    @property
    def dely(self) -> float:
        return self._dely

    @property
    def x0(self) -> float:
        # Negated calibration entry, as in the JAX package and the reference.
        return -self._x0

    @property
    def y0(self) -> float:
        return -self._y0

    @property
    def reorient(self) -> RigidTransform:
        return RigidTransform(self._reorient)

    @property
    def calibration(self) -> RigidTransform:
        """4x4 matrix rescaling the detector plane to world coordinates."""
        return RigidTransform(self._calibration)

    @property
    def intrinsic(self) -> torch.Tensor:
        return make_intrinsic_matrix(self)

    @property
    def n_rays(self) -> int:
        return self.target.shape[1]

    def __call__(self, extrinsic: RigidTransform,
                 calibration: Optional[RigidTransform] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """World-space (source (B, 1, 3), target (B, N, 3)) for a batch of poses."""
        if calibration is None:
            calibration = self.calibration
        target = calibration(self.target)
        pose = self.reorient.compose(extrinsic)
        return pose(self.source), pose(target)

    forward = __call__

    def full_plane_target(self, extrinsic: RigidTransform,
                          calibration: Optional[RigidTransform] = None) -> torch.Tensor:
        """World-space targets ``(B, H * W, 3)`` of the whole detector frame,
        whatever the subsampling."""
        if calibration is None:
            calibration = self.calibration
        return self.reorient.compose(extrinsic)(calibration(self.target_full))


def get_focal_length(intrinsic, delx: float, dely: float) -> float:
    fx = float(intrinsic[0, 0])
    fy = float(intrinsic[1, 1])
    return abs((fx * delx) + (fy * dely)) / 2.0


def get_principal_point(intrinsic, height: int, width: int, delx: float, dely: float):
    x0 = delx * (float(intrinsic[0, 2]) - width / 2)
    y0 = dely * (float(intrinsic[1, 2]) - height / 2)
    return x0, y0


def parse_intrinsic_matrix(intrinsic, height: int, width: int, delx: float, dely: float):
    """(focal_length, x0, y0) from a 3x3 intrinsic matrix."""
    focal_length = get_focal_length(intrinsic, delx, dely)
    x0, y0 = get_principal_point(intrinsic, height, width, delx, dely)
    return focal_length, x0, y0


def make_intrinsic_matrix(detector: Detector) -> torch.Tensor:
    """3x3 intrinsic matrix from detector parameters."""
    fx = detector.sdd / detector.delx
    fy = detector.sdd / detector.dely
    u0 = detector.x0 / detector.delx + detector.width / 2
    v0 = detector.y0 / detector.dely + detector.height / 2
    return torch.tensor([[fx, 0.0, u0], [0.0, fy, v0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=detector.device)
