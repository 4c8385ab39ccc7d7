"""Camera utilities: resampling under new intrinsics and the pinhole camera.

Counterpart of ``diffdrr_tpu/utils.py``: ``resample`` moves an image to new
intrinsics without rendering again (a bilinear principal-point shift, a
centre crop for a new focal length, padding or cropping for a new pixel
size, with bilinear resizes back to the original size), ``solve_pnp_dlt``
recovers an extrinsic matrix from 3D-2D correspondences by the direct
linear transform, on the host in float64, and ``get_pinhole_camera``
describes a DRR view as a standard pinhole camera (``PinholeCamera``), the
bridge to computer-vision pipelines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .detector import Detector
from .pose import RigidTransform

__all__ = ["resample", "PinholeCamera", "get_pinhole_camera", "solve_pnp_dlt"]


def _resize(img: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize to ``size``, antialiased when shrinking (the JAX
    package's ``jax.image.resize(..., "linear")``)."""
    return F.interpolate(img, size=(int(size[0]), int(size[1])), mode="bilinear",
                         align_corners=False, antialias=True)


def _translate(img: torch.Tensor, tx: float, ty: float) -> torch.Tensor:
    """Shift by (tx, ty) pixels with bilinear interpolation, zero padding."""
    _, _, H, W = img.shape
    ys = torch.arange(H, dtype=img.dtype, device=img.device) - ty
    xs = torch.arange(W, dtype=img.dtype, device=img.device) - tx
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    fy = (ys - y0)[None, None, :, None]
    fx = (xs - x0)[None, None, None, :]

    def take(yi, xi):
        valid = ((yi >= 0) & (yi < H))[:, None] & ((xi >= 0) & (xi < W))[None, :]
        vals = img[:, :, yi.clamp(0, H - 1)][:, :, :, xi.clamp(0, W - 1)]
        return torch.where(valid[None, None], vals, torch.zeros_like(vals))

    return (take(y0, x0) * (1 - fy) * (1 - fx) + take(y0 + 1, x0) * fy * (1 - fx)
            + take(y0, x0 + 1) * (1 - fy) * fx + take(y0 + 1, x0 + 1) * fy * fx)


def _center_crop(img: torch.Tensor, size) -> torch.Tensor:
    _, _, H, W = img.shape
    h, w = int(size[0]), int(size[1])
    top = (H - h) // 2
    left = (W - w) // 2
    if top >= 0 and left >= 0:
        return img[:, :, top:top + h, left:left + w]
    pad_t = max(0, -top)
    pad_l = max(0, -left)
    img = F.pad(img, (pad_l, max(0, w - W - pad_l), pad_t, max(0, h - H - pad_t)))
    return img[:, :, :h, :w]


def resample(img: torch.Tensor, focal_len: float, delx: float, x0: float = 0,
             y0: float = 0, new_focal_len: Optional[float] = None,
             new_delx: Optional[float] = None, new_x0: Optional[float] = None,
             new_y0: Optional[float] = None) -> torch.Tensor:
    """Resample a (B, C, H, W) image to new intrinsics without re-rendering:
    the principal point's pixel shift, a centre crop for the focal length,
    padding (larger pixels) or a centre crop (smaller ones) for the pixel
    size, each followed by a bilinear resize back to (H, W)."""
    new_focal_len = focal_len if new_focal_len is None else new_focal_len
    new_delx = delx if new_delx is None else new_delx
    new_x0 = x0 if new_x0 is None else new_x0
    new_y0 = y0 if new_y0 is None else new_y0

    _, _, height, width = img.shape
    shape = np.array([height, width], np.float64)
    x = _translate(img, (new_x0 - x0) / delx, (new_y0 - y0) / delx)

    crop_size = (shape / (new_focal_len / focal_len)).astype(int)
    x = _resize(_center_crop(x, crop_size), (height, width))

    pixel_scaling = new_delx / delx
    padding = (shape * (pixel_scaling - 1) / 2).astype(int)
    if pixel_scaling >= 1:
        x = F.pad(x, (int(padding[1]), int(padding[1]), int(padding[0]), int(padding[0])))
    else:
        x = _center_crop(x, np.maximum(shape.astype(int) + 2 * padding, 1))
    return _resize(x, (height, width))


def solve_pnp_dlt(world_points: np.ndarray, img_points: np.ndarray,
                  intrinsics: np.ndarray) -> np.ndarray:
    """Direct linear transform PnP: ``[R | t]`` from 3D-2D correspondences.

    Solves for the projection matrix by SVD, fixes its scale and sign (unit
    determinant, points in front of the camera) and projects its left block
    onto SO(3); on the host, in float64. ``world_points`` (B, N, 3),
    ``img_points`` (B, N, 2), ``intrinsics`` (B, 3, 3); returns (B, 3, 4)
    world-to-camera extrinsics.
    """
    world_points = np.asarray(world_points, np.float64)
    img_points = np.asarray(img_points, np.float64)
    intrinsics = np.asarray(intrinsics, np.float64)
    B, N, _ = world_points.shape
    out = np.zeros((B, 3, 4))
    for b in range(B):
        uv1 = np.concatenate([img_points[b], np.ones((N, 1))], axis=1)
        xn = (np.linalg.inv(intrinsics[b]) @ uv1.T).T[:, :2]
        X = np.concatenate([world_points[b], np.ones((N, 1))], axis=1)
        A = np.zeros((2 * N, 12))
        A[0::2, 0:4] = X
        A[0::2, 8:12] = -xn[:, 0:1] * X
        A[1::2, 4:8] = X
        A[1::2, 8:12] = -xn[:, 1:2] * X
        P = np.linalg.svd(A)[2][-1].reshape(3, 4)

        det = np.linalg.det(P[:, :3])
        scale = np.cbrt(det) if det != 0 else np.linalg.norm(P[0, :3])
        P = P / (scale if scale != 0 else 1.0)
        if np.median(P[2, :3] @ world_points[b].T + P[2, 3]) < 0:
            P = -P
        U, _, Vt = np.linalg.svd(P[:, :3])
        R = U @ Vt
        if np.linalg.det(R) < 0:
            R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
        s = np.trace(R.T @ P[:, :3]) / 3.0
        out[b, :, :3] = R
        out[b, :, 3] = P[:, 3] / s
    return out


class PinholeCamera:
    """A pinhole camera in Hartley and Zisserman's conventions: (B, 4, 4)
    intrinsics and world-to-camera extrinsics as NumPy arrays."""

    def __init__(self, intrinsics: np.ndarray, extrinsics: np.ndarray, height, width,
                 detector: Detector, subject):
        self.intrinsics = np.asarray(intrinsics)
        self.extrinsics = np.asarray(extrinsics)
        self.height = np.atleast_1d(np.asarray(height))
        self.width = np.atleast_1d(np.asarray(width))
        multiplier = -1 if subject.orientation == "PA" else 1
        self.sdd = multiplier * detector.sdd
        self.delx = detector.delx
        self.dely = detector.dely
        self.x0 = detector.x0
        self.y0 = detector.y0

    @property
    def fx(self):
        return self.intrinsics[:, 0, 0]

    @property
    def fy(self):
        return self.intrinsics[:, 1, 1]

    @property
    def cx(self):
        return self.intrinsics[:, 0, 2]

    @property
    def cy(self):
        return self.intrinsics[:, 1, 2]

    @property
    def camera_matrix(self):
        return self.intrinsics[:, :3, :3]

    @property
    def rotation_matrix(self):
        return self.extrinsics[:, :3, :3]

    @property
    def translation_vector(self):
        return self.extrinsics[:, :3, 3:]

    @property
    def center(self):
        """The camera centre ``-R^T t``."""
        R = self.extrinsics[:, :3, :3]
        t = self.extrinsics[:, :3, 3:]
        return (-np.swapaxes(R, -1, -2) @ t)[..., 0]

    @property
    def projmat(self):
        """(B, 3, 4) camera matrix."""
        return (self.intrinsics @ self.extrinsics)[:, :3]

    @property
    def pose(self) -> RigidTransform:
        """The camera-to-world pose (the extrinsics' inverse), a CPU
        ``RigidTransform`` usable as a DRR pose once moved to its device."""
        return RigidTransform(torch.tensor(self.extrinsics, dtype=torch.float32)).inverse()


def get_pinhole_camera(drr, pose: RigidTransform, dtype=np.float64) -> PinholeCamera:
    """The pinhole camera of a DRR view: the pixel intrinsic matrix (focal
    lengths negated for an AP subject), and the extrinsics solved by
    ``solve_pnp_dlt`` from the volume's eight bounding-box corners and their
    ``drr.perspective_projection``."""
    det = drr.detector
    multiplier = -1 if drr.subject.orientation == "AP" else 1
    fx = multiplier * det.sdd / det.delx
    fy = multiplier * det.sdd / det.dely
    u0 = det.x0 / det.delx + det.width / 2
    v0 = det.y0 / det.dely + det.height / 2
    intrinsics = np.array([[[fx, 0.0, u0, 0.0], [0.0, fy, v0, 0.0], [0.0, 0.0, 1.0, 0.0],
                            [0.0, 0.0, 0.0, 1.0]]], dtype)

    (xmin, xmax), (ymin, ymax), (zmin, zmax) = drr.subject.volume.get_bounds()
    X = np.array([[[xmin, ymin, zmin], [xmax, ymin, zmin], [xmin, ymax, zmin],
                   [xmax, ymax, zmin], [xmin, ymin, zmax], [xmax, ymin, zmax],
                   [xmin, ymax, zmax], [xmax, ymax, zmax]]], dtype)
    with torch.no_grad():
        x = drr.perspective_projection(
            pose, torch.tensor(X, dtype=torch.float32, device=drr.device)).cpu().numpy()

    extrinsics = np.eye(4, dtype=dtype)[None]
    extrinsics[:, :3, :] = solve_pnp_dlt(X, x, intrinsics[..., :3, :3])
    return PinholeCamera(intrinsics.astype(np.float32), extrinsics.astype(np.float32),
                         np.array([det.height]), np.array([det.width]), det, drr.subject)
