"""Cone-beam geometry: poses, detector rays and the CT's voxel frame.

The conventions are upstream DiffDRR's, which the program follows:

  * a pose is Euler angles (convention ``ZXY``: R = Rz(a0) Rx(a1) Ry(a2))
    and a translation t; its 4x4 matrix is ``[[R, R t], [0, 1]]``;
  * the source sits at the origin and the detector plane at z = 1, pixel
    centres in row-major order (rows top to bottom, columns right to left
    when ``reverse_x_axis``), scaled by ``delx``, ``dely`` and ``sdd``;
  * the C-arm is turned by the orientation's 4x4 (``AP``) before the pose;
  * the CT's affine is its spacing, shifted so that the volume's centre is
    the world's origin; rays enter the renderers in voxel coordinates.
"""

from __future__ import annotations

import torch

ORIENTATIONS = {
    "AP": ((1, 0, 0, 0), (0, 0, -1, 0), (0, 1, 0, 0), (0, 0, 0, 1)),
    "PA": ((1, 0, 0, 0), (0, 0, 1, 0), (0, 1, 0, 0), (0, 0, 0, 1)),
}


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    rows = {
        "X": (one, zero, zero, zero, c, -s, zero, s, c),
        "Y": (c, zero, s, zero, one, zero, -s, zero, c),
        "Z": (c, -s, zero, s, c, zero, zero, zero, one),
    }[axis]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def pose_matrix(rotation: torch.Tensor, translation: torch.Tensor,
                convention: str = "ZXY") -> torch.Tensor:
    """(B, 4, 4) pose matrices of Euler angles ``(B, 3)`` and translations ``(B, 3)``."""
    R = (_axis_rotation(convention[0], rotation[:, 0])
         @ _axis_rotation(convention[1], rotation[:, 1])
         @ _axis_rotation(convention[2], rotation[:, 2]))
    t = (R @ translation[:, :, None])[..., 0]
    top = torch.cat([R, t[:, :, None]], dim=-1)
    bottom = torch.zeros_like(top[:, :1])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=1)


def detector_plane(height: int, width: int, reverse_x_axis: bool = True,
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """(H * W, 3) pixel centres on the unit plane z = 1, before scaling."""
    kw = dict(dtype=dtype, device=device)
    rows = -(torch.arange(height, **kw) - (height - 1) / 2.0)
    cols = torch.arange(width, **kw) - (width - 1) / 2.0
    if reverse_x_axis:
        cols = -cols
    t, s = torch.meshgrid(rows, cols, indexing="ij")
    return torch.stack([s.reshape(-1), t.reshape(-1), torch.ones_like(s).reshape(-1)], dim=-1)


def volume_affine(shape, spacing, dtype=torch.float64, device=None) -> torch.Tensor:
    """4x4 voxel-to-world affine of a CT whose centre is the world origin."""
    A = torch.diag(torch.tensor([*spacing, 1.0], dtype=dtype, device=device))
    A[:3, 3] = -torch.tensor([sp * (n - 1) / 2.0 for n, sp in zip(shape, spacing)],
                             dtype=dtype, device=device)
    return A


class Geometry:
    """A detector and a CT frame: ``rays(rotation, translation)`` gives each
    pose's source ``(B, 1, 3)`` and pixel targets ``(B, N, 3)`` in voxel
    coordinates, and the rays' world lengths ``(B, 1, N)``."""

    def __init__(self, *, sdd: float, height: int, width: int, delx: float, dely: float,
                 shape, spacing, orientation: str = "AP", reverse_x_axis: bool = True,
                 convention: str = "ZXY", dtype=torch.float64, device=None):
        kw = dict(dtype=dtype, device=device)
        self.height, self.width, self.convention = height, width, convention
        plane = detector_plane(height, width, reverse_x_axis, **kw)
        scale = torch.tensor([delx, dely, sdd], **kw)
        self.plane = plane * scale  # (N, 3) pixel centres in the C-arm frame
        self.reorient = torch.tensor(ORIENTATIONS[orientation], **kw)
        self.world_to_voxel = torch.linalg.inv(volume_affine(shape, spacing, **kw))
        self.shape = tuple(int(n) for n in shape)

    def rays(self, rotation: torch.Tensor, translation: torch.Tensor, index=None):
        """(source, target, weights) of ``rotation``/``translation (B, 3)``;
        with ``index`` only those pixels' rays."""
        E = pose_matrix(rotation, translation, self.convention) @ self.reorient  # (B, 4, 4)
        M = self.world_to_voxel @ E
        plane = self.plane if index is None else self.plane[index]
        src_world = E[:, :3, 3][:, None, :]
        tgt_world = plane @ E[:, :3, :3].transpose(1, 2) + E[:, None, :3, 3]
        weights = torch.linalg.vector_norm(tgt_world - src_world, dim=-1)[:, None, :]
        source = M[:, :3, 3][:, None, :]
        target = plane @ M[:, :3, :3].transpose(1, 2) + M[:, None, :3, 3]
        return source, target, weights

    def march_axis(self, rotation: torch.Tensor, translation: torch.Tensor) -> int:
        """The voxel axis along which every ray of the batch is least steep
        (the slab march's axis), judged on the detector's four corners."""
        H, W = self.height, self.width
        corners = torch.tensor([0, W - 1, (H - 1) * W, H * W - 1], device=self.plane.device)
        source, target, _ = self.rays(rotation, translation, corners)
        d = (target - source).abs()  # (B, 4, 3)
        worst = []
        for a in range(3):
            others = [b for b in range(3) if b != a]
            worst.append(float((d[..., others].amax(-1) / d[..., a]).max()))
        return int(min(range(3), key=worst.__getitem__)), worst
