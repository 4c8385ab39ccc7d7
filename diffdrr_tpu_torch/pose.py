"""SE(3) pose algebra in PyTorch.

Counterpart of ``diffdrr_tpu/pose.py``: batched (B, 4, 4) rigid transforms,
the rotation parameterizations, and the so(3)/se(3) exp/log maps, all
differentiable by autograd. Conventions are the JAX package's (and the
reference DiffDRR's):

  * rotation matrices act on column vectors, ``y = R @ x``;
  * quaternions are real-first ``(w, x, y, z)``;
  * ``convert`` stores the camera-center convention, ``t_matrix = R @ t``;
  * Euler angles are 3-letter conventions over {X, Y, Z}, composed as
    ``R(c0, a0) @ R(c1, a1) @ R(c2, a2)``;
  * the SE(3) log is laid out ``[nu (translation), omega (rotation)]``.

Two conversions carry their own backward, as ``torch.autograd.Function``s,
the transposes of the JAX package's custom JVPs: ``special_procrustes``
(``rotation_9d``), whose backward solves a Lyapunov system instead of
differentiating the SVD (that divides by differences of singular values,
NaN at every rotation matrix), and ``_smallest_eigvec4`` (``rotation_10d``),
whose forward is an 8-sweep cyclic Jacobi eigensolver (the JAX package's,
so both packages give the same eigenvector) and whose backward is the
simple-eigenvector perturbation formula.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import math

import torch

__all__ = [
    "RigidTransform",
    "convert",
    "make_matrix",
    "random_rigid_transform",
    "PARAMETERIZATIONS",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "standardize_quaternion",
    "quaternion_multiply",
    "quaternion_invert",
    "quaternion_apply",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "rotation_6d_to_matrix",
    "matrix_to_rotation_6d",
    "rotation_9d_to_matrix",
    "matrix_to_rotation_9d",
    "rotation_10d_to_quaternion",
    "quaternion_to_rotation_10d",
    "quaternion_adjugate_to_quaternion",
    "quaternion_to_quaternion_adjugate",
    "hat",
    "hat_inv",
    "so3_exp_map",
    "so3_log_map",
    "so3_rotation_angle",
    "so3_relative_angle",
    "se3_exp_map",
    "se3_log_map",
    "acos_linear_extrapolation",
]

PARAMETERIZATIONS = [
    "axis_angle",
    "euler_angles",
    "matrix",
    "quaternion",
    "quaternion_adjugate",
    "rotation_6d",
    "rotation_9d",
    "rotation_10d",
    "se3_log_map",
]

# -----------------------------------------------------------------------------
# Small numerics helpers
# -----------------------------------------------------------------------------

_DEFAULT_ACOS_BOUND = 1.0 - 1e-4


def acos_linear_extrapolation(
    x: torch.Tensor,
    bounds: Tuple[float, float] = (-_DEFAULT_ACOS_BOUND, _DEFAULT_ACOS_BOUND),
) -> torch.Tensor:
    """arccos, linearly extrapolated outside ``bounds`` for finite gradients."""
    lo, hi = bounds
    acos_mid = torch.arccos(torch.clamp(x, lo, hi))

    def _dacos(b):
        return -1.0 / math.sqrt(1.0 - b * b)

    lower = math.acos(lo) + _dacos(lo) * (x - lo)
    upper = math.acos(hi) + _dacos(hi) * (x - hi)
    return torch.where(x < lo, lower, torch.where(x > hi, upper, acos_mid))


def _safe_normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    positive = x > 0
    safe = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(x))


# -----------------------------------------------------------------------------
# Quaternions
# -----------------------------------------------------------------------------


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    real = point.new_zeros(point.shape[:-1] + (1,))
    pq = torch.cat([real, point], dim=-1)
    out = quaternion_raw_multiply(quaternion_raw_multiply(q, pq), quaternion_invert(q))
    return out[..., 1:]


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Real-first (possibly unnormalized) quaternion -> rotation matrix."""
    r, i, j, k = torch.unbind(q, -1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> standardized real-first quaternion.

    Four-candidate construction, keeping the best-conditioned denominator.
    """
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    batch_dim = matrix.shape[:-2]
    m = matrix.reshape(batch_dim + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m, -1)

    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(batch_dim + (1, 4))
    out = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    return standardize_quaternion(out)


# -----------------------------------------------------------------------------
# Axis-angle
# -----------------------------------------------------------------------------


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    angles = torch.sqrt(torch.clamp(sq, min=1e-30))
    half = angles * 0.5
    small = angles < 1e-6
    # sin(x/2)/x ~= 1/2 - x^2/48 for small x
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    factor = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / safe_angles)
    return torch.cat([torch.cos(half), axis_angle * factor], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    norms = torch.sqrt(torch.clamp(sq, min=1e-30))
    half = torch.atan2(norms, q[..., :1])
    angles = 2.0 * half
    small = torch.abs(angles) < 1e-6
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    factor = torch.where(small, 0.5 - angles * angles / 48.0,
                         torch.sin(half) / safe_angles)
    return q[..., 1:] / factor


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


# -----------------------------------------------------------------------------
# Euler angles
# -----------------------------------------------------------------------------

_AXIS_INDEX = {"X": 0, "Y": 1, "Z": 2}


def _single_axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError("letter must be either X, Y or Z.")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3:
        raise ValueError("Convention must have 3 letters.")
    if convention[1] in (convention[0], convention[2]):
        raise ValueError(f"Invalid convention {convention}.")
    for letter in convention:
        if letter not in ("X", "Y", "Z"):
            raise ValueError(f"Invalid letter {letter} in convention string.")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """R = R(c0, a0) @ R(c1, a1) @ R(c2, a2)."""
    if euler_angles.dim() == 0 or euler_angles.shape[-1] != 3:
        raise ValueError("Invalid input euler angles.")
    _check_convention(convention)
    mats = [_single_axis_rotation(c, euler_angles[..., i])
            for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor,
                    horizontal: bool, tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """Inverse of :func:`euler_angles_to_matrix`."""
    _check_convention(convention)
    if matrix.shape[-1] != 3 or matrix.shape[-2] != 3:
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    i0 = _AXIS_INDEX[convention[0]]
    i2 = _AXIS_INDEX[convention[2]]
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in [-1, 2] else 1.0
        central = torch.arcsin(torch.clamp(matrix[..., i0, i2] * sign, -1, 1))
    else:
        central = torch.arccos(torch.clamp(matrix[..., i0, i0], -1, 1))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


# -----------------------------------------------------------------------------
# 6d / 9d / 10d rotation representations
# -----------------------------------------------------------------------------


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D -> rotation matrix via Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _safe_normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _safe_normalize(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


class _SpecialProcrustes(torch.autograd.Function):
    """Project (..., 3, 3) matrices onto SO(3): ``U diag(1, 1, det(U V^T)) V^T``.

    The backward is the transpose of the JAX package's custom JVP, which
    solves ``Omega S + S Omega = A - A^T`` (``S = sym(R^T m)``, ``A = R^T dm``)
    in the eigenbasis of ``S``, dividing only by sums of its eigenvalues
    (floored at 1e-8): given ``G = dL/dR``, ``Bq = (Q^T R^T G Q) / denom``,
    ``B = Q Bq Q^T`` and ``dL/dm = R (B - B^T)``.
    """

    @staticmethod
    def forward(ctx, m):
        u, _, vt = torch.linalg.svd(m, full_matrices=False)
        det = torch.linalg.det(u @ vt)[..., None, None]
        vt = torch.cat([vt[..., :2, :], det * vt[..., -1:, :]], dim=-2)
        R = u @ vt
        ctx.save_for_backward(R, m)
        return R

    @staticmethod
    def backward(ctx, G):
        R, m = ctx.saved_tensors
        S = R.transpose(-1, -2) @ m
        S = (S + S.transpose(-1, -2)) / 2
        lam, Q = torch.linalg.eigh(S)
        denom = lam[..., :, None] + lam[..., None, :]
        denom = torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, 1e-8), denom)
        Oq_bar = Q.transpose(-1, -2) @ (R.transpose(-1, -2) @ G) @ Q
        B_bar = Q @ (Oq_bar / denom) @ Q.transpose(-1, -2)
        return R @ (B_bar - B_bar.transpose(-1, -2))


def special_procrustes(m: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to each (..., 3, 3) matrix, with a backward finite at
    rotations (see :class:`_SpecialProcrustes`)."""
    return _SpecialProcrustes.apply(m)


def rotation_9d_to_matrix(rotation: torch.Tensor) -> torch.Tensor:
    """9-vector -> SO(3) by symmetric orthogonalization (Levinson et al.)."""
    return special_procrustes(rotation.reshape(rotation.shape[:-1] + (3, 3)))


def matrix_to_rotation_9d(matrix: torch.Tensor) -> torch.Tensor:
    return matrix.reshape(matrix.shape[:-2] + (9,))


_TRIU_I, _TRIU_J = [0, 0, 0, 0, 1, 1, 1, 2, 2, 3], [0, 1, 2, 3, 1, 2, 3, 2, 3, 3]
# Entry (i, j) of the symmetric 4x4 is element _SYM4[i][j] of the 10-vector.
_SYM4 = [0, 1, 2, 3, 1, 4, 5, 6, 2, 5, 7, 8, 3, 6, 8, 9]


def _10vec_to_4x4symmetric(vec: torch.Tensor) -> torch.Tensor:
    """10-vector (the upper triangle, row by row) -> symmetric 4x4."""
    return vec[..., _SYM4].reshape(vec.shape[:-1] + (4, 4))


_JACOBI_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _jacobi_eigh4(A: torch.Tensor, sweeps: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic Jacobi eigendecomposition of batched symmetric 4x4 matrices.

    The JAX package's solver, rotation for rotation: ``sweeps`` sweeps over
    ``_JACOBI_PAIRS``, each rotation by ``0.5 * atan2(2 a_pq, a_qq - a_pp)``
    followed by a symmetrisation, then a stable ascending sort. Returns
    ``(eigenvalues ascending, eigenvectors as columns)``.
    """
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape)
    for _ in range(sweeps):
        for p, q in _JACOBI_PAIRS:
            theta = 0.5 * torch.atan2(2.0 * A[..., p, q], A[..., q, q] - A[..., p, p])
            c = torch.cos(theta)[..., None, None]
            s = torch.sin(theta)[..., None, None]
            ep, eq = eye[p], eye[q]
            Ppq = ep[:, None] * ep[None, :] + eq[:, None] * eq[None, :]
            Rot = (eye - Ppq + c * Ppq + s * (ep[:, None] * eq[None, :])
                   - s * (eq[:, None] * ep[None, :]))
            A = Rot.transpose(-1, -2) @ A @ Rot
            A = (A + A.transpose(-1, -2)) * 0.5
            V = V @ Rot
    lam = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(lam, dim=-1, stable=True)
    lam = torch.gather(lam, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return lam, V


class _SmallestEigvec4(torch.autograd.Function):
    """Unit eigenvector of the smallest eigenvalue of symmetric 4x4 ``A``.

    The backward is the transpose of the JAX package's custom JVP
    ``dv0 = sum_{j>0} (v_j^T sym(dA) v0) / (lam_0 - lam_j) v_j``: given
    ``g``, ``c = V^T g`` with ``c_0 = 0``, ``w = V (c / gap)`` (the gap
    floored at +-1e-6) and ``dL/dA = sym(w v0^T)``.
    """

    @staticmethod
    def forward(ctx, A):
        lam, V = _jacobi_eigh4(A)
        ctx.save_for_backward(lam, V)
        return V[..., 0]

    @staticmethod
    def backward(ctx, g):
        lam, V = ctx.saved_tensors
        gap = lam[..., 0:1] - lam
        floor = torch.where(gap < 0, torch.full_like(gap, -1e-6), torch.full_like(gap, 1e-6))
        gap = torch.where(torch.abs(gap) < 1e-6, floor, gap)
        c = torch.einsum("...ij,...i->...j", V, g)
        c = torch.cat([torch.zeros_like(c[..., :1]), c[..., 1:]], dim=-1)
        w = torch.einsum("...ij,...j->...i", V, c / gap)
        outer = w[..., :, None] * V[..., None, :, 0]
        return (outer + outer.transpose(-1, -2)) * 0.5


def rotation_10d_to_quaternion(rotation: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of the symmetric 4x4 the
    10-vector fills (Peretroukhin et al.), by the Jacobi solver."""
    return _SmallestEigvec4.apply(_10vec_to_4x4symmetric(rotation))


def quaternion_to_rotation_10d(q: torch.Tensor) -> torch.Tensor:
    A = -torch.einsum("...i,...j->...ij", q, q)
    return A[..., _TRIU_I, _TRIU_J]


def quaternion_adjugate_to_quaternion(rotation: torch.Tensor) -> torch.Tensor:
    """The row of the quaternion adjugate whose column norm is largest,
    divided by that norm (https://arxiv.org/abs/2205.09116)."""
    A = _10vec_to_4x4symmetric(rotation)
    row_norms = torch.linalg.vector_norm(A, dim=-2)  # each column's norm
    norms = torch.amax(row_norms, dim=-1, keepdim=True)
    best = torch.argmax(row_norms, dim=-1)
    rows = torch.gather(A, -2, best[..., None, None].expand(A.shape[:-2] + (1, 4)))[..., 0, :]
    return rows / norms


def quaternion_to_quaternion_adjugate(q: torch.Tensor) -> torch.Tensor:
    A = torch.einsum("...i,...j->...ij", q, q)
    return A[..., _TRIU_I, _TRIU_J]


# -----------------------------------------------------------------------------
# so(3) / se(3)
# -----------------------------------------------------------------------------


def hat(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix."""
    x, y, z = torch.unbind(v, -1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def hat_inv(h: torch.Tensor) -> torch.Tensor:
    return torch.stack([h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]], dim=-1)


def so3_exp_map(log_rot: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return axis_angle_to_matrix(log_rot)


def so3_log_map(R: torch.Tensor, eps: float = 1e-4, cos_bound: float = 1e-4) -> torch.Tensor:
    """Rotation matrix -> axis-angle via the quaternion path."""
    return matrix_to_axis_angle(R)


def so3_rotation_angle(R: torch.Tensor, eps: float = 1e-4, cos_angle: bool = False,
                       cos_bound: float = 1e-4) -> torch.Tensor:
    rot_trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    phi_cos = (rot_trace - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if cos_bound > 0.0:
        bound = 1.0 - cos_bound
        return acos_linear_extrapolation(phi_cos, (-bound, bound))
    return torch.arccos(phi_cos)


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor, cos_angle: bool = False,
                       cos_bound: float = 1e-4, eps: float = 1e-4) -> torch.Tensor:
    R12 = torch.einsum("...ij,...kj->...ik", R1, R2)
    return so3_rotation_angle(R12, eps=eps, cos_angle=cos_angle, cos_bound=cos_bound)


def _se3_V_matrix(omega: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """V(omega) = I + (1-cos t)/t^2 hat(w) + (t - sin t)/t^3 hat(w)^2."""
    nrms = torch.sum(omega * omega, dim=-1)
    t = torch.sqrt(torch.clamp(nrms, min=eps))
    h = hat(omega)
    h2 = h @ h
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(h.shape)
    a = ((1.0 - torch.cos(t)) / (t * t))[..., None, None]
    b = ((t - torch.sin(t)) / (t * t * t))[..., None, None]
    return eye + a * h + b * h2


def se3_exp_map(log_transform: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """[nu, omega] (B, 6) -> (B, 4, 4) matrices [[exp(hat(w)), V nu], [0, 1]]."""
    if log_transform.dim() != 2 or log_transform.shape[-1] != 6:
        raise ValueError("Expected input to be of shape (N, 6).")
    nu = log_transform[..., :3]
    omega = log_transform[..., 3:]
    R = axis_angle_to_matrix(omega)
    V = _se3_V_matrix(omega, eps=eps)
    t = torch.einsum("...ij,...j->...i", V, nu)
    return make_matrix(R, t)


def se3_log_map(transform: torch.Tensor, eps: float = 1e-4,
                cos_bound: float = 1e-4) -> torch.Tensor:
    """(B, 4, 4) pose matrices -> (B, 6) logs [nu, omega]."""
    R = transform[..., :3, :3]
    t = transform[..., :3, 3]
    omega = so3_log_map(R)
    V = _se3_V_matrix(omega, eps=eps)
    nu = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([nu, omega], dim=-1)


# -----------------------------------------------------------------------------
# RigidTransform
# -----------------------------------------------------------------------------


def make_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [[R, t], [0, 1]] batched."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _is_orthonormal(matrix: torch.Tensor, eps: float) -> torch.Tensor:
    R = matrix[..., :3, :3]
    should_be_eye = torch.einsum("...ij,...kj->...ik", R, R)
    eye = torch.eye(3, dtype=matrix.dtype, device=matrix.device)
    return torch.all(torch.abs(should_be_eye - eye) < eps)


class RigidTransform:
    """Batched SE(3) transforms stored as (B, 4, 4) homogeneous matrices."""

    def __init__(self, matrix: Union[torch.Tensor, "RigidTransform"], eps: float = 1e-6):
        if isinstance(matrix, RigidTransform):
            matrix = matrix.matrix
        if matrix.dim() == 2:
            matrix = matrix[None]
        self.matrix = matrix
        self.eps = eps

    def __len__(self):
        return self.matrix.shape[0]

    def __getitem__(self, idx):
        m = self.matrix[idx]
        if m.dim() == 2:
            m = m[None]
        return RigidTransform(m, self.eps)

    def __matmul__(self, T: "RigidTransform") -> "RigidTransform":
        # (A @ B).matrix == A.matrix @ B.matrix
        return T.compose(self)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the transform(s) to a pointcloud (..., N, 3)."""
        R = self.matrix[..., :3, :3]
        t = self.matrix[..., :3, 3]
        if x.dim() == 2:  # (N, 3) -> broadcast over batch
            return torch.einsum("bij,nj->bni", R, x) + t[:, None, :]
        return torch.einsum("bij,bnj->bni", R, x) + t[:, None, :]

    forward = __call__

    @property
    def rotation(self) -> torch.Tensor:
        return self.matrix[..., :3, :3]

    @property
    def translation(self) -> torch.Tensor:
        return self.matrix[..., :3, 3]

    @property
    def dtype(self):
        return self.matrix.dtype

    @property
    def device(self):
        return self.matrix.device

    @property
    def shape(self):
        return self.matrix.shape

    def to(self, *args, **kwargs) -> "RigidTransform":
        return RigidTransform(self.matrix.to(*args, **kwargs), self.eps)

    def astype(self, dtype) -> "RigidTransform":
        """The transform with its matrices cast to ``dtype`` (the JAX
        package's name for ``to(dtype)``)."""
        return RigidTransform(self.matrix.to(dtype), self.eps)

    def inverse(self) -> "RigidTransform":
        """Closed-form inverse for orthonormal rotations, solve otherwise.

        Both branches are computed and selected with ``torch.where`` on the
        orthonormality test, so the choice needs no host synchronisation.
        """
        R = self.matrix[..., :3, :3]
        t = self.matrix[..., :3, 3]
        Rinv = R.transpose(-1, -2)
        tinv = -torch.einsum("...ij,...j->...i", Rinv, t)
        fast = make_matrix(Rinv, tinv)
        ortho = _is_orthonormal(self.matrix, self.eps)
        general = torch.linalg.inv(self.matrix)
        return RigidTransform(torch.where(ortho, fast, general), self.eps)

    def compose(self, T: "RigidTransform") -> "RigidTransform":
        """Returns the transform ``x -> T(self(x))``."""
        return RigidTransform(
            torch.einsum("bij,bjk->bik", T.matrix, self.matrix), self.eps)

    def convert(self, parameterization: str, convention: Optional[str] = None,
                degrees: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Export ``(rotation_repr, translation)`` in any parameterization.

        ``translation`` is the camera-frame ``t`` whose stored matrix
        translation is ``R @ t``, the inverse of :func:`convert`.
        """
        translation = -self.inverse().translation
        R = self.matrix[..., :3, :3]
        if parameterization == "axis_angle":
            rotation = matrix_to_axis_angle(R)
        elif parameterization == "euler_angles":
            rotation = matrix_to_euler_angles(R, convention)
            if degrees:
                rotation = rotation / math.pi * 180.0
        elif parameterization == "matrix":
            rotation = R
        elif parameterization == "quaternion":
            rotation = standardize_quaternion(matrix_to_quaternion(R))
        elif parameterization == "quaternion_adjugate":
            rotation = quaternion_to_quaternion_adjugate(matrix_to_quaternion(R))
        elif parameterization == "rotation_6d":
            rotation = matrix_to_rotation_6d(R)
        elif parameterization == "rotation_9d":
            rotation = matrix_to_rotation_9d(R)
        elif parameterization == "rotation_10d":
            rotation = quaternion_to_rotation_10d(matrix_to_quaternion(R))
        elif parameterization == "se3_log_map":
            params = self.get_se3_log()
            rotation = params[..., 3:]
            translation = params[..., :3]
        else:
            raise ValueError(f"Must be in {PARAMETERIZATIONS}, not {parameterization}")
        return rotation, translation

    def get_se3_log(self) -> torch.Tensor:
        return se3_log_map(self.matrix)

    def __repr__(self):
        return f"RigidTransform(matrix={self.matrix!r})"


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.dim() == 1 else x


def convert(*args, parameterization: str, convention: Optional[str] = None,
            degrees: bool = False) -> RigidTransform:
    """Build a :class:`RigidTransform` from any parameterization.

    For every rotational parameterization except ``se3_log_map`` the stored
    matrix translation is ``R @ t`` (the camera-center convention).
    """
    if parameterization == "euler_angles" and convention is None:
        raise ValueError(
            "convention for Euler angles must be specified as a 3 letter "
            "combination of [X, Y, Z]")

    if parameterization == "matrix":
        m = args[0]
        if len(args) == 1 and m.shape[-2:] == (4, 4):
            return RigidTransform(m)
        rotmat = m[None] if m.dim() == 2 else m
        translation = _as_2d(args[1])
        camera_center = torch.einsum("bij,bj->bi", rotmat, translation)
        return RigidTransform(make_matrix(rotmat, camera_center))

    if parameterization == "se3_log_map":
        rotation, translation = args
        params = torch.cat([_as_2d(translation), _as_2d(rotation)], dim=-1)
        return RigidTransform(se3_exp_map(params))

    rotation, translation = args
    rotation = _as_2d(rotation)
    translation = _as_2d(translation)

    if parameterization == "axis_angle":
        rotmat = axis_angle_to_matrix(rotation)
    elif parameterization == "euler_angles":
        if degrees:
            rotation = rotation / 180.0 * math.pi
        rotmat = euler_angles_to_matrix(rotation, convention)
    elif parameterization == "quaternion":
        rotmat = quaternion_to_matrix(rotation)
    elif parameterization == "quaternion_adjugate":
        rotmat = quaternion_to_matrix(quaternion_adjugate_to_quaternion(rotation))
    elif parameterization == "rotation_6d":
        rotmat = rotation_6d_to_matrix(rotation)
    elif parameterization == "rotation_9d":
        rotmat = rotation_9d_to_matrix(rotation)
    elif parameterization == "rotation_10d":
        rotmat = quaternion_to_matrix(rotation_10d_to_quaternion(rotation))
    else:
        raise ValueError(f"Must be in {PARAMETERIZATIONS}, not {parameterization}")

    camera_center = torch.einsum("bij,bj->bi", rotmat, translation)
    return RigidTransform(make_matrix(rotmat, camera_center))


def random_rigid_transform(generator: torch.Generator, batch_size: int = 1,
                           translation_scale: float = 100.0) -> RigidTransform:
    """A random SE(3) sample on ``generator``'s device: a normalised
    Gaussian quaternion and a Gaussian translation of ``translation_scale``."""
    device = generator.device
    q = _safe_normalize(torch.randn(batch_size, 4, generator=generator, device=device))
    t = translation_scale * torch.randn(batch_size, 3, generator=generator, device=device)
    return RigidTransform(make_matrix(quaternion_to_matrix(q), t))
