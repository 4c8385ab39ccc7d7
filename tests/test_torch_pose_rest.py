"""The port's rotation_9d, rotation_10d and quaternion_adjugate against
``diffdrr_tpu.pose``, values and gradients, and ``random_rigid_transform``.

Inputs are seeded NumPy float32 arrays fed to both packages. Values: the
rotation matrices of ``convert`` to atol 1e-5 (translations rtol 1e-5).
Gradients: the port's ``torch.autograd.Function`` backwards against
``jax.vjp`` of the JAX package's functions (its custom JVPs, transposed by
JAX) under the same random cotangent, to atol 1e-4 * max|g|, at generic
inputs and at near-identity ones, where the SVD's own gradient is NaN (all
singular values equal). The Jacobi cases are ``tests/test_pose.py``'s: the
eigenvector to 2e-6 of float64 ``numpy.linalg.eigh`` and the backward
against central differences.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import diffdrr_tpu.pose as jp
import diffdrr_tpu_torch.pose as tp

PARAMS = {"rotation_9d": 9, "rotation_10d": 10, "quaternion_adjugate": 10}
# The conversion each parameterization's gradient runs through.
FUNCS = {"rotation_9d": "rotation_9d_to_matrix", "rotation_10d": "rotation_10d_to_quaternion",
         "quaternion_adjugate": "quaternion_adjugate_to_quaternion"}


def _wxyz(q_xyzw):
    return np.concatenate([q_xyzw[:, 3:], q_xyzw[:, :3]], axis=1).astype(np.float32)


def _near_identity(parameterization, rng, exact):
    """Representations of rotations within 1e-3 rad of the identity (and of
    the identity itself when ``exact``), lightly perturbed as a network's
    outputs are."""
    rotvec = rng.normal(0, 1e-3, (4, 3))
    if exact:
        rotvec[0] = 0.0
    q = jnp.asarray(_wxyz(Rotation.from_rotvec(rotvec).as_quat()))
    rep = {"rotation_9d": lambda: jp.quaternion_to_matrix(q).reshape(-1, 9),
           "rotation_10d": lambda: jp.quaternion_to_rotation_10d(q),
           "quaternion_adjugate": lambda: jp.quaternion_to_quaternion_adjugate(q)}
    return np.asarray(rep[parameterization](), np.float32)


@pytest.mark.parametrize("parameterization", list(PARAMS))
def test_convert_values_match_jax(parameterization):
    rng = np.random.default_rng(zlib.crc32(parameterization.encode()))
    rot = rng.normal(size=(5, PARAMS[parameterization])).astype(np.float32)
    trans = rng.uniform(-200, 200, (5, 3)).astype(np.float32)
    kw = dict(parameterization=parameterization)
    jm = np.asarray(jp.convert(jnp.asarray(rot), jnp.asarray(trans), **kw).matrix)
    tm = tp.convert(torch.tensor(rot), torch.tensor(trans), **kw).matrix.numpy()
    np.testing.assert_allclose(tm[:, :3, :3], jm[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(tm[:, :3, 3], jm[:, :3, 3], rtol=1e-5, atol=1e-4)
    R = tm[:, :3, :3]
    np.testing.assert_allclose(np.einsum("bij,bik->bjk", R, R), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


@pytest.mark.parametrize("inputs", ["generic", "near_identity"])
@pytest.mark.parametrize("parameterization", list(PARAMS))
def test_backward_matches_jax_vjp(parameterization, inputs):
    """The backward of each conversion under a random cotangent equals
    ``jax.vjp`` of the JAX function. At near-identity inputs the 9d and 10d
    ones include the exact identity; the adjugate's leaves it out, where a
    column of its matrix is 0 and the JAX package's norm gradient is NaN."""
    rng = np.random.default_rng(zlib.crc32(f"{parameterization}{inputs}".encode()))
    if inputs == "generic":
        x = rng.normal(size=(6, PARAMS[parameterization])).astype(np.float32)
    else:
        x = _near_identity(parameterization, rng, exact=parameterization != "quaternion_adjugate")
    name = FUNCS[parameterization]
    jout, vjp = jax.vjp(getattr(jp, name), jnp.asarray(x))
    ct = rng.normal(size=jout.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)

    xt = torch.tensor(x, requires_grad=True)
    out = getattr(tp, name)(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    out.backward(torch.tensor(ct))
    got = xt.grad.numpy()
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_gradients_finite_at_identity_through_convert():
    """``convert`` at the identity rotation (a registration's common start),
    where an SVD's or eigh's own gradient divides by zero gaps."""
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    for parameterization in ("rotation_9d", "rotation_10d"):
        rot = tp.RigidTransform(torch.eye(4)[None]).convert(parameterization)[0]
        rot = rot.clone().requires_grad_(True)
        trans = torch.tensor([[1.0, 2.0, 3.0]], requires_grad=True)
        m = tp.convert(rot, trans, parameterization=parameterization).matrix
        torch.sum(m ** 2).backward()
        assert torch.isfinite(rot.grad).all() and torch.isfinite(trans.grad).all()
        np.testing.assert_allclose(m[0, :3, :3].detach(), tp.quaternion_to_matrix(q)[0], atol=1e-6)


def test_10d_and_adjugate_sign_invariance():
    """``tests/test_pose.py``'s case: the quaternion a 10-vector or an
    adjugate gives back is the rotation's (up to sign)."""
    q = torch.tensor(_wxyz(Rotation.random(5, random_state=10).as_quat()))
    for back in (tp.rotation_10d_to_quaternion(tp.quaternion_to_rotation_10d(q)),
                 tp.quaternion_adjugate_to_quaternion(tp.quaternion_to_quaternion_adjugate(q))):
        np.testing.assert_allclose(tp.quaternion_to_matrix(back), tp.quaternion_to_matrix(q),
                                   atol=1e-4)


def test_rotation_10d_jacobi_accuracy_and_grad():
    """``tests/test_pose.py``'s case: the Jacobi eigenvector against float64
    ``numpy.linalg.eigh`` (to 2e-6, up to sign), on exact and noisy
    10-vectors, equal to the JAX package's solver; and the backward against
    central differences of a random linear functional."""
    rng = np.random.default_rng(42)
    q = _wxyz(Rotation.random(16, random_state=5).as_quat())
    ten = tp.quaternion_to_rotation_10d(torch.tensor(q)).numpy()
    ten_noisy = ten + rng.normal(0, 0.05, ten.shape).astype(np.float32)
    for t in (ten, ten_noisy):
        ours = tp.rotation_10d_to_quaternion(torch.tensor(t)).numpy()
        A = tp._10vec_to_4x4symmetric(torch.tensor(t, dtype=torch.float64)).numpy()
        truth = np.linalg.eigh(A)[1][..., 0]
        sgn = np.sign(np.sum(ours * truth, -1, keepdims=True))
        sgn[sgn == 0] = 1
        np.testing.assert_allclose(ours, sgn * truth, atol=2e-6)
        np.testing.assert_allclose(ours, np.asarray(jp.rotation_10d_to_quaternion(jnp.asarray(t))),
                                   atol=1e-6)

    t0 = ten_noisy[0]
    w = rng.normal(size=4)
    x = torch.tensor(t0, requires_grad=True)
    torch.sum(tp.rotation_10d_to_quaternion(x) * torch.tensor(w, dtype=torch.float32)).backward()
    eps = 1e-3
    fd = np.empty(10)
    for i in range(10):
        e = np.zeros(10, np.float32)
        e[i] = eps
        up = tp.rotation_10d_to_quaternion(torch.tensor(t0 + e)).double().numpy() @ w
        down = tp.rotation_10d_to_quaternion(torch.tensor(t0 - e)).double().numpy() @ w
        fd[i] = (up - down) / (2 * eps)
    np.testing.assert_allclose(x.grad.numpy(), fd, atol=5e-3)


def test_special_procrustes_matches_jax_batched():
    """Batched (2, 3, 3, 3) matrices, one with a negative determinant (the
    det fix flips the last row of V^T): value and backward against JAX."""
    rng = np.random.default_rng(3)
    m = rng.normal(size=(2, 3, 3, 3)).astype(np.float32)
    if np.linalg.det(m[0, 0]) > 0:
        m[0, 0, 0] *= -1
    jout, vjp = jax.vjp(jp.special_procrustes, jnp.asarray(m))
    ct = rng.normal(size=m.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(ct))
    x = torch.tensor(m, requires_grad=True)
    out = tp.special_procrustes(x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(out.detach().numpy()), 1.0, atol=1e-5)
    out.backward(torch.tensor(ct))
    ref = np.asarray(ref)
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def test_random_rigid_transform():
    """Valid rigid transforms, reproducible from the generator's seed, with
    the translation's scale."""
    T1 = tp.random_rigid_transform(torch.Generator().manual_seed(7), 4000, 50.0)
    T2 = tp.random_rigid_transform(torch.Generator().manual_seed(7), 4000, 50.0)
    assert torch.equal(T1.matrix, T2.matrix) and T1.matrix.shape == (4000, 4, 4)
    R = T1.rotation
    np.testing.assert_allclose(R.transpose(-1, -2) @ R, torch.eye(3).expand(R.shape), atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(R), 1.0, atol=1e-5)
    np.testing.assert_allclose(T1.translation.std().item(), 50.0, rtol=0.05)
    assert abs(T1.translation.mean().item()) < 2.0
    # Uniform rotations: the mean of R is 0 for the Haar measure.
    assert R.mean(0).abs().max() < 0.05
