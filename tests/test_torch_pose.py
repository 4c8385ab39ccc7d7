"""The port's pose algebra against ``diffdrr_tpu.pose``, values and gradients.

Inputs are seeded NumPy float32 arrays fed to both packages. Tolerance:
atol 1e-5 on rotation entries (O(1)) and rtol 1e-5 on translations (O(100
mm)); both sides run the same float32 formulas, so differences are
rounding in transcendental functions and operation order. Gradients (of a
scalar ``sum(sin(matrix))``) use atol 1e-4 * max|g|.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffdrr_tpu.pose as jp
import diffdrr_tpu_torch.pose as tp

CONVENTIONS = ["XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",
               "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ"]


def _rotation(rng, parameterization, B=3):
    if parameterization in ("axis_angle", "euler_angles", "se3_log_map"):
        return rng.uniform(-1.2, 1.2, (B, 3)).astype(np.float32)
    if parameterization == "quaternion":
        return rng.normal(size=(B, 4)).astype(np.float32)
    if parameterization == "rotation_6d":
        return rng.normal(size=(B, 6)).astype(np.float32)
    if parameterization == "matrix":
        q = rng.normal(size=(B, 4)).astype(np.float32)
        return np.asarray(jp.quaternion_to_matrix(jnp.asarray(q)))
    raise ValueError(parameterization)


CASES = ([("euler_angles", c) for c in CONVENTIONS]
         + [(p, None) for p in ("axis_angle", "quaternion", "rotation_6d", "matrix",
                                "se3_log_map")])


@pytest.mark.parametrize("parameterization,convention", CASES)
def test_convert_values_and_gradients(parameterization, convention):
    rng = np.random.default_rng(zlib.crc32(f"{parameterization}{convention}".encode()))
    rot = _rotation(rng, parameterization)
    trans = rng.uniform(-200, 200, (3, 3)).astype(np.float32)
    kw = dict(parameterization=parameterization, convention=convention)

    def jax_loss(r, t):
        return jnp.sum(jnp.sin(jp.convert(r, t, **kw).matrix * 0.01))

    jm = np.asarray(jp.convert(jnp.asarray(rot), jnp.asarray(trans), **kw).matrix)
    jgr, jgt = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(rot), jnp.asarray(trans))

    r = torch.tensor(rot, requires_grad=True)
    t = torch.tensor(trans, requires_grad=True)
    tm = tp.convert(r, t, **kw).matrix
    np.testing.assert_allclose(tm[..., :3, :3].detach(), jm[..., :3, :3], atol=1e-5)
    np.testing.assert_allclose(tm[..., :3, 3].detach(), jm[..., :3, 3], rtol=1e-5, atol=1e-4)
    torch.sum(torch.sin(tm * 0.01)).backward()
    for got, ref in ((r.grad, jgr), (t.grad, jgt)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("parameterization,convention", CASES)
def test_rigid_transform_export_matches(parameterization, convention):
    """RigidTransform.convert (inverse, log map, matrix -> parameters)."""
    rng = np.random.default_rng(5)
    rot = _rotation(rng, "axis_angle")
    trans = rng.uniform(-200, 200, (3, 3)).astype(np.float32)
    jT = jp.convert(jnp.asarray(rot), jnp.asarray(trans), parameterization="axis_angle")
    tT = tp.RigidTransform(torch.tensor(np.asarray(jT.matrix)))
    jr, jt = jT.convert(parameterization, convention)
    tr, tt = tT.convert(parameterization, convention)
    np.testing.assert_allclose(tr, np.asarray(jr), atol=2e-5)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=1e-4, atol=1e-3)


def test_rigid_transform_apply_inverse_compose():
    rng = np.random.default_rng(11)
    A = np.asarray(jp.convert(jnp.asarray(_rotation(rng, "axis_angle", 2)),
                              jnp.asarray(rng.uniform(-50, 50, (2, 3)).astype(np.float32)),
                              parameterization="axis_angle").matrix)
    Bm = np.asarray(jp.convert(jnp.asarray(_rotation(rng, "axis_angle", 2)),
                               jnp.asarray(rng.uniform(-50, 50, (2, 3)).astype(np.float32)),
                               parameterization="axis_angle").matrix)
    pts = rng.uniform(-100, 100, (2, 7, 3)).astype(np.float32)
    jA, jB = jp.RigidTransform(jnp.asarray(A)), jp.RigidTransform(jnp.asarray(Bm))
    tA, tB = tp.RigidTransform(torch.tensor(A)), tp.RigidTransform(torch.tensor(Bm))
    np.testing.assert_allclose(tA(torch.tensor(pts)), np.asarray(jA(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tA.inverse().matrix, np.asarray(jA.inverse().matrix),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tA.compose(tB).matrix, np.asarray(jA.compose(jB).matrix),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose((tA @ tB).matrix, np.asarray((jA @ jB).matrix),
                               rtol=1e-5, atol=1e-4)
    # A non-orthonormal matrix takes the general inverse.
    M = A.copy()
    M[:, :3, :3] *= 1.5
    np.testing.assert_allclose(tp.RigidTransform(torch.tensor(M)).inverse().matrix,
                               np.asarray(jp.RigidTransform(jnp.asarray(M)).inverse().matrix),
                               rtol=1e-5, atol=1e-4)


def test_so3_se3_maps():
    rng = np.random.default_rng(2)
    log = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
    jm = np.asarray(jp.se3_exp_map(jnp.asarray(log)))
    tm = tp.se3_exp_map(torch.tensor(log))
    np.testing.assert_allclose(tm, jm, atol=1e-5)
    np.testing.assert_allclose(tp.se3_log_map(tm), np.asarray(jp.se3_log_map(jnp.asarray(jm))),
                               atol=1e-4)
    R1, R2 = tm[:2, :3, :3], tm[2:, :3, :3]
    np.testing.assert_allclose(
        tp.so3_relative_angle(R1, R2),
        np.asarray(jp.so3_relative_angle(jnp.asarray(jm[:2, :3, :3]),
                                         jnp.asarray(jm[2:, :3, :3]))), atol=1e-5)


@pytest.mark.parametrize("parameterization", ["rotation_9d", "rotation_10d",
                                              "quaternion_adjugate"])
def test_unported_parameterizations_raise(parameterization):
    """The three parameterizations this test once found unported: a pose
    exported to each and built back by ``convert`` is the JAX package's
    round trip (matrices to atol 1e-5, translations rtol 1e-5)."""
    rng = np.random.default_rng(zlib.crc32(parameterization.encode()))
    rot = _rotation(rng, "axis_angle")
    trans = rng.uniform(-200, 200, (3, 3)).astype(np.float32)
    jT = jp.convert(jnp.asarray(rot), jnp.asarray(trans), parameterization="axis_angle")
    jr, jt = jT.convert(parameterization)
    jm = np.asarray(jp.convert(jr, jt, parameterization=parameterization).matrix)
    tr, tt = tp.RigidTransform(torch.tensor(np.asarray(jT.matrix))).convert(parameterization)
    tm = tp.convert(tr, tt, parameterization=parameterization).matrix.numpy()
    np.testing.assert_allclose(tm[:, :3, :3], jm[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(tm[:, :3, 3], jm[:, :3, 3], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tm, np.asarray(jT.matrix), rtol=1e-5, atol=1e-4)
