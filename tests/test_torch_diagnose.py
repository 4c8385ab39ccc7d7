"""``DRR.diagnose_pose``, ``DRR.cone_tan``, ``metrics.to_patches`` and
``RigidTransform.astype`` against the JAX package, on the CPU.

``diagnose_pose``: the 64x64x32 example CT, a 16x12 detector, three poses
(the main one; an axial one, along which some of the other axes' rays run
parallel to the planes; an oblique one whose worst ray breaks the slab
bound). ``best_axis`` and ``slab_valid`` must be equal. ``worst_ratio`` is
held to 1e-5 relative on every axis where the port's four corner rays keep
the axial component's sign (there they bound every ray, as the JAX
package's max over all rays does); on an axis where they do not, the port
reports 1e12 and the JAX package's max over all rays must exceed the slab
bound of 1 too. The port judges the full frame under ``p_subsample``, as
the JAX package does (its ``tests/test_drr.py``). ``cone_tan`` to 1e-6
relative (the same float64 formula). ``to_patches`` exactly (a gather).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.metrics import to_patches as jto_patches
from diffdrr_tpu.ops.pallas import joseph as jpallas_joseph
from diffdrr_tpu.pose import RigidTransform as JRigidTransform

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.metrics import to_patches
from diffdrr_tpu_torch.pose import RigidTransform, convert

KW = dict(parameterization="euler_angles", convention="ZXY")
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
POSES = {
    "main": (np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32), TRANS),
    "axial": (np.array([[0.0, 0.02, 0.03]], np.float32), TRANS),
    "oblique": (np.array([[0.75, 3 * np.pi / 8, -0.75]], np.float32),
                np.array([[5.0, 150.0, -3.0]], np.float32)),
}


@pytest.fixture(scope="module")
def drrs():
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=16, width=12, delx=4.0)
    state = interop.export_state(jd)
    return jd, {p: interop.drr_from_state(state, device="cpu", p_subsample=p)
                for p in (None, 0.5)}


@pytest.mark.parametrize("pose", sorted(POSES))
def test_diagnose_pose_matches_jax(drrs, pose, monkeypatch):
    jd, tds = drrs
    # The JAX package's report also holds footprint_fits, its TPU tile
    # planner's guard, which the port has no counterpart of and this test
    # does not compare; the keys compared do not depend on it. Its first
    # call compiles for ~11 s on the CPU, so it is stubbed here.
    monkeypatch.setattr(jpallas_joseph, "footprint_fits", lambda *a, **k: True)
    rot, trans = POSES[pose]
    ref = jd.diagnose_pose(jconvert(jnp.asarray(rot), jnp.asarray(trans), **KW))
    for p_subsample, td in tds.items():
        got = td.diagnose_pose(convert(torch.tensor(rot), torch.tensor(trans), **KW))
        assert set(got) == {"best_axis", "worst_ratio", "slab_valid", "cone_tan"}
        assert got["best_axis"] == ref["best_axis"], p_subsample
        assert got["slab_valid"] == ref["slab_valid"], p_subsample
        np.testing.assert_allclose(got["cone_tan"], ref["cone_tan"], rtol=1e-6)
        for axis, (g, r) in enumerate(zip(got["worst_ratio"], ref["worst_ratio"])):
            if g < 1e11:
                np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=f"axis {axis}")
            else:
                assert r > 1.0, f"axis {axis}: the JAX package's worst ratio {r}"
    assert ref["slab_valid"] == (pose != "oblique")


def test_cone_tan_follows_the_detector(drrs):
    """cone_tan is the JAX package's, and follows set_intrinsics_ as the
    JAX package's re-planning does."""
    jd, tds = drrs
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    np.testing.assert_allclose(td.cone_tan, jd.cone_tan, rtol=1e-6)
    try:
        jd.set_intrinsics_(sdd=400.0, x0=3.0, height=20)
        td.set_intrinsics_(sdd=400.0, x0=3.0, height=20)
        assert td.cone_tan > tds[None].cone_tan
        np.testing.assert_allclose(td.cone_tan, jd.cone_tan, rtol=1e-6)
    finally:
        jd.set_intrinsics_(sdd=800.0, x0=0.0, height=16)


@pytest.mark.parametrize("patch_size", [3, 1, 10])
def test_to_patches_matches_jax(patch_size):
    x = np.random.default_rng(0).normal(size=(2, 3, 12, 10)).astype(np.float32)
    ref = np.asarray(jto_patches(jnp.asarray(x), patch_size))
    got = to_patches(torch.tensor(x), patch_size)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_rigid_transform_astype_matches_jax(dtype):
    """The matrices cast (each entry rounded to the type), eps kept."""
    m = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    m[:, :3, :3] = [[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]]
    m[:, :3, 3] = [[1.0, -2.5, 3.25], [0.1, 0.2, 0.3001]]
    ref = JRigidTransform(jnp.asarray(m), eps=1e-4).astype(getattr(jnp, dtype))
    got = RigidTransform(torch.tensor(m), eps=1e-4).astype(getattr(torch, dtype))
    assert isinstance(got, RigidTransform) and got.eps == ref.eps == 1e-4
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 4, 4)
    np.testing.assert_array_equal(got.matrix.float().numpy(), np.asarray(ref.matrix, np.float32))
    assert not np.array_equal(got.matrix.float().numpy(), m)
