"""The slice end to end on the CPU: DRR render and registration vs JAX.

``interop`` builds the port's DRR from the JAX DRR's own arrays (density,
affine, reorient, detector config). On the CPU the JAX DRR renders with its
sort-based oracle and the port with the slab march (the plain versions of
its CUDA kernels), so these tests hold two algorithms for the same exact
Siddon integral against each other, through the whole registration step.

Tolerances: image atol 1e-3 * max (different algorithms for one integral);
loss to 1e-5 relative and pose gradient atol 1e-3 * max|g|; 5-step Adam and
SGD trajectories within 1% of the distance each parameter group moved (each
step is linear in the gradients, or in Adam their ratio to a running RMS, so
gradient agreement to 1e-3 keeps each step within a comparable fraction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, load_example_ct as jload
from diffdrr_tpu.metrics import MultiscaleNormalizedCrossCorrelation2d as JNCC
from diffdrr_tpu.registration import make_registration_step as jmake_step

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.metrics import MultiscaleNormalizedCrossCorrelation2d as TNCC
from diffdrr_tpu_torch.metrics import ncc2d as tncc
from diffdrr_tpu.metrics import ncc2d as jncc
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.registration import Registration, make_registration_step, optimize

ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
ROT0 = ROT + np.array([[0.021, -0.017, 0.012]], np.float32)
TRANS0 = TRANS + np.array([[4.1, -3.3, 2.7]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")


@pytest.fixture(scope="module")
def drrs():
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, delx=2.0)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    target_j = jd(jnp.asarray(ROT), jnp.asarray(TRANS), **KW)
    return jd, td, np.asarray(target_j)


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=rel * np.abs(ref).max(), rtol=0)


def test_render_matches_jax(drrs):
    jd, td, target = drrs
    K.reset_launch_counts()
    img = td(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    assert img.shape == target.shape
    _close(img, target, 1e-3)
    assert td.siddon_escapes == 0
    reg = Registration(td, torch.tensor(ROT), torch.tensor(TRANS), **KW)
    torch.testing.assert_close(reg().detach(), img, rtol=0, atol=0)


def test_pinned_axis_and_escape_path(drrs):
    """axis=2 pinned renders on the slab path; axis=0 violates the slab
    bound at this pose and takes the counted escape to the sort oracle."""
    jd, td, target = drrs
    rot, trans = torch.tensor(ROT), torch.tensor(TRANS)
    _close(td(rot, trans, axis=2, **KW), target, 1e-3)
    before = td.siddon_escapes
    _close(td(rot, trans, axis=0, **KW), target, 1e-4)
    assert td.siddon_escapes == before + 1


def test_patch_size_chunks_the_oracle(drrs):
    jd, _, _ = drrs
    td = interop.drr_from_state(interop.export_state(jd), device="cpu", patch_size=8)
    pose_args = (torch.tensor(ROT), torch.tensor(TRANS))
    from diffdrr_tpu_torch.pose import convert

    src, tgt = td.detector(convert(*pose_args, **KW))
    full = td.render(td.density, src, tgt[:, :1000])  # not the full frame: oracle
    ref = td._render_oracle(td.density, td.affine_inverse(src),
                            td.affine_inverse(tgt[:, :1000]),
                            torch.linalg.vector_norm(tgt[:, :1000] - src, dim=-1)[:, None], {})
    _close(full, ref, 1e-6)


@pytest.mark.parametrize("patch_size", [None, 5, 13])
def test_ncc_matches_jax(patch_size):
    rng = np.random.default_rng(patch_size or 0)
    a = rng.uniform(0, 50, (2, 1, 32, 32)).astype(np.float32)
    b = (a + rng.normal(0, 5, a.shape)).astype(np.float32)
    b[:, :, :8, :8] = 3.0  # a flat patch region in one image
    a[:, :, :8, :8] = 7.0  # and in the other: flat-flat patches gate to 0
    ref = np.asarray(jncc(jnp.asarray(a), jnp.asarray(b), patch_size))
    np.testing.assert_allclose(tncc(torch.tensor(a), torch.tensor(b), patch_size), ref,
                               rtol=1e-5, atol=1e-6)
    ref_g = np.asarray(jax.grad(lambda x: jnp.sum(jncc(x, jnp.asarray(b), patch_size)))(
        jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    torch.sum(tncc(x, torch.tensor(b), patch_size)).backward()
    _close(x.grad, ref_g, 1e-4)


def test_registration_loss_and_pose_gradient(drrs):
    jd, td, target = drrs
    metric_j = JNCC([None, 13], [0.5, 0.5])

    def jloss(r, t):
        return -jnp.mean(metric_j(jd(r, t, **KW), jnp.asarray(target)))

    jl, (jgr, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(ROT0),
                                                               jnp.asarray(TRANS0))
    init_fn, step_fn = make_registration_step(td, torch.tensor(target), "euler_angles", "ZXY")
    params, _ = init_fn(torch.tensor(ROT0), torch.tensor(TRANS0))
    K.reset_launch_counts()
    loss = step_fn.loss(params)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _close(params["rotation"].grad, jgr, 1e-3)
    _close(params["translation"].grad, jgt, 1e-3)
    assert (K.siddon_fwd.launches, K.siddon_fwdgrad.launches) == (0, 0)  # CPU: plain


@pytest.mark.parametrize("opt", [
    dict(optimizer="adam", lr_rotation=1e-2, lr_translation=1.0),
    # The reference experiments' SGD: the first step sets the momentum
    # buffer to the gradient, later steps damp the new gradient by 0.9.
    dict(optimizer="sgd", momentum=0.9, dampening=0.9, lr_rotation=1e-2,
         lr_translation=10.0),
], ids=["adam", "sgd"])
def test_optimizer_trajectory_matches_jax(drrs, opt):
    jd, td, target = drrs
    n_steps = 5
    j_init, j_step = jmake_step(jd, jnp.asarray(target), "euler_angles", "ZXY", **opt)
    jp_, jstate = j_init(jnp.asarray(ROT0), jnp.asarray(TRANS0))
    j_scores = []
    for _ in range(n_steps):
        jp_, jstate, s = j_step(jp_, jstate)
        j_scores.append(float(s))
    t_rot, t_trans, t_scores = optimize(td, torch.tensor(target), torch.tensor(ROT0),
                                        torch.tensor(TRANS0), "euler_angles", "ZXY",
                                        n_iters=n_steps, **opt)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-4)
    for got, ref, start in ((t_rot, jp_["rotation"], ROT0), (t_trans, jp_["translation"], TRANS0)):
        ref = np.asarray(ref)
        moved = np.abs(ref - start).max()
        assert moved > 0
        np.testing.assert_allclose(got, ref, atol=0.01 * moved, rtol=0)
    assert t_scores[-1] > t_scores[0]


BENCH_ROT = np.array([[0.01, np.pi / 2 + 0.02, -0.01]], np.float32)
BENCH_TRANS = np.array([[0.0, 850.0, 0.0]], np.float32)


def test_sixty_step_registration_matches_jax():
    """The main cell's registration, cut to size: the bench pose (sdd 1020),
    60 Adam steps (lr 1e-3 rotation, 1e-1 translation) of multiscale NCC
    from translation + 5 mm, on a 64x64x32 CT and a 32x32 detector of
    12.5 mm pixels (the full cell's 400 mm field). The JAX package (its XLA
    sort-based Siddon on the CPU) and the port (the slab march's plain
    versions) step for step: the score to 1e-4 relative, the translation to
    0.01 mm and the rotation to 1e-5 rad at every step; the x translation
    error falls below 3 mm in both."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=1020.0, height=32, delx=12.5)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    target = jd(jnp.asarray(BENCH_ROT), jnp.asarray(BENCH_TRANS), **KW)
    opt = dict(lr_rotation=1e-3, lr_translation=1e-1)
    j_init, j_step = jmake_step(jd, target, "euler_angles", "ZXY", **opt)
    jp, js = j_init(jnp.asarray(BENCH_ROT), jnp.asarray(BENCH_TRANS + 5.0))
    t_init, t_step = make_registration_step(td, torch.tensor(np.asarray(target)), "euler_angles",
                                            "ZXY", **opt)
    tp, ts = t_init(torch.tensor(BENCH_ROT), torch.tensor(BENCH_TRANS + 5.0))
    t_err = []
    for _ in range(60):
        jp, js, j_score = j_step(jp, js)
        tp, ts, t_score = t_step(tp, ts)
        np.testing.assert_allclose(float(t_score), float(j_score), rtol=1e-4)
        np.testing.assert_allclose(tp["translation"].detach().numpy(),
                                   np.asarray(jp["translation"]), atol=0.01, rtol=0)
        np.testing.assert_allclose(tp["rotation"].detach().numpy(), np.asarray(jp["rotation"]),
                                   atol=1e-5, rtol=0)
        t_err.append(tp["translation"].detach().numpy()[0] - BENCH_TRANS[0])
    assert float(t_score) > 0.5 and t_err[-1][0] < 3.0 < t_err[0][0]
