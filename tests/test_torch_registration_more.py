"""The rest of the port's registration against the JAX package's, on the CPU:
learning-rate schedules, ``optimize_until``, ``optimize_multistart``,
``rescaled_drr`` and ``optimize_multiscale``.

The scene is ``test_sixty_step_registration_matches_jax``'s, cut to size:
the 64x64x32 example CT, the bench pose (sdd 1020 mm), a 32x32 detector of
12.5 mm pixels (the full cell's 400 mm field), the exact Siddon integral
(the JAX package's sort-based oracle, the port's slab march) and starts
a few mm and mrad off the truth. Trajectories are held step for step at
that test's tolerances: the score to 1e-4 relative, the translation to 0.01
mm and the rotation to 1e-5 rad. The schedules' learning rates equal
optax's to 1e-7, and ``optimize_until`` stops at the JAX loop's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu import registration as JR

from diffdrr_tpu_torch import DRR, interop, load_example_ct
from diffdrr_tpu_torch import registration as TR
from diffdrr_tpu_torch.pose import convert

KW = dict(parameterization="euler_angles", convention="ZXY")
ROT = np.array([[0.01, np.pi / 2 + 0.02, -0.01]], np.float32)
TRANS = np.array([[0.0, 850.0, 0.0]], np.float32)
ROT0 = ROT + np.array([[0.004, -0.003, 0.002]], np.float32)
TRANS0 = TRANS + np.array([[5.0, 4.0, -3.0]], np.float32)
LR = dict(lr_rotation=1e-3, lr_translation=1e-1)
SGD = dict(optimizer="sgd", momentum=0.9, dampening=0.9, lr_rotation=1e-5, lr_translation=2.0)
# Multistart: three starts about the truth.
ROTS = ROT + np.array([[0.004, -0.003, 0.002], [-0.003, 0.002, 0.0], [0.0, 0.003, -0.004]],
                      np.float32)
TRANSS = TRANS + np.array([[5.0, 4.0, -3.0], [-4.0, 3.0, 5.0], [3.0, -5.0, 4.0]], np.float32)


@pytest.fixture(scope="module")
def scene():
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=1020.0, height=32, delx=12.5)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    target = jd(jnp.asarray(ROT), jnp.asarray(TRANS), **KW)
    return jd, td, target, torch.tensor(np.asarray(target))


def _same_pose(t_rot, t_trans, j_rot, j_trans):
    np.testing.assert_allclose(np.asarray(t_trans), np.asarray(j_trans), atol=0.01, rtol=0)
    np.testing.assert_allclose(np.asarray(t_rot), np.asarray(j_rot), atol=1e-5, rtol=0)


@pytest.mark.parametrize("init,steps,rate", [(5e-3, 20, 0.1), (0.5, 7, 0.3), (1e-1, 1, 2.0),
                                             (1e-3, 0, 0.1)])
def test_exponential_decay_matches_optax(init, steps, rate):
    ours, ref = TR.exponential_decay(init, steps, rate), optax.exponential_decay(init, steps, rate)
    counts = range(2 * max(steps, 1) + 3)
    np.testing.assert_allclose([ours(k) for k in counts], [float(ref(k)) for k in counts],
                               atol=1e-7, rtol=0)


def test_optimizer_takes_the_schedule_in_optax_order():
    """The k-th update (from 0) uses lr(k): the group's learning rate before
    each ``step_fn`` is the schedule at the number of updates made so far,
    for each parameter group, in Adam and SGD."""
    subject = load_example_ct(shape=(16, 16, 8), device="cpu")
    drr = DRR(subject, sdd=1020.0, height=8, delx=8.0, device="cpu")
    target = drr(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    sched_r, sched_t = optax.exponential_decay(4e-3, 6, 0.2), optax.exponential_decay(0.5, 6, 0.2)
    for optimizer in ("adam", "sgd"):
        init_fn, step_fn = TR.make_registration_step(
            drr, target, "euler_angles", "ZXY", optimizer=optimizer,
            lr_rotation=TR.exponential_decay(4e-3, 6, 0.2),
            lr_translation=TR.exponential_decay(0.5, 6, 0.2))
        params, opt = init_fn(ROT0, TRANS0)
        for k in range(9):
            np.testing.assert_allclose([g["lr"] for g in opt.param_groups],
                                       [float(sched_r(k)), float(sched_t(k))], atol=1e-7, rtol=0)
            params, opt, _ = step_fn(params, opt)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_scheduled_registration_matches_jax(scene, optimizer):
    """10 steps with an exponential decay to a tenth over the 10 steps, as
    the registration CLI's polish stage."""
    jd, td, target, ttarget = scene
    lrs = (1e-3, 1e-1) if optimizer == "adam" else (1e-5, 2.0)
    j_init, j_step = JR.make_registration_step(
        jd, target, "euler_angles", "ZXY", optimizer=optimizer,
        lr_rotation=optax.exponential_decay(lrs[0], 10, 0.1),
        lr_translation=optax.exponential_decay(lrs[1], 10, 0.1))
    t_init, t_step = TR.make_registration_step(
        td, ttarget, "euler_angles", "ZXY", optimizer=optimizer,
        lr_rotation=TR.exponential_decay(lrs[0], 10, 0.1),
        lr_translation=TR.exponential_decay(lrs[1], 10, 0.1))
    jp, js = j_init(jnp.asarray(ROT0), jnp.asarray(TRANS0))
    tp, ts = t_init(torch.tensor(ROT0), torch.tensor(TRANS0))
    for _ in range(10):
        jp, js, j_score = j_step(jp, js)
        tp, ts, t_score = t_step(tp, ts)
        np.testing.assert_allclose(float(t_score), float(j_score), rtol=1e-4)
        _same_pose(tp["rotation"].detach(), tp["translation"].detach(), jp["rotation"],
                   jp["translation"])
    moved = np.abs(tp["translation"].detach().numpy() - TRANS0).max()
    assert moved > 0.1


def test_optimize_until_stops_at_the_jax_step(scene):
    """SGD (momentum and dampening 0.9) from 5 mm off on each axis: the
    distance falls 8.75, 8.68, 8.62, 8.55, 8.48 mm over the first steps, so
    8.515 mm is first reached at step 5; 1 mm is not reached in 12 steps;
    a start within 100 mm takes no step. Both packages stop at the same
    step with the same distance."""
    jd, td, target, ttarget = scene
    rot0 = ROT + np.array([[0.002, -0.001, 0.001]], np.float32)
    trans0 = TRANS + 5.0
    j_true = jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW)
    t_true = convert(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    for tol, max_iters, want in ((8.515, 40, 5), (1.0, 12, 12), (100.0, 40, 0)):
        jr, jt, jn, jdist = JR.optimize_until(jd, target, jnp.asarray(rot0), jnp.asarray(trans0),
                                              "euler_angles", "ZXY", true_pose=j_true,
                                              tol_mm=tol, max_iters=max_iters, **SGD)
        tr, tt, tn, tdist = TR.optimize_until(td, ttarget, torch.tensor(rot0),
                                              torch.tensor(trans0), "euler_angles", "ZXY",
                                              true_pose=t_true, tol_mm=tol, max_iters=max_iters,
                                              **SGD)
        assert tn == int(jn) == want
        np.testing.assert_allclose(tdist, float(jdist), atol=0.01)
        assert (tdist <= tol) == (want < max_iters)
        _same_pose(tr, tt, jr, jt)
    with pytest.raises(ValueError, match="ground-truth"):
        TR.optimize_until(td, ttarget, ROT0, TRANS0, "euler_angles", "ZXY")


@pytest.mark.parametrize("opt", [dict(optimizer="adam", **LR), SGD], ids=["adam", "sgd"])
def test_optimize_multistart_matches_jax(scene, opt):
    jd, td, target, ttarget = scene
    j = JR.optimize_multistart(jd, target, jnp.asarray(ROTS), jnp.asarray(TRANSS), "euler_angles",
                               "ZXY", n_iters=8, **opt)
    t = TR.optimize_multistart(td, ttarget, torch.tensor(ROTS), torch.tensor(TRANSS),
                               "euler_angles", "ZXY", n_iters=8, **opt)
    assert t[2].shape == (3,) and t[3].shape == (8, 3)
    _same_pose(t[0], t[1], j[0], j[1])
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-4)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-4)
    assert torch.isfinite(t[2]).all()


def test_multistart_is_independent_runs(scene):
    """The batched run is N independent runs (Adam is elementwise, the loss a
    sum of per-image scores, and ``var_floor``'s scale is per image): each
    restart's trace, final pose and score are bit for bit unchanged when the
    other starts are replaced, and equal a single-pose ``optimize`` from its
    start."""
    _, td, _, ttarget = scene
    metric = TR.MultiscaleNormalizedCrossCorrelation2d([None, 13], [0.5, 0.5], var_floor=1e-3)
    run = dict(n_iters=6, metric=metric, **LR)
    rots, transs, final, trace = TR.optimize_multistart(
        td, ttarget, torch.tensor(ROTS), torch.tensor(TRANSS), "euler_angles", "ZXY", **run)
    others = np.array([[0.0], [1.0], [1.0]], np.float32)  # restart 0 keeps its start
    alt = TR.optimize_multistart(td, ttarget, torch.tensor(ROTS[[0, 2, 1]] + 0.01 * others),
                                 torch.tensor(TRANSS[[0, 2, 1]] - 3.0 * others), "euler_angles",
                                 "ZXY", **run)
    for got, ref in ((alt[0][0], rots[0]), (alt[1][0], transs[0]), (alt[2][0], final[0]),
                     (alt[3][:, 0], trace[:, 0])):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    for i in range(3):
        r, t, single = TR.optimize(td, ttarget, torch.tensor(ROTS[i:i + 1]),
                                   torch.tensor(TRANSS[i:i + 1]), "euler_angles", "ZXY",
                                   n_iters=6, metric=metric, **LR)
        np.testing.assert_allclose(trace[:, i].numpy(), single, rtol=1e-6)
        np.testing.assert_allclose(rots[i:i + 1].numpy(), r.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(transs[i:i + 1].numpy(), t.numpy(), atol=1e-4, rtol=0)


def test_lbfgs_raises_and_names_the_roadmap_item(scene):
    """LBFGS, once unported, runs through both entry points: two steps of
    ``make_registration_step`` make the same poses as ``optimize``, and
    ``optimize_multistart``'s restarts are those single-pose runs."""
    _, td, _, ttarget = scene
    init_fn, step_fn = TR.make_registration_step(td, ttarget, "euler_angles", "ZXY",
                                                 optimizer="lbfgs")
    params, opt = init_fn(ROT0, TRANS0)
    scores = []
    for _ in range(2):
        params, opt, score = step_fn(params, opt)
        scores.append(score.item())
    assert opt.state.count == 2 and opt.state.num_linesearch_steps >= 1
    r, t, trace = TR.optimize(td, ttarget, torch.tensor(ROT0), torch.tensor(TRANS0),
                              "euler_angles", "ZXY", n_iters=2, optimizer="lbfgs")
    assert torch.equal(r, params["rotation"]) and torch.equal(t, params["translation"])
    assert trace == scores and scores[1] > scores[0]
    rots, transs, final, ms_trace = TR.optimize_multistart(
        td, ttarget, torch.tensor(ROTS[:2]), torch.tensor(TRANSS[:2]), "euler_angles", "ZXY",
        n_iters=2, optimizer="lbfgs")
    assert torch.equal(rots[0], r[0]) and torch.equal(transs[0], t[0])
    assert ms_trace[:, 0].tolist() == trace and final.shape == (2,)


def test_rescaled_drr_preserves_fov_and_options():
    """``tests/test_registration.py``'s regression: a coarse twin covers the
    same physical plane on both axes (rounding and the 8-pixel clamp
    included) and keeps the constructor's options; here it also reads the
    source's density and labelmap tensors."""
    subject = load_example_ct(shape=(32, 32, 16), device="cpu")
    drr = DRR(subject, sdd=700.0, height=32, width=64, delx=2.0, dely=3.0, renderer="trilinear",
              checkpoint_gradients=True, cache_volume=False, patch_size=8, x0=1.5, y0=-2.0,
              n_points=64, device="cpu")
    for scale in (0.3, 0.1):
        c = TR.rescaled_drr(drr, scale)
        np.testing.assert_allclose(c.detector.width * c.detector.delx, 64 * 2.0, rtol=1e-6)
        np.testing.assert_allclose(c.detector.height * c.detector.dely, 32 * 3.0, rtol=1e-6)
        assert (c.checkpoint_gradients, c.cache_volume, c.patch_size) == (True, False, 8)
        assert c.renderer_name == "trilinear" and c.renderer_kwargs == {"n_points": 64}
        assert (c.detector._x0, c.detector._y0, c.detector.sdd) == (1.5, -2.0, 700.0)
        assert c.density is drr.density
        assert c.mask is drr.mask and c.n_channels == drr.n_channels
    assert (c.detector.height, c.detector.width) == (8, 8)
    j = JR.rescaled_drr(JDRR(jload(shape=(32, 32, 16)), sdd=700.0, height=32, width=64,
                             delx=2.0, dely=3.0, renderer="trilinear"), 0.3)
    c = TR.rescaled_drr(drr, 0.3)
    for k in ("height", "width", "delx", "dely"):
        assert getattr(c.detector, k) == pytest.approx(getattr(j.detector, k), rel=1e-12), k


@pytest.mark.parametrize("size", [(10, 10), (20, 20), (13, 17), (40, 40)])
def test_resize_target_matches_jax_image_resize(size):
    img = np.random.default_rng(4).uniform(0, 100, (2, 1, 40, 40)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2, 1, *size), method="linear"))
    got = TR.resize_target(torch.tensor(img), *size).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_optimize_multiscale_matches_jax(scene):
    """Scales 0.5 and 1.0, 6 steps each: the coarse stage on a 16x16 twin
    against the resized target, then the full detector."""
    jd, td, target, ttarget = scene
    jr, jt, jtrace = JR.optimize_multiscale(jd, target, jnp.asarray(ROT0), jnp.asarray(TRANS0),
                                            "euler_angles", "ZXY", scales=(0.5, 1.0),
                                            n_iters_per_scale=6, **LR)
    tr, tt, ttrace = TR.optimize_multiscale(td, ttarget, torch.tensor(ROT0),
                                            torch.tensor(TRANS0), "euler_angles", "ZXY",
                                            scales=(0.5, 1.0), n_iters_per_scale=6, **LR)
    assert [len(t) for t in ttrace] == [6, 6]
    for a, b in zip(ttrace, jtrace):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    _same_pose(tr, tt, jr, jt)
    assert np.abs(tt.numpy() - TRANS0).max() > 0.1
