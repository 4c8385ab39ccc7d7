"""The rest of the port's ``DRR`` against the JAX package's, on the CPU.

The reference's constructor options (``persistent``, ``compile_renderer``,
``checkpoint_gradients``, ``cache_volume``), ``set_density``,
``pallas_ray_compatibility``, ``set_intrinsics_``, ``rescale_detector_``
and the two projections. ``interop`` builds the port's DRR from the JAX
DRR's arrays (the 64x64x32 example CT, a 32x32 detector).

Tolerances: renders atol 1e-3 * max against the JAX DRR (its sort-based
Siddon oracle against the port's slab march, as
``tests/test_torch_drr_registration.py``); a checkpointed pose gradient
equal to the plain one to the last bit; ``pallas_ray_compatibility``'s axis
exactly and its ratio to 1e-5 relative; projections 1e-4 px and 1e-3 mm.
On the CPU the kernel wrappers run their plain versions; they are counted
by name, and the bricked copies by ``brick_density``'s calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.ops.kernels import brick
from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.pose import convert

ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")
# Poses of pallas_ray_compatibility: the main one, two more through the
# CT's other axes, and an oblique one whose worst ray breaks the slab bound.
POSES = {
    "main": (ROT, TRANS),
    "lateral": (np.array([[np.pi / 2, np.pi / 2, 0.0]], np.float32), TRANS),
    "axial": (np.array([[0.0, 0.02, 0.03]], np.float32), TRANS),
    "oblique": (np.array([[0.75, 3 * np.pi / 8, -0.75]], np.float32),
                np.array([[5.0, 150.0, -3.0]], np.float32)),
}


@pytest.fixture(scope="module")
def jscene():
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, delx=2.0)
    return jd, interop.export_state(jd)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def _render(drr, rot=ROT, trans=TRANS, **kw):
    return drr(torch.tensor(rot), torch.tensor(trans), **KW, **kw)


@pytest.fixture
def counts(monkeypatch):
    """Calls of every kernel wrapper by name, and of ``brick_density``."""
    called = {}
    for mod in (J, K):
        for fn in mod.KERNELS:
            def counted(*a, _fn=fn, **k):
                called[_fn.__name__] = called.get(_fn.__name__, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, fn.__name__, counted)
    real = brick.brick_density

    def bricks(density):
        called["brick_copy"] = called.get("brick_copy", 0) + 1
        return real(density)

    monkeypatch.setattr(brick, "brick_density", bricks)
    brick.clear_cache()
    yield called
    brick.clear_cache()


def test_reference_constructor_options_are_accepted(jscene):
    _, state = jscene
    base = interop.drr_from_state(state, device="cpu")
    opts = interop.drr_from_state(state, device="cpu", persistent=False, compile_renderer=True,
                                  checkpoint_gradients=False, cache_volume=True)
    torch.testing.assert_close(_render(opts), _render(base), rtol=0, atol=0)
    assert not opts.checkpoint_gradients and opts.cache_volume
    with pytest.raises(TypeError, match="unexpected renderer option"):
        interop.drr_from_state(state, device="cpu", pallas_tile=16)


@pytest.mark.parametrize("renderer,fused", [("siddon", "siddon_fwdgrad"),
                                            ("trilinear", "joseph_fwdgrad")])
def test_checkpoint_gradients_rerenders_in_the_backward(jscene, counts, renderer, fused):
    """The checkpointed render's pose gradient equals the plain one to the
    last bit, and its backward renders again: the fused kernel twice a step.
    (On the CPU the plain versions read the density itself; that the rerun
    finds the bricked copy cached is checked on the card, by
    ``chip_smoke.py`` phase 9.)"""
    _, state = jscene
    plain = interop.drr_from_state(state, device="cpu", renderer=renderer)
    ckpt = interop.drr_from_state(state, device="cpu", renderer=renderer,
                                  checkpoint_gradients=True)
    ckpt.set_density(plain.density)
    assert ckpt.density is plain.density
    weight = torch.tensor(np.random.default_rng(0).normal(size=(1, 1, 32, 32)),
                          dtype=torch.float32)

    def pose_grad(drr):
        r, t = torch.tensor(ROT, requires_grad=True), torch.tensor(TRANS, requires_grad=True)
        torch.sum(drr(r, t, **KW) * weight).backward()
        return torch.cat([r.grad, t.grad], -1)

    g_plain = pose_grad(plain)
    assert counts == {fused: 1}
    g_ckpt = pose_grad(ckpt)
    assert counts == {fused: 3}
    torch.testing.assert_close(g_ckpt, g_plain, rtol=0, atol=0)
    assert torch.count_nonzero(g_plain) == 6


def test_cache_volume_false_drops_the_copy_each_render(jscene, counts):
    """``cache_volume=False`` drops the rendered density's bricked copy from
    the cache before each render, so the next forward bricks it anew; the
    default keeps it. (On the CPU the plain versions brick nothing, so the
    cache is read here through ``brick.bricked``.)"""
    _, state = jscene
    cached = interop.drr_from_state(state, device="cpu", renderer="joseph")
    fresh = interop.drr_from_state(state, device="cpu", renderer="joseph", cache_volume=False)
    fresh.set_density(cached.density)
    brick.bricked(cached.density)
    imgs = []
    for drr, copies in ((cached, 1), (cached, 1), (fresh, 2), (fresh, 3), (cached, 3)):
        imgs.append(_render(drr))
        brick.bricked(cached.density)
        assert counts["brick_copy"] == copies
    assert counts["joseph_fwd"] == 5
    for img in imgs[1:]:
        torch.testing.assert_close(img, imgs[0], rtol=0, atol=0)


def test_set_density_renders_the_new_density(jscene):
    """A render after ``set_density`` equals a fresh DRR's render of that
    density, and the JAX DRR's after its own ``set_density``; the copy cache
    then holds a copy of the new density."""
    jd, state = jscene
    new = np.asarray(state["density"]) * np.random.default_rng(1).uniform(
        0.5, 1.5, state["density"].shape).astype(np.float32)
    for renderer in ("siddon", "trilinear"):
        td = interop.drr_from_state(state, device="cpu", renderer=renderer)
        before = _render(td)
        td.set_density(new)
        after = _render(td)
        fresh = interop.drr_from_state(dict(state, density=new), device="cpu", renderer=renderer)
        torch.testing.assert_close(after, _render(fresh), rtol=0, atol=0)
        copy = brick.bricked(td.density)
        torch.testing.assert_close(copy.data, brick.brick_density_plain(torch.tensor(new)).data,
                                   rtol=0, atol=0)
        assert not torch.equal(after, before)
    jnew = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, delx=2.0)
    jnew.set_density(jnp.asarray(new))
    ref = jnew(jnp.asarray(ROT), jnp.asarray(TRANS), **KW)
    td = interop.drr_from_state(state, device="cpu")
    td.set_density(torch.tensor(new))
    _close(_render(td), ref, 1e-3)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("p_subsample", [None, 0.25])
def test_pallas_ray_compatibility_matches_jax(pose, p_subsample):
    rot, trans = POSES[pose]
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, width=24, delx=2.0,
              p_subsample=p_subsample)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu", p_subsample=p_subsample)
    j_axis, j_ratio = jd.pallas_ray_compatibility(jconvert(jnp.asarray(rot), jnp.asarray(trans),
                                                           **KW))
    t_axis, t_ratio = td.pallas_ray_compatibility(convert(torch.tensor(rot), torch.tensor(trans),
                                                          **KW))
    assert t_axis == j_axis
    np.testing.assert_allclose(t_ratio, j_ratio, rtol=1e-5)
    if pose == "oblique":
        assert t_ratio > 1.0  # the slab guard would send this pose to the oracle


def test_set_intrinsics_and_rescale_detector_match_jax(jscene):
    jd0, state = jscene
    jd = JDRR(jd0.subject, sdd=800.0, height=32, delx=2.0)
    td = interop.drr_from_state(state, device="cpu")
    for step in (dict(sdd=900.0, height=24, width=20, delx=2.5, x0=1.5, y0=-2.0,
                      reverse_x_axis=False),
                 dict(height=30)):
        jd.set_intrinsics_(**step)
        td.set_intrinsics_(**step)
        for k in ("sdd", "height", "width", "delx", "dely", "x0", "y0", "reverse_x_axis"):
            assert getattr(td.detector, k) == pytest.approx(getattr(jd.detector, k)), k
        np.testing.assert_allclose(td.detector.intrinsic.numpy(),
                                   np.asarray(jd.detector.intrinsic), rtol=1e-6)
        _close(_render(td), jd(jnp.asarray(ROT), jnp.asarray(TRANS), **KW), 1e-3)
    jd.rescale_detector_(0.5)
    td.rescale_detector_(0.5)
    assert (td.detector.height, td.detector.width) == (15, 10)
    for k in ("delx", "dely", "sdd"):
        assert getattr(td.detector, k) == pytest.approx(getattr(jd.detector, k)), k
    img = _render(td)
    assert img.shape == (1, 1, 15, 10)
    _close(img, jd(jnp.asarray(ROT), jnp.asarray(TRANS), **KW), 1e-3)


def test_projections_match_jax(jscene):
    jd, state = jscene
    td = interop.drr_from_state(state, device="cpu")
    rng = np.random.default_rng(2)
    rot = (ROT + rng.normal(0, 0.05, (2, 3))).astype(np.float32)
    trans = (TRANS + rng.normal(0, 5.0, (2, 3))).astype(np.float32)
    pts = rng.uniform(-40, 40, (2, 50, 3)).astype(np.float32)
    jpose = jconvert(jnp.asarray(rot), jnp.asarray(trans), **KW)
    tpose = convert(torch.tensor(rot), torch.tensor(trans), **KW)
    px = td.perspective_projection(tpose, torch.tensor(pts))
    np.testing.assert_allclose(px.numpy(), np.asarray(jd.perspective_projection(
        jpose, jnp.asarray(pts))), atol=1e-4, rtol=0)
    pix = rng.uniform(0, 32, (2, 50, 2)).astype(np.float32)
    world = td.inverse_projection(tpose, torch.tensor(pix))
    np.testing.assert_allclose(world.numpy(), np.asarray(jd.inverse_projection(
        jpose, jnp.asarray(pix))), atol=1e-3, rtol=0)
    # A backprojected pixel lies on the detector plane and projects back onto itself.
    np.testing.assert_allclose(td.perspective_projection(tpose, world).numpy(), pix, atol=1e-3)
    assert not torch.backends.cuda.matmul.allow_tf32
