"""The port's Joseph plane march against the JAX package, on the CPU.

The same seeded NumPy inputs go through the JAX package's
``joseph_pallas_raycast`` (interpret mode, as ``tests/test_joseph.py`` runs
it: that reaches ``_fwd_kernel`` in sum and max mode, ``_fwd_plane_major_kernel``,
``_fwdgrad_kernel``, ``_bwd_rays_kernel`` and ``_bwd_vol_kernel``) and
through the port's ``joseph_march_raycast``: ``prep_rays`` with the Joseph
quadrature, the plain versions of the five wrappers (their CPU path) and
``JosephMarch``. The oracles (``ops/joseph.py``, trilinear
``sample_volume``) are held against their JAX counterparts, autograd
against ``jax.grad``.

Scene: the 64x64x32 example phantom, a 32x32 detector, the off-grid pose
of ``tests/test_joseph.py``, march axis 2. Tolerances: values atol
1e-4 * max|ref| (the TPU kernel sums its bilinear weights by matmul, the
port by two products and a sum); gradients atol 1e-3 * max|g_ref| for
source, target and weights and 1e-4 for the volume; the two-pass backward
against the fused one 1e-6 (the same terms times g).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.joseph import choose_march_axis as jchoose, joseph_raycast as jjoseph
from diffdrr_tpu.ops.pallas.joseph import joseph_pallas_raycast
from diffdrr_tpu.ops.sampling import sample_volume as jsample

from diffdrr_tpu_torch.ops.joseph import choose_march_axis, joseph_raycast
from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
from diffdrr_tpu_torch.ops.sampling import sample_volume

PALLAS = dict(tile=16, ky=64, zw=256, interpret=True)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def _sin_loss_jax(fn, vol, s, t, w):
    return jnp.sum(jnp.sin(fn(vol, s, t, w) * 0.1))


def _sq_loss_jax(fn, vol, s, t, w):
    return jnp.sum(fn(vol, s, t, w) ** 2)


def _port_grads(args, loss, **kw):
    """Port render + autograd: (value, [d/d density, source, target, weights])."""
    leaves = [_t(x, True) for x in args]
    out = J.joseph_march_raycast(*leaves, **kw)
    loss(out).backward()
    return out.detach(), [x.grad for x in leaves]


@pytest.fixture(scope="module")
def scene():
    subject = jload(shape=(64, 64, 32))
    drr = JDRR(subject, sdd=800.0, height=32, delx=2.0)
    rot = jnp.array([[0.013, np.pi / 2 + 0.017, -0.011]], jnp.float32)
    trans = jnp.array([[3.0, 401.0, -2.0]], jnp.float32)
    source, target = drr.detector(jconvert(rot, trans, parameterization="euler_angles",
                                           convention="ZXY"), None)
    weights = jnp.linalg.norm(target - source, axis=-1)[:, None, :]
    sv, tv = drr.affine_inverse(source), drr.affine_inverse(target)
    axis = jchoose(np.asarray(sv), np.asarray(tv))
    args = (drr.density, sv, tv, weights)
    return dict(args=tuple(np.asarray(x) for x in args), jargs=args, axis=axis)


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("step", [1, 2])
def test_forward_matches_pallas(scene, step, reduce):
    """Integer strides, sum (``_fwd_kernel``/``_fwd_plane_major_kernel``) and
    max (``_fwd_kernel`` in max mode)."""
    ax = scene["axis"]
    assert ax == 2
    ref = np.asarray(joseph_pallas_raycast(*scene["jargs"], image_shape=(32, 32), axis=ax,
                                           step=step, reducefn=reduce, **PALLAS))
    got = J.joseph_march_raycast(*(_t(x) for x in scene["args"]), axis=ax, step=step,
                                 reduce=reduce)
    assert got.shape == ref.shape
    _close(got, ref, 1e-4)
    if reduce == "max":
        assert not np.allclose(got, J.joseph_march_raycast(
            *(_t(x) for x in scene["args"]), axis=ax, step=step))


@pytest.fixture(scope="module")
def grads(scene):
    """JAX gradients of sin-sum (sum) and squared-sum (MIP) losses, by the
    fused and the two-pass Pallas backward."""
    pal = partial(joseph_pallas_raycast, image_shape=(32, 32), axis=scene["axis"], **PALLAS)
    g = partial(jax.grad, argnums=(0, 1, 2, 3))
    return {
        ("sum", True): g(partial(_sin_loss_jax, pal))(*scene["jargs"]),
        ("sum", False): g(partial(_sin_loss_jax, partial(pal, fused_pose_bwd=False)))(
            *scene["jargs"]),
        ("max", True): g(partial(_sq_loss_jax, partial(pal, reducefn="max")))(*scene["jargs"]),
    }


def _loss(reduce):
    return ((lambda o: torch.sum(torch.sin(o * 0.1))) if reduce == "sum"
            else (lambda o: torch.sum(o ** 2)))


@pytest.mark.parametrize("reduce, fused", [("sum", True), ("sum", False), ("max", True)],
                         ids=["sum_fused", "sum_two_pass", "mip_fused"])
def test_gradients_match_pallas(scene, grads, reduce, fused):
    """d/d(volume, source, target, weights) through ``joseph_fwdgrad`` (fused)
    or ``joseph_fwd``/``joseph_fwd_max`` + ``joseph_bwd_rays``, and
    ``joseph_bwd_vol``; MIP gated to the argmax step."""
    _, got = _port_grads(scene["args"], _loss(reduce), axis=scene["axis"], reduce=reduce,
                         fused=fused)
    for name, g, ref, rel in zip(("density", "source", "target", "weights"), got,
                                 grads[(reduce, fused)], (1e-4, 1e-3, 1e-3, 1e-3)):
        assert np.abs(np.asarray(ref)).max() > 0, name
        _close(g, ref, rel)


def test_mip_two_pass_matches_pallas(scene, grads):
    """The MIP pose gradient by ``joseph_fwd_max`` + ``joseph_bwd_rays``."""
    _, got = _port_grads(scene["args"], _loss("max"), axis=scene["axis"], reduce="max",
                         fused=False)
    for g, ref, rel in zip(got, grads[("max", True)], (1e-4, 1e-3, 1e-3, 1e-3)):
        _close(g, ref, rel)


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("step", [1, 2.5])
def test_two_pass_backward_equals_fused(scene, reduce, step):
    loss = _loss(reduce)
    va, ga = _port_grads(scene["args"], loss, axis=scene["axis"], step=step, reduce=reduce,
                         fused=True)
    vb, gb = _port_grads(scene["args"], loss, axis=scene["axis"], step=step, reduce=reduce,
                         fused=False)
    torch.testing.assert_close(va, vb, rtol=0, atol=1e-6 * vb.abs().max().item())
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a, b, atol=1e-6 * b.abs().max().item() + 1e-12)


def test_fused_rows_are_the_two_pass_rows(scene):
    """``joseph_fwdgrad`` rows * g equal ``joseph_bwd_rays`` (sum and MIP), and
    its value and argmax equal ``joseph_fwd``/``joseph_fwd_max``."""
    vol, sv, tv, w = (_t(x) for x in scene["args"])
    ax = scene["axis"]
    rows = prep_rays(sv, tv, w, ax, vol.shape, quadrature="joseph", h=1.0)
    g = torch.tensor(np.random.default_rng(3).normal(size=rows.shape[1]), dtype=torch.float32)
    n = vol.shape[ax]
    allrows, arg = J.joseph_fwdgrad(rows, vol, ax, 1.0, n)
    assert arg is None
    torch.testing.assert_close(allrows[7], J.joseph_fwd(rows, vol, ax, 1.0, n), rtol=0, atol=0)
    torch.testing.assert_close(allrows[:7] * g, J.joseph_bwd_rays(rows, vol, ax, 1.0, n, g),
                               rtol=0, atol=0)
    mrows, marg = J.joseph_fwdgrad(rows, vol, ax, 1.0, n, "max")
    val, arg = J.joseph_fwd_max(rows, vol, ax, 1.0, n)
    assert torch.equal(marg, arg) and (arg >= 0).sum() > 500
    torch.testing.assert_close(mrows[7], val, rtol=0, atol=0)
    torch.testing.assert_close(mrows[:7] * g, J.joseph_bwd_rays(rows, vol, ax, 1.0, n, g, arg),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def dense_scene():
    """A dense random (24, 20, 16) volume and 16x16 rays along axis 0 with
    transverse slopes up to 0.6: many rays leave through a y or z face, so
    their last in-slab steps and boundary voxels carry weight."""
    rng = np.random.default_rng(7)
    vol = rng.uniform(0.5, 1.5, (24, 20, 16)).astype(np.float32)
    src = np.array([[[-30.3, 9.71, 7.93]]], np.float32)
    u, v = np.meshgrid(np.linspace(-24.1, 44.3, 16), np.linspace(-21.7, 37.9, 16),
                       indexing="ij")
    tgt = np.stack([np.full_like(u, 60.37), u, v], -1).reshape(1, 256, 3).astype(np.float32)
    wgt = np.linalg.norm(tgt - src, axis=-1)[:, None, :].astype(np.float32)
    args = (vol, src, tgt, wgt)
    pal = partial(joseph_pallas_raycast, image_shape=(16, 16), axis=0, **PALLAS)
    jargs = tuple(jnp.asarray(x) for x in args)
    ref = np.asarray(pal(*jargs))
    g = jax.grad(partial(_sin_loss_jax, pal), argnums=(0, 1, 2, 3))(*jargs)
    return dict(args=args, ref=ref, grads=g)


def test_dense_volume_transverse_exits(dense_scene):
    """Boundary steps on a dense volume: forward and all four gradients."""
    sc = dense_scene
    sv, tv = torch.tensor(sc["args"][1]), torch.tensor(sc["args"][2])
    rows = prep_rays(sv, tv, torch.tensor(sc["args"][3]), 0, sc["args"][0].shape,
                     quadrature="joseph")
    d = tv - sv
    exits_side = ((rows[7] < rows[8]) & ((sv[..., 0] + rows[8] * d[..., 0]) < 23.0)).sum()
    assert exits_side > 30  # rays leaving through a transverse face
    val, got = _port_grads(sc["args"], _loss("sum"), axis=0)
    _close(val, sc["ref"], 1e-4)
    for g, ref, rel in zip(got, sc["grads"], (1e-4, 1e-3, 1e-3, 1e-3)):
        _close(g, ref, rel)


# -----------------------------------------------------------------------------
# The oracles
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("step, reduce", [(1, "sum"), (1.37, "max")])
def test_joseph_oracle_matches_jax(scene, step, reduce):
    """``ops/joseph.py`` against ``diffdrr_tpu.ops.joseph``: values and, by
    autograd, the gradients w.r.t. volume, source, target and weights."""
    ax = scene["axis"]
    fn = partial(jjoseph, axis=ax, step=step, reducefn=reduce)
    ref = np.asarray(fn(*scene["jargs"]))
    jg = jax.jit(jax.grad(partial(_sin_loss_jax, fn), argnums=(0, 1, 2, 3)))(*scene["jargs"])
    leaves = [_t(x, True) for x in scene["args"]]
    got = joseph_raycast(*leaves, axis=ax, step=step, reducefn=reduce)
    _close(got.detach(), ref, 1e-5)
    torch.sum(torch.sin(got * 0.1)).backward()
    for x, g in zip(leaves, jg):
        _close(x.grad, g, 1e-4)


def test_joseph_oracle_takes_a_callable_reducefn(scene):
    ax = scene["axis"]
    top = lambda img: img.max(-1).values + img.min(-1).values  # noqa: E731
    got = joseph_raycast(*(_t(x) for x in scene["args"]), axis=ax, reducefn=top)
    ref = np.asarray(jjoseph(*scene["jargs"], axis=ax,
                             reducefn=lambda img: img.max(-1) + img.min(-1)))
    _close(got, ref, 1e-5)


def test_choose_march_axis_matches_jax(scene):
    sv, tv = scene["args"][1], scene["args"][2]
    assert choose_march_axis(torch.tensor(sv), torch.tensor(tv)) == jchoose(sv, tv)
    rng = np.random.default_rng(0)
    for _ in range(5):
        s, t = rng.normal(size=(1, 1, 3)), rng.normal(size=(1, 7, 3)) * 10
        assert choose_march_axis(torch.tensor(s), torch.tensor(t)) == jchoose(s, t)


@pytest.mark.parametrize("align_corners", [False, True])
def test_trilinear_sampling_matches_jax(align_corners):
    """Trilinear ``sample_volume``: values and gradients w.r.t. the volume and
    the points, corners outside the volume included (zero padding)."""
    rng = np.random.default_rng(11 + align_corners)
    vol = rng.uniform(0, 1, (7, 6, 5)).astype(np.float32)
    pts = rng.uniform(-1.7, 7.9, (3, 40, 3)).astype(np.float32)

    def jf(v, p):
        return jnp.sum(jnp.sin(jsample(v, p, mode="trilinear", align_corners=align_corners)))

    ref = np.asarray(jsample(jnp.asarray(vol), jnp.asarray(pts), align_corners=align_corners))
    jgv, jgp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(pts))
    v, p = _t(vol, True), _t(pts, True)
    got = sample_volume(v, p, mode="trilinear", align_corners=align_corners)
    _close(got.detach(), ref, 1e-6)
    torch.sum(torch.sin(got)).backward()
    _close(v.grad, jgv, 1e-5)
    _close(p.grad, jgp, 1e-5)
    near = sample_volume(_t(vol), _t(pts), mode="nearest", align_corners=align_corners)
    _close(near, jsample(jnp.asarray(vol), jnp.asarray(pts), mode="nearest",
                         align_corners=align_corners), 0)
