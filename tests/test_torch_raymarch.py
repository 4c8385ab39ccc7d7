"""The port's trilinear ray march against the JAX package, on the CPU.

The kernel path (``ops/kernels/raymarch.py`` over the Joseph kernels' plain
versions) is held against ``raymarch_pallas_raycast`` in interpret mode, as
``tests/test_raymarch.py`` runs it: the same plane-aligned samples, at
integer ``h`` (``n_points`` capped at one sample per plane), fractional
``h > 1`` (``n_points < X``) and ``h < 1`` (``allow_oversample``). The
oracle ``ops/trilinear.py`` (global equispaced alphas) is held against
``diffdrr_tpu.ops.trilinear``.

Scene: the 64x64x32 example phantom, a 32x32 detector, the off-grid pose
of ``tests/test_joseph.py``, march axis 2 (32 planes). Tolerances as in
``tests/test_torch_joseph.py``: values 1e-4 * max|ref|, gradients 1e-3
(source, target, weights) and 1e-4 (volume) of max|g_ref|.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.pallas.raymarch import raymarch_pallas_raycast
from diffdrr_tpu.ops.trilinear import trilinear_raycast as jtrilinear

from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_raycast, raymarch_steps
from diffdrr_tpu_torch.ops.trilinear import trilinear_raycast

AXIS = 2
X = 32  # planes along the march axis
# n_points -> (h, allow_oversample): integer, fractional > 1, fractional < 1
CASES = {"h1": (500, False), "h_gt1": (X // 2 + 3, False), "h_lt1": (X + X // 2, True)}


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


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
    args = (drr.density, sv, tv, weights)
    return dict(args=tuple(np.asarray(x) for x in args), jargs=args)


def _pallas(case, **kw):
    n_points, over = CASES[case]
    return partial(raymarch_pallas_raycast, image_shape=(32, 32), axis=AXIS, n_points=n_points,
                   allow_oversample=over, tile=16, ky=64, zw=256, interpret=True, **kw)


def _port(case, args, **kw):
    n_points, over = CASES[case]
    return raymarch_raycast(*args, axis=AXIS, n_points=n_points, allow_oversample=over, **kw)


def test_steps_map_n_points_to_a_stride():
    assert raymarch_steps(X, 500) == (1.0, X)  # capped at one sample per plane
    h, n = raymarch_steps(X, X // 2 + 3)
    assert n == X // 2 + 3 and J.is_blend(h) and h > 1
    h, n = raymarch_steps(X, X + X // 2, allow_oversample=True)
    assert n == X + X // 2 and J.is_blend(h) and h < 1
    assert raymarch_steps(X, 1) == (X - 1.0, 2)  # at least two samples


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas(scene, case, reduce):
    ref = np.asarray(_pallas(case, reducefn=reduce)(*scene["jargs"]))
    got = _port(case, [_t(x) for x in scene["args"]], reduce=reduce)
    _close(got, ref, 1e-4)


def test_n_points_cap(scene):
    """Above one sample per plane the march is capped: 4X points render what
    X points do, bit for bit; allow_oversample honours them (and differs)."""
    args = [_t(x) for x in scene["args"]]
    at_cap = raymarch_raycast(*args, axis=AXIS, n_points=X)
    torch.testing.assert_close(raymarch_raycast(*args, axis=AXIS, n_points=4 * X), at_cap,
                               rtol=0, atol=0)
    over = raymarch_raycast(*args, axis=AXIS, n_points=4 * X, allow_oversample=True)
    assert not torch.equal(over, at_cap)
    _close(over, at_cap, 0.05)  # the same integral, finer quadrature


@pytest.fixture(scope="module")
def grads(scene):
    def loss(fn, *a):
        return jnp.sum(jnp.sin(fn(*a) * 0.1))

    def mip_loss(fn, *a):
        return jnp.sum(fn(*a) ** 2)

    g = partial(jax.grad, argnums=(0, 1, 2, 3))
    return {
        ("h_gt1", "sum"): g(partial(loss, _pallas("h_gt1")))(*scene["jargs"]),
        ("h_lt1", "sum"): g(partial(loss, _pallas("h_lt1", fused_pose_bwd=False)))(
            *scene["jargs"]),
        ("h_lt1", "max"): g(partial(mip_loss, _pallas("h_lt1", reducefn="max")))(
            *scene["jargs"]),
    }


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
@pytest.mark.parametrize("case, reduce", [("h_gt1", "sum"), ("h_lt1", "sum"), ("h_lt1", "max")])
def test_gradients_match_pallas(scene, grads, case, reduce, fused):
    """The lerped march's gradients w.r.t. volume (8 voxels a step, split
    (1 - fx, fx)), source, target and weights, by either pose backward."""
    leaves = [_t(x, True) for x in scene["args"]]
    out = _port(case, leaves, reduce=reduce, fused=fused)
    (torch.sum(torch.sin(out * 0.1)) if reduce == "sum" else torch.sum(out ** 2)).backward()
    for x, ref, rel in zip(leaves, grads[(case, reduce)], (1e-4, 1e-3, 1e-3, 1e-3)):
        assert np.abs(np.asarray(ref)).max() > 0
        _close(x.grad, ref, rel)


@pytest.mark.parametrize("n_points, reduce", [(X, "sum"), (100, "max")])
def test_trilinear_oracle_matches_jax(scene, n_points, reduce):
    """``ops/trilinear.py``: values and autograd gradients vs ``jax.grad``.

    The phantom's flat regions give exact ties between samples, which a MIP
    breaks by rounding; seeded noise on the density keeps its argmax unique."""
    noise = np.random.default_rng(1).uniform(0.0, 1e-2, scene["args"][0].shape)
    args = ((scene["args"][0] + noise).astype(np.float32),) + scene["args"][1:]
    fn = partial(jtrilinear, n_points=n_points, reducefn=reduce)
    jargs = tuple(jnp.asarray(x) for x in args)
    ref = np.asarray(fn(*jargs))
    jg = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a) * 0.1)), argnums=(0, 1, 2, 3))(*jargs)
    leaves = [_t(x, True) for x in args]
    got = trilinear_raycast(*leaves, n_points=n_points, reducefn=reduce)
    _close(got.detach(), ref, 1e-5)
    torch.sum(torch.sin(got * 0.1)).backward()
    for x, g in zip(leaves, jg):
        _close(x.grad, g, 1e-4)


@pytest.mark.parametrize("opts", [dict(mode="nearest"), dict(align_corners=True),
                                  dict(alphamin=0.3, alphamax=0.7)],
                         ids=["nearest", "align_corners", "alpha_interval"])
def test_trilinear_oracle_options_match_jax(scene, opts):
    ref = np.asarray(jtrilinear(*scene["jargs"], n_points=64, **opts))
    topts = {k: (torch.tensor(v) if k.startswith("alpha") else v) for k, v in opts.items()}
    got = trilinear_raycast(*(_t(x) for x in scene["args"]), n_points=64, **topts)
    _close(got, ref, 1e-5)
