"""The port's gradient NCC, mutual information and SE(3) geodesics against
the JAX package's, on the CPU.

Inputs are made from seeded numpy and given to both packages. Tolerances:
metric values 1e-5 relative, their gradients atol 1e-4 * max|g_ref|, the
blur and the Sobel maps 1e-6 * max|ref|, geodesics 1e-5 mm where float32
resolves it (see the two geodesic tests). Mutual
information is held on its dense path (N below the chunk) and on its
streamed path (a chunk smaller than N), each against the JAX package. The
flat-patch and finite-difference regressions of ``tests/test_metrics.py``
(patch NCC) are carried over to the gradient NCC. Geodesics of random
poses (angles of ~0.4 rad: float32 holds the rotational term, ~200 mm, to
~5e-5 mm) agree to 1e-5 mm plus 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffdrr_tpu.metrics as JM
from diffdrr_tpu.pose import convert as jconvert

import diffdrr_tpu_torch.metrics as TM
from diffdrr_tpu_torch.pose import convert as tconvert


def _imgs(seed=0, B=2, C=1, H=24, W=24):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 1, (B, C, H, W)).astype(np.float32)
    x2 = np.clip(x1 + rng.normal(0, 0.1, x1.shape), 0, 1).astype(np.float32)
    return x1, x2


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _value_and_grad(jfn, tfn, x1, x2):
    """Values and d(sum)/d(x1) of a metric in both packages."""
    jv, jg = jax.jit(jax.value_and_grad(lambda a: jnp.sum(jfn(a, jnp.asarray(x2)))))(
        jnp.asarray(x1))
    jv = np.asarray(jax.jit(jfn)(jnp.asarray(x1), jnp.asarray(x2)))
    x = torch.tensor(x1, requires_grad=True)
    tv = tfn(x, torch.tensor(x2))
    torch.sum(tv).backward()
    return tv.detach().numpy(), x.grad.numpy(), jv, np.asarray(jg)


def test_port_has_every_public_name():
    assert set(JM.__all__) <= set(TM.__all__)
    for name in JM.__all__:
        assert hasattr(TM, name), name


@pytest.mark.parametrize("kernel_size,sigma", [(7, 1.0), (5, 0.8), (13, 2.0)])
def test_gaussian_blur_matches_jax(kernel_size, sigma):
    x1, _ = _imgs(1, H=20, W=28)
    ref = np.asarray(JM.gaussian_blur(jnp.asarray(x1), kernel_size, sigma))
    _close(TM.gaussian_blur(torch.tensor(x1), kernel_size, sigma), ref, 1e-6)
    np.testing.assert_allclose(TM._gaussian_kernel1d(kernel_size, sigma),
                               JM._gaussian_kernel1d(kernel_size, sigma), rtol=1e-6)


@pytest.mark.parametrize("sigma", [0.0, 1.0, 1.5])
def test_sobel_matches_jax(sigma):
    x1, _ = _imgs(2, H=21, W=26)
    ref = np.asarray(JM.sobel(jnp.asarray(x1), sigma))
    got = TM.Sobel(sigma)(torch.tensor(x1))
    assert got.shape == (2, 2, 21, 26)
    _close(got, ref, 1e-6)
    # The stencils run in true float32 whatever the caller set.
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("patch_size,var_floor", [(None, 0.0), (5, 0.0), (13, 0.0), (9, 1e-3)],
                         ids=["global", "p5", "p13", "p9_floor"])
def test_gradient_ncc_matches_jax(patch_size, var_floor):
    """Generic images. (A flat block's blurred edge makes patches whose
    variance sits at the gate's eps; there each float32 package is ~1e-5 off
    the float64 value, and the flat-region test below covers the gating.)"""
    x1, x2 = _imgs(3, H=32, W=32)
    kw = dict(patch_size=patch_size, sigma=1.0, var_floor=var_floor)
    tv, tg, jv, jg = _value_and_grad(JM.GradientNormalizedCrossCorrelation2d(**kw),
                                     TM.GradientNormalizedCrossCorrelation2d(**kw), x1, x2)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _close(tg, jg, 1e-4)


def test_gradient_ncc_self_is_one_and_orders():
    x1, x2 = _imgs(4)
    m = TM.GradientNormalizedCrossCorrelation2d(sigma=1.0)
    a, b = torch.tensor(x1), torch.tensor(x2)
    # 1 up to the eps added to each variance, as in the JAX package.
    np.testing.assert_allclose(m(a, a).numpy(), np.asarray(JM.GradientNormalizedCrossCorrelation2d(
        sigma=1.0)(jnp.asarray(x1), jnp.asarray(x1))), rtol=1e-5)
    assert (m(a, a) > 0.9999).all()
    noise = torch.tensor(np.random.default_rng(5).uniform(0, 1, x1.shape).astype(np.float32))
    assert (m(a, b) > m(a, noise)).all()


def test_gradient_ncc_gradient_bounded_with_flat_regions():
    """``tests/test_metrics.py``'s flat-region regression on the gradient NCC:
    exactly flat borders (a DRR against air) have Sobel maps of exactly 0,
    flat-flat patches contribute 0 with 0 gradient, the gradient stays
    bounded and matches finite differences. A pixel reaches Sobel values 4
    rows away (blur 3, stencil 1) and they reach patch centres 6 further
    (13x13 patches); the texture starts at row 40, so rows below 16 see no
    patch with texture and get exactly 0."""
    rng = np.random.default_rng(5)
    x = np.zeros((1, 1, 96, 96), np.float32)
    y = np.zeros((1, 1, 96, 96), np.float32)
    x[:, :, 40:64, 40:64] = rng.random((24, 24), np.float32)
    y[:, :, 40:64, 40:64] = x[:, :, 40:64, 40:64] + 0.05 * rng.random((24, 24), np.float32)
    metric = TM.GradientNormalizedCrossCorrelation2d(13)

    def loss(a):
        return torch.mean(metric(a, torch.tensor(y, dtype=a.dtype)))

    xt = torch.tensor(x, requires_grad=True)
    loss(xt).backward()
    g = xt.grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g).max() < 10.0, np.abs(g).max()
    assert np.abs(g[:, :, :16, :]).max() < 1e-8  # deep in the flat-flat region

    d = rng.normal(size=x.shape)
    d /= np.linalg.norm(d)
    h = 1e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(x + h * d, dtype=torch.float64)))
              - float(loss(torch.tensor(x - h * d, dtype=torch.float64)))) / (2 * h)
    an = float(np.sum(g * d))
    assert abs(fd - an) < 0.05 * (abs(fd) + abs(an) + 1e-3), (fd, an)


def test_gradient_ncc_var_floor_tracks_finite_differences():
    """``tests/test_metrics.py``'s var_floor regression on the gradient NCC:
    a bright blob on an exactly flat background against a shifted copy with
    faint noise in the air. ``var_floor=0`` is the metric without a floor,
    and with a floor the derivative along a smooth direction matches finite
    differences, in both packages alike."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:64, :64]
    tgt = np.where((yy - 32) ** 2 + (xx - 30) ** 2 < 120, 100.0, 0.0).astype(np.float32)
    img0 = (np.roll(tgt, 3, axis=1) + rng.normal(0, 1e-3, tgt.shape)).astype(np.float32)
    t, x0 = torch.tensor(tgt)[None, None], torch.tensor(img0)[None, None]
    a = TM.GradientNormalizedCrossCorrelation2d(13)(x0, t)
    b = TM.GradientNormalizedCrossCorrelation2d(13, var_floor=0.0)(x0, t)
    torch.testing.assert_close(a, b, rtol=0, atol=0)

    metric = TM.GradientNormalizedCrossCorrelation2d(13, var_floor=1e-3)
    jmetric = JM.GradientNormalizedCrossCorrelation2d(13, var_floor=1e-3)

    def loss(s):
        return torch.mean(metric(x0 * (1.0 + s) + s * t, t))

    s = torch.zeros((), requires_grad=True)
    loss(s).backward()
    g = float(s.grad)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-3), (g, fd)
    jt, jx = jnp.asarray(tgt)[None, None], jnp.asarray(img0)[None, None]
    jg = float(jax.jit(jax.grad(lambda s: jnp.mean(jmetric(jx * (1.0 + s) + s * jt, jt))))(
        jnp.float32(0.0)))
    np.testing.assert_allclose(g, jg, rtol=1e-4)


@pytest.mark.parametrize("chunk", [16384, 512], ids=["dense", "streamed"])
@pytest.mark.parametrize("channels", [1, 2])
def test_histogram_sums_and_mutual_information_match_jax(monkeypatch, chunk, channels):
    """MI on a 60x60 image (3,600 pixels): dense, and streamed in chunks of
    512 (8 of them, the last short), both against the JAX package's MI
    (dense at this size); values 1e-5 relative, gradients 1e-4 * max."""
    x1, x2 = _imgs(6, C=channels, H=60, W=60)
    real = TM._histogram_sums
    monkeypatch.setattr(TM, "_histogram_sums",
                        lambda v1, v2, bins, sigma: real(v1, v2, bins, sigma, chunk=chunk))
    for kw in (dict(), dict(num_bins=64, sigma=0.05, normalize=False)):
        tv, tg, jv, jg = _value_and_grad(JM.MutualInformation(**kw), TM.MutualInformation(**kw),
                                         x1, x2)
        assert tv.shape == (2,)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        _close(tg, jg, 1e-4)


def test_streamed_histogram_sums_equal_dense_and_keep_no_kernel_values():
    rng = np.random.default_rng(3)
    v1 = torch.tensor(rng.uniform(0, 1, (2, 3600)).astype(np.float32), requires_grad=True)
    v2 = torch.tensor(rng.uniform(0, 1, (2, 3600)).astype(np.float32))
    bins = torch.linspace(0, 1, 64)
    dense = TM._histogram_sums(v1, v2, bins, 0.1, chunk=10_000)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        streamed = TM._histogram_sums(v1, v2, bins, 0.1, chunk=512)
    # Under checkpoint a chunk keeps only its inputs: no (B, chunk, bins) tensor.
    assert max(saved) < 2 * 512 * 64
    for a, b in zip(streamed, dense):
        _close(a.detach(), b.detach(), 2e-6)
    gd = torch.autograd.grad(sum(torch.sum(t * t) for t in dense), v1)[0]
    gs = torch.autograd.grad(sum(torch.sum(t * t) for t in streamed), v1)[0]
    _close(gs, gd, 1e-5)


def _poses(seed, n=4):
    rng = np.random.default_rng(seed)
    rot = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    trans = rng.normal(0, 30.0, (n, 3)).astype(np.float32)
    return rot, trans


@pytest.mark.parametrize("parameterization,convention", [("euler_angles", "ZXY"),
                                                         ("axis_angle", None)])
def test_geodesics_match_jax(parameterization, convention):
    (r1, t1), (r2, t2) = _poses(7), _poses(8)
    r2[0], t2[0] = r1[0], t1[0]  # one pair at distance 0
    kw = dict(parameterization=parameterization, convention=convention)
    tp1, tp2 = tconvert(torch.tensor(r1), torch.tensor(t1), **kw), tconvert(
        torch.tensor(r2), torch.tensor(t2), **kw)

    def jgeo(r1, t1, r2, t2):
        p1, p2 = jconvert(r1, t1, **kw), jconvert(r2, t2, **kw)
        return (*JM.DoubleGeodesicSE3(sdd=1020.0)(p1, p2), JM.LogGeodesicSE3()(p1, p2))

    j = jax.jit(jgeo)(*(jnp.asarray(v) for v in (r1, t1, r2, t2)))
    t = (*TM.DoubleGeodesicSE3(sdd=1020.0)(tp1, tp2), TM.LogGeodesicSE3()(tp1, tp2))
    for jv, tv in zip(j, t):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    rot, xyz, dou = TM.DoubleGeodesicSE3(sdd=1020.0)(tp1, tp2)
    np.testing.assert_allclose(dou[0], np.sqrt(1e-6), atol=1e-5)
    np.testing.assert_allclose(dou.numpy(), np.sqrt(rot.numpy() ** 2 + xyz.numpy() ** 2 + 1e-6),
                               rtol=1e-6)


def test_double_geodesic_small_offsets():
    """At the registration CLI's scale (a true pose at 850 mm, offsets of mm
    and mrad): the rotational term agrees to 1e-5 mm. The translational
    term (and the double) cannot: float32 resolves 6.1e-5 mm at 850 mm, and
    the two packages invert the pose in another order, so each is held
    against the float64 evaluation to that one step."""
    rot = np.array([[0.0, np.pi / 2, 0.0]], np.float32)
    trans = np.array([[0.0, 850.0, 0.0]], np.float32)
    d_rot = np.array([[1e-3, -2e-3, 5e-4], [0.0, 0.0, 0.0], [2e-2, 1e-2, -3e-2]], np.float32)
    d_trans = np.array([[0.3, -0.2, 0.5], [1.0, 0.0, 0.0], [5.0, -4.0, 3.0]], np.float32)
    kw = dict(parameterization="euler_angles", convention="ZXY")

    def jgeo(r1, t1, r2, t2):
        return JM.DoubleGeodesicSE3(1020.0)(jconvert(r1, t1, **kw), jconvert(r2, t2, **kw))

    j = jax.jit(jgeo)(*(jnp.asarray(v) for v in (rot, trans, rot + d_rot, trans + d_trans)))
    t, t64 = ([v.numpy() for v in TM.DoubleGeodesicSE3(1020.0)(
        tconvert(torch.tensor(rot, dtype=dt), torch.tensor(trans, dtype=dt), **kw),
        tconvert(torch.tensor(rot + d_rot, dtype=dt), torch.tensor(trans + d_trans, dtype=dt),
                 **kw))] for dt in (torch.float32, torch.float64))
    np.testing.assert_allclose(t[0], np.asarray(j[0]), atol=1e-5, rtol=0)
    ulp = float(np.spacing(np.float32(850.0)))
    for k in (1, 2):
        np.testing.assert_allclose(t[k], t64[k], atol=ulp, rtol=0)
        np.testing.assert_allclose(np.asarray(j[k]), t64[k], atol=ulp, rtol=0)
