"""Per-structure channels (``mask_to_channels``) against the JAX package, on the CPU.

The same seeded NumPy inputs go through the JAX package and the port:

  * ``scatter_channels`` and the three oracles with a labelmap against
    ``diffdrr_tpu.ops``, values and gradients to density, source and target;
  * the kernel path (the plain versions of ``joseph_fwd_ch``,
    ``joseph_bwd_rays_ch`` and ``joseph_bwd_vol_ch``, their CPU path, through
    ``JosephMarchChannels``) against ``joseph_pallas_raycast`` and
    ``raymarch_pallas_raycast`` with ``mask``/``n_channels`` in interpret
    mode, which reaches the channel mode of ``_fwd_kernel``,
    ``_bwd_rays_kernel`` and ``_bwd_vol_kernel``. Strides h = 1, 2, 1.375,
    0.5 and ~0.26. At h = 0.5 every odd step is a tie of the plane pair:
    the kernels take plane k0 there and the oracles round half to even, so
    the kernel path is held only against the kernels;
  * ``DRR(..., mask_to_channels=True)`` for the three renderers against the
    JAX DRR (joseph and trilinear with ``force_xla=True``, where both
    packages run their oracles), and the port's kernel path through the DRR
    against the JAX kernels.

Tolerances: values 1e-4 * max and gradients 1e-3 * max for the pose rows
and 1e-4 for the density on the kernel path (as ``tests/test_torch_joseph.py``:
the TPU kernel sums its bilinear weights by matmul); 1e-5 * max for the
oracles and ``scatter_channels``, which do the same float32 operations,
except the oracles' density gradient, 1e-4 * max (as in
``tests/test_torch_joseph.py``: XLA and PyTorch add its scatters in
different orders).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops._raygeom import scatter_channels as jscatter
from diffdrr_tpu.ops.joseph import joseph_raycast as jjoseph
from diffdrr_tpu.ops.pallas.joseph import joseph_pallas_raycast
from diffdrr_tpu.ops.pallas.raymarch import raymarch_pallas_raycast
from diffdrr_tpu.ops.siddon import siddon_raycast as jsiddon
from diffdrr_tpu.ops.trilinear import trilinear_raycast as jtrilinear

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.ops import joseph_raycast, scatter_channels, siddon_raycast
from diffdrr_tpu_torch.ops import trilinear_raycast
from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
from diffdrr_tpu_torch.ops.kernels.raymarch import raymarch_raycast
from diffdrr_tpu_torch.pose import convert

ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def test_scatter_channels_matches_jax():
    """Channels at C and above are dropped; the gradient reaches ``img``."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 5, 9)).astype(np.float32)
    ch = rng.integers(0, 6, (2, 5, 9)).astype(np.int32)  # 4 and 5 drop at C = 4
    wt = rng.normal(size=(2, 4, 5)).astype(np.float32)
    ref = np.asarray(jscatter(jnp.asarray(img), jnp.asarray(ch), 4))
    jg = jax.grad(lambda x: jnp.sum(jscatter(x, jnp.asarray(ch), 4) * wt))(jnp.asarray(img))
    x = _t(img, True)
    got = scatter_channels(x, torch.tensor(ch), 4)
    assert got.shape == (2, 4, 5)
    _close(got.detach(), ref, 1e-6)
    (got * _t(wt)).sum().backward()
    _close(x.grad, jg, 1e-6)


def test_negative_labels_drop():
    """A negative label adds nothing, in the oracle's scatter as in the
    channel kernels (the Pallas kernels' one-hot never matches it). The JAX
    oracle's ``.at[].add(mode="drop")`` instead wraps -1 to the last channel,
    as a NumPy index would: the two JAX paths disagree there, and the port
    keeps the kernels' rule in both of its paths."""
    img = torch.ones((1, 1, 4))
    got = scatter_channels(img, torch.tensor([[[-1, -5, 4, 1]]]), 4)
    assert got.reshape(-1).tolist() == [0.0, 1.0, 0.0, 0.0]
    assert np.asarray(jscatter(jnp.ones((1, 1, 4)), jnp.array([[[-1, -5, 4, 1]]]), 4)
                      ).reshape(-1).tolist() == [0.0, 1.0, 0.0, 1.0]
    rows = prep_rays(torch.tensor([[[-9.0, 2.2, 1.7]]]), torch.tensor([[[9.0, 2.9, 2.1]]]),
                     torch.ones((1, 1, 1)), 0, (6, 5, 4), quadrature="joseph")
    vol = torch.rand((6, 5, 4), generator=torch.Generator().manual_seed(0))
    lab = torch.full((6, 5, 4), -1, dtype=torch.int32)
    assert torch.count_nonzero(J.joseph_fwd_ch(rows, vol, lab, 0, 1.0, 6, 2)) == 0


# -----------------------------------------------------------------------------
# The oracles
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oscene():
    """A 48x48x24 phantom with its 7 labels, a 16x16 detector, an off-grid pose."""
    subject = jload(shape=(48, 48, 24))
    jd = JDRR(subject, sdd=800.0, height=16, delx=4.0)
    source, target = jd.detector(jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW), None)
    weights = jnp.linalg.norm(target - source, axis=-1)[:, None, :]
    args = (jd.density, jd.affine_inverse(source), jd.affine_inverse(target), weights)
    mask = np.asarray(subject.mask.data)
    return dict(args=tuple(np.asarray(a) for a in args), mask=mask,
                n=int(mask.max()) + 1, jd=jd, jargs=args, state=interop.export_state(jd))


_ORACLES = {
    "siddon": (jsiddon, siddon_raycast, {}),
    "joseph": (jjoseph, joseph_raycast, dict(axis=2, step=1.37)),
    "trilinear": (jtrilinear, trilinear_raycast, dict(n_points=64)),
}


@pytest.mark.parametrize("name", sorted(_ORACLES))
def test_oracle_channels_match_jax(oscene, name):
    """Values and, by autograd, the gradients w.r.t. density, source and target."""
    jfn, tfn, kw = _ORACLES[name]
    n = oscene["n"]
    wc = np.random.default_rng(1).uniform(0.5, 1.5, n).astype(np.float32)
    jf = partial(jfn, mask=jnp.asarray(oscene["mask"], jnp.float32), n_channels=n, **kw)

    def jloss(*a):
        return jnp.sum(jnp.sin(jf(*a) * 0.1) * wc[None, :, None])

    jargs = tuple(jnp.asarray(a) for a in oscene["args"])
    ref = np.asarray(jax.jit(jf)(*jargs))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jargs)
    leaves = [_t(a, True) for a in oscene["args"]]
    got = tfn(*leaves, mask=torch.tensor(oscene["mask"]), n_channels=n, **kw)
    assert got.shape == ref.shape == (1, n, 256)
    _close(got.detach(), ref, 1e-5)
    (torch.sin(got * 0.1) * _t(wc)[None, :, None]).sum().backward()
    for x, g, rel in zip(leaves, jg, (1e-4, 1e-5, 1e-5)):
        assert np.abs(np.asarray(g)).max() > 0
        _close(x.grad, g, rel)
    with pytest.raises(ValueError, match="n_channels"):
        tfn(*(_t(a) for a in oscene["args"]), mask=torch.tensor(oscene["mask"]), **kw)


def test_oracle_channels_ignore_reducefn(oscene):
    mask = torch.tensor(oscene["mask"])
    args = [_t(a) for a in oscene["args"]]
    kw = dict(mask=mask, n_channels=oscene["n"], axis=2)
    torch.testing.assert_close(joseph_raycast(*args, reducefn="max", **kw),
                               joseph_raycast(*args, **kw), rtol=0, atol=0)


# -----------------------------------------------------------------------------
# The kernel path against the Pallas kernels (interpret mode)
# -----------------------------------------------------------------------------

DIMS = (12, 24, 24)
PALLAS = dict(image_shape=(16, 16), axis=0, tile=16, ky=48, zw=128, zc=128, interpret=True)
# (label, joseph step or None, raymarch n_points or None): X = 12 planes.
STRIDES = [("h1", 1.0, None), ("h2", 2.0, None), ("h1.375", None, 9),
           ("h0.5_ties", None, 23), ("h0.26", None, 43)]


@pytest.fixture(scope="module")
def kscene():
    """A random 12x24x24 volume, a random labelmap of 5 labels, and 16x16 rays
    along axis 0 with transverse slopes up to ~0.4."""
    rng = np.random.default_rng(7)
    vol = rng.uniform(0.5, 1.5, DIMS).astype(np.float32)
    lab = rng.integers(0, 5, DIMS).astype(np.int32)
    src = np.array([[[-30.3, 11.71, 12.93]]], np.float32)
    u, v = np.meshgrid(np.linspace(-6.1, 30.3, 16), np.linspace(-5.7, 29.9, 16), indexing="ij")
    tgt = np.stack([np.full_like(u, 42.37), u, v], -1).reshape(1, 256, 3).astype(np.float32)
    w = np.linalg.norm(tgt - src, axis=-1)[:, None, :].astype(np.float32)
    return dict(args=(vol, src, tgt, w), lab=lab,
                wc=rng.uniform(0.5, 1.5, 5).astype(np.float32))


def _pallas(step, n_points, C, lab):
    if step is not None:
        fn = partial(joseph_pallas_raycast, step=step, **PALLAS)
    else:
        fn = partial(raymarch_pallas_raycast, n_points=n_points, allow_oversample=True, **PALLAS)
    return partial(fn, mask=jnp.asarray(lab, jnp.float32), n_channels=C)


def _port(leaves, step, n_points, C, lab):
    kw = dict(axis=0, mask=torch.tensor(lab), n_channels=C)
    if step is not None:
        return J.joseph_march_raycast(*leaves, step=step, **kw)
    return raymarch_raycast(*leaves, n_points=n_points, allow_oversample=True, **kw)


@pytest.mark.parametrize("label, step, n_points", STRIDES, ids=[s[0] for s in STRIDES])
def test_kernel_path_channels_match_pallas(kscene, label, step, n_points):
    """Value, and the gradients to density, source, target and weights of
    sum_c w_c sum sin(0.1 img_c), by one VJP of the Pallas channel kernels."""
    C = 5
    wc = kscene["wc"]
    fn = _pallas(step, n_points, C, kscene["lab"])
    jargs = tuple(jnp.asarray(a) for a in kscene["args"])
    ref, vjp = jax.vjp(fn, *jargs)
    jg = vjp(jnp.cos(ref * 0.1) * 0.1 * wc[None, :, None])
    leaves = [_t(a, True) for a in kscene["args"]]
    got = _port(leaves, step, n_points, C, kscene["lab"])
    assert got.shape == ref.shape == (1, C, 256)
    _close(got.detach(), ref, 1e-4)
    (torch.sin(got * 0.1) * _t(wc)[None, :, None]).sum().backward()
    for name, x, g, rel in zip(("density", "source", "target", "weights"), leaves, jg,
                               (1e-4, 1e-3, 1e-3, 1e-3)):
        assert np.abs(np.asarray(g)).max() > 0, name
        _close(x.grad, g, rel)


def test_labels_outside_the_channels_drop(kscene):
    """At n_channels = 3 the labels 3 and 4 add nothing: the first three
    channels of the 5-channel render, exactly, and the Pallas kernels' 3."""
    lab = kscene["lab"]
    args = [_t(a) for a in kscene["args"]]
    five = _port(args, None, 9, 5, lab)
    three = _port(args, None, 9, 3, lab)
    torch.testing.assert_close(three, five[:, :3], rtol=0, atol=0)
    ref = _pallas(None, 9, 3, lab)(*(jnp.asarray(a) for a in kscene["args"]))
    _close(three, ref, 1e-4)


def test_channel_kernels_sum_to_the_scalar_kernel(kscene):
    """With every label inside [0, C) the channels sum to joseph_fwd's render."""
    vol, src, tgt, w = (_t(a) for a in kscene["args"])
    for h, n in ((1.0, 12), (0.5, 23)):
        rows = prep_rays(src, tgt, w, 0, DIMS, quadrature="joseph", h=h)
        ch = J.joseph_fwd_ch(rows, vol, torch.tensor(kscene["lab"]), 0, h, n, 5)
        _close(ch.sum(0), J.joseph_fwd(rows, vol, 0, h, n), 1e-6)


def test_channel_wrappers_check_their_arguments(kscene):
    vol, src, tgt, w = (_t(a) for a in kscene["args"])
    rows = prep_rays(src, tgt, w, 0, DIMS, quadrature="joseph")
    lab = torch.tensor(kscene["lab"])
    with pytest.raises(ValueError, match="labels must be int32"):
        J.joseph_fwd_ch(rows, vol, lab.long(), 0, 1.0, 12, 5)
    with pytest.raises(ValueError, match="labels must be int32"):
        J.joseph_fwd_ch(rows, vol, lab[:-1], 0, 1.0, 12, 5)
    with pytest.raises(ValueError, match=r"g must be float32 \(C, 256\)"):
        J.joseph_bwd_rays_ch(rows, vol, lab, 0, 1.0, 12, torch.zeros(256))
    with pytest.raises(ValueError, match="n_channels"):
        J.joseph_march_raycast(vol, src, tgt, w, axis=0, mask=lab)
    assert J.as_labels(lab.double() + 0.2).equal(lab)


# -----------------------------------------------------------------------------
# Through the DRR
# -----------------------------------------------------------------------------


def _drr(state, renderer, **kw):
    return interop.drr_from_state(state, device="cpu", renderer=renderer, **kw)


@pytest.mark.parametrize("renderer, opts", [
    ("siddon", {}), ("joseph", dict(force_xla=True)),
    ("trilinear", dict(force_xla=True, n_points=64)),
], ids=["siddon", "joseph_xla", "trilinear_xla"])
def test_drr_channels_match_jax_drr(oscene, renderer, opts):
    """Siddon channels render on the oracle in both packages; joseph and
    trilinear with force_xla too."""
    jd, state = oscene["jd"], oscene["state"]
    jr = JDRR(jd.subject, sdd=800.0, height=16, delx=4.0, renderer=renderer)
    ref = np.asarray(jr(jnp.asarray(ROT), jnp.asarray(TRANS), mask_to_channels=True,
                        **{k: v for k, v in opts.items() if k != "force_xla"}, **KW))
    td = _drr(state, renderer)
    assert td.n_channels == jr.n_channels == 7 and td.mask.dtype == torch.int32
    got = td(torch.tensor(ROT), torch.tensor(TRANS), mask_to_channels=True, **opts, **KW)
    assert got.shape == ref.shape == (1, 7, 16, 16)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("renderer", ["joseph", "trilinear"])
def test_drr_channel_kernel_path_matches_jax_kernels(oscene, renderer):
    """The full frame's channels through the channel kernels (plain versions
    on the CPU) against the JAX kernels with the DRR's labelmap; they sum
    to the scalar render, and reducefn="max" is ignored under a mask."""
    state, rays = oscene["state"], oscene["jargs"]
    td = _drr(state, renderer, **(dict(n_points=48) if renderer == "trilinear" else {}))
    r, t = torch.tensor(ROT), torch.tensor(TRANS)
    got = td(r, t, mask_to_channels=True, **KW)
    fn = raymarch_pallas_raycast if renderer == "trilinear" else joseph_pallas_raycast
    ref = np.asarray(fn(*rays, axis=2, mask=jnp.asarray(state["mask"], jnp.float32),
                        n_channels=7, image_shape=(16, 16), tile=16, ky=64, zw=128,
                        zc=128, interpret=True)).reshape(got.shape)
    _close(got, ref, 1e-4)
    _close(got.sum(1, keepdim=True), td(r, t, **KW), 1e-6)
    if renderer == "joseph":
        torch.testing.assert_close(td(r, t, mask_to_channels=True, reducefn="max", **KW), got,
                                   rtol=0, atol=0)


def test_drr_channel_gradients_reach_density_and_pose(oscene, monkeypatch):
    """One backward of a channel render launches the two channel backwards
    and never the fused forward, whatever fused_pose_bwd says."""
    td = _drr(oscene["state"], "trilinear", n_points=48)
    called = []
    for fn in J.KERNELS:
        def counted(*a, _fn=fn, **k):
            called.append(_fn.__name__)
            return _fn(*a, **k)
        monkeypatch.setattr(J, fn.__name__, counted)
    rot = torch.tensor(ROT, requires_grad=True)
    dens = td.density.clone().requires_grad_(True)
    src, tgt = td.detector(convert(rot, torch.tensor(TRANS), **KW))
    img = td.render(dens, src, tgt, mask_to_channels=True, fused_pose_bwd=True)
    (img ** 2).sum().backward()
    assert sorted(called) == ["joseph_bwd_rays_ch", "joseph_bwd_vol_ch", "joseph_fwd_ch"]
    assert rot.grad.abs().max() > 0 and dens.grad.abs().max() > 0


def test_channels_without_a_labelmap_render_one_channel(oscene):
    td = _drr(dict(oscene["state"], mask=None), "joseph")
    assert td.mask is None and td.n_channels is None
    got = td(torch.tensor(ROT), torch.tensor(TRANS), mask_to_channels=True, **KW)
    ref = td(torch.tensor(ROT), torch.tensor(TRANS), force_xla=True, **KW)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)

