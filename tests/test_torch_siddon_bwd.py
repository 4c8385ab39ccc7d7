"""The port's MIP, density gradient, two-pass pose backward and
reconstruction step against the JAX package, on the CPU.

The same seeded NumPy inputs go through the JAX package's
``siddon_pallas_raycast`` (interpret mode, f32 storage, as
``tests/test_pallas_siddon.py`` runs it: that reaches ``_fwd_kernel`` in max
mode, ``_bwd_rays_kernel`` and ``_bwd_vol_kernel``), through its sort-based
oracle ``siddon_raycast``, and through the port: ``prep_rays`` + the plain
versions of ``siddon_fwd_max``/``siddon_bwd_rays``/``siddon_bwd_vol`` (the
wrappers' CPU path) + ``SiddonSlab``.

Tolerances mirror ``tests/test_pallas_siddon.py``, which holds the JAX
kernels against the oracle, because the port repeats the kernels' float32
slab arithmetic:
  * MIP forward: atol 1e-5 * max|ref| (the maxima are single products
    len * w * V; only the segment lengths' rounding differs from the oracle);
  * MIP gradients w.r.t. density, source, target, weights: max abs error
    below 1e-4 of max|ref| (one segment per ray carries the gradient);
  * the density gradient in sum mode, fused or two-pass forward: atol
    1e-3 * max|ref| (a sum over each voxel's rays of len * w * g);
  * two-pass vs fused pose gradients: atol 1e-6 * max (the same terms,
    multiplied by g in the same order), and vs the JAX two-pass kernel
    atol 1e-3 * max, as ``tests/test_torch_siddon.py`` holds the fused one.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.pallas.siddon import siddon_pallas_raycast
from diffdrr_tpu.ops.siddon import siddon_raycast as jax_oracle
from diffdrr_tpu.parallel import make_mesh, make_reconstruction_step as jmake_recon

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.parallel import make_mesh as tmake_mesh, make_reconstruction_step

KW = dict(parameterization="euler_angles", convention="ZXY")


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


def _port_grads(vol, sv, tv, w, loss, **kw):
    """Port render + autograd: (value, [d/d density, source, target, weights])."""
    leaves = [_t(x, True) for x in (vol, sv, tv, w)]
    out = K.siddon_slab_raycast(*leaves, **kw)
    loss(out).backward()
    return out.detach(), [x.grad for x in leaves]


# -----------------------------------------------------------------------------
# MIP (test_pallas_siddon.py:207-270)
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mip_forward_scene():
    """24^3 random volume, 16x16 rays along axis 0 (test_pallas_siddon.py:207)."""
    rng = np.random.default_rng(4)
    vol = rng.random((24, 24, 24)).astype(np.float32)
    ys, zs = np.meshgrid(np.linspace(1.0, 23.0, 16), np.linspace(1.0, 23.0, 16), indexing="ij")
    tv = np.stack([np.full(ys.size, 50.0), ys.ravel(), zs.ravel()], 1)[None].astype(np.float32)
    sv = np.array([[[-50.0, 11.7, 12.3]]], np.float32)
    w = np.ones((1, 1, 256), np.float32)
    args = tuple(jnp.asarray(x) for x in (vol, sv, tv, w))
    ref = {
        "pallas": np.asarray(siddon_pallas_raycast(
            *args, image_shape=(16, 16), axis=0, tile=16, ky=64, zw=256, interpret=True,
            reducefn="max")),
        "oracle": np.asarray(jax_oracle(*args, reducefn="max")),
        "sum": np.asarray(jax_oracle(*args)),
    }
    return dict(vol=vol, sv=sv, tv=tv, w=w, ref=ref)


@pytest.mark.parametrize("ref_name", ["pallas", "oracle"])
def test_mip_forward_matches_jax(mip_forward_scene, ref_name):
    sc = mip_forward_scene
    got = K.siddon_slab_raycast(_t(sc["vol"]), _t(sc["sv"]), _t(sc["tv"]), _t(sc["w"]),
                                axis=0, reduce="max")
    _close(got, sc["ref"][ref_name], 1e-5)
    assert not np.allclose(got, sc["ref"]["sum"])


@pytest.fixture(scope="module")
def mip_grad_scene():
    """(40, 36, 32) random volume, generic pose (test_pallas_siddon.py:241)."""
    rng = np.random.default_rng(4)
    vol = rng.uniform(0.1, 1.0, (40, 36, 32)).astype(np.float32)
    src = np.array([[[-25.3137, 17.351, 15.2321]]], np.float32)
    u, v = np.meshgrid(np.linspace(5.1371, 30.211, 16), np.linspace(4.0913, 27.317, 16),
                       indexing="ij")
    tgt = np.stack([np.full_like(u, 70.137), u, v], -1).reshape(1, 256, 3).astype(np.float32)
    wgt = np.linalg.norm(tgt - src, axis=-1)[:, None, :].astype(np.float32)
    kw = dict(image_shape=(16, 16), axis=0, tile=16, ky=64, zw=256, zc=128, interpret=True)

    def loss(f):
        return lambda *a: jnp.sum(f(*a) ** 2)

    args = tuple(jnp.asarray(x) for x in (vol, src, tgt, wgt))
    ref = {
        "oracle": jax.grad(loss(lambda *a: jax_oracle(*a, reducefn="max")),
                           argnums=(0, 1, 2, 3))(*args),
        "pallas": jax.grad(loss(lambda *a: siddon_pallas_raycast(*a, reducefn="max", **kw)),
                           argnums=(0, 1, 2, 3))(*args),
    }
    return dict(args=(vol, src, tgt, wgt), ref=ref)


@pytest.mark.parametrize("ref_name", ["pallas", "oracle"])
def test_mip_gradients_match_jax(mip_grad_scene, ref_name):
    """d/d(density, source, target, weights) of sum(MIP**2): the argmax gates
    siddon_bwd_vol and siddon_bwd_rays, boundary terms included."""
    _, grads = _port_grads(*mip_grad_scene["args"], lambda o: torch.sum(o ** 2),
                           axis=0, reduce="max")
    for name, got, ref in zip(("density", "source", "target", "weights"), grads,
                              mip_grad_scene["ref"][ref_name]):
        assert _rel_err(got, ref) < 1e-4, name


# -----------------------------------------------------------------------------
# Sum mode: density gradient, two-pass pose backward (test_pallas_siddon.py:47-64, 273-297)
# -----------------------------------------------------------------------------


def _sin_loss_jax(fn, vol, s, t, w):
    return jnp.sum(jnp.sin(fn(vol, s, t, w) * 0.1))


def _sin_loss(out):
    return torch.sum(torch.sin(out * 0.1))


@pytest.fixture(scope="module")
def scene():
    """64x64x32 phantom, 32x32 detector, an off-grid pose; JAX references."""
    subject = jload(shape=(64, 64, 32))
    drr = JDRR(subject, sdd=800.0, height=32, delx=2.0)
    rot = jnp.array([[0.013, np.pi / 2 + 0.017, -0.011]], jnp.float32)
    trans = jnp.array([[3.0, 401.0, -2.0]], jnp.float32)
    pose = jconvert(rot, trans, parameterization="euler_angles", convention="ZXY")
    source, target = drr.detector(pose, None)
    weights = jnp.linalg.norm(target - source, axis=-1)[:, None, :]
    sv, tv = drr.affine_inverse(source), drr.affine_inverse(target)
    axis = 2  # the major ray axis at this pose
    pallas = partial(siddon_pallas_raycast, image_shape=(32, 32), axis=axis, tile=16,
                     ky=64, zw=256, interpret=True, storage=None)
    args = (drr.density, sv, tv, weights)
    ref = {
        "grad_pallas": jax.grad(partial(_sin_loss_jax, pallas), argnums=(0, 1, 2, 3))(*args),
        "grad_pallas_two_pass": jax.grad(
            partial(_sin_loss_jax, partial(pallas, fused_pose_bwd=False)),
            argnums=(0, 1, 2, 3))(*args),
        "grad_oracle": jax.grad(partial(_sin_loss_jax, jax_oracle), argnums=(0,))(*args),
    }
    return dict(args=tuple(np.asarray(x) for x in args), axis=axis, ref=ref)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
@pytest.mark.parametrize("ref_name", ["grad_pallas", "grad_oracle"])
def test_density_gradient_matches_jax(scene, fused, ref_name):
    """d/d(density) by siddon_bwd_vol, next to a pose gradient taken by the
    fused forward or by the value-only forward and siddon_bwd_rays."""
    _, grads = _port_grads(*scene["args"], _sin_loss, axis=scene["axis"], fused=fused)
    _close(grads[0], scene["ref"][ref_name][0], 1e-3)


def test_two_pass_pose_backward_equals_fused(scene):
    va, ga = _port_grads(*scene["args"], _sin_loss, axis=scene["axis"], fused=True)
    vb, gb = _port_grads(*scene["args"], _sin_loss, axis=scene["axis"], fused=False)
    np.testing.assert_allclose(float(_sin_loss(va)), float(_sin_loss(vb)), rtol=1e-5)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(a, b, atol=1e-6 * b.abs().max().item() + 1e-12)


def test_two_pass_pose_backward_matches_jax_two_pass_kernel(scene):
    """The port's siddon_bwd_rays against _bwd_rays_kernel (fused_pose_bwd=False)."""
    _, grads = _port_grads(*scene["args"], _sin_loss, axis=scene["axis"], fused=False)
    for got, ref in zip(grads[1:], scene["ref"]["grad_pallas_two_pass"][1:]):
        _close(got, ref, 1e-3)


@pytest.mark.parametrize("case, want", [
    ("pose", {"siddon_fwdgrad"}),
    ("pose_two_pass", {"siddon_fwd", "siddon_bwd_rays"}),
    ("density", {"siddon_fwd", "siddon_bwd_vol"}),
    ("both", {"siddon_fwdgrad", "siddon_bwd_vol"}),
    ("mip", {"siddon_fwd_max", "siddon_bwd_rays", "siddon_bwd_vol"}),
])
def test_autograd_calls_only_the_kernels_it_needs(monkeypatch, case, want):
    """A pose-only backward runs no density gradient, a density-only one no
    fused forward (the wrappers are counted by name; on the CPU they run
    their plain versions)."""
    called = set()
    for fn in K.KERNELS:
        def counted(*a, _fn=fn, **k):
            called.add(_fn.__name__)
            return _fn(*a, **k)
        monkeypatch.setattr(K, fn.__name__, counted)
    vol = torch.rand((6, 5, 4), generator=torch.Generator().manual_seed(0))
    src = torch.tensor([[[-9.0, 2.2, 1.7]]])
    tgt = torch.tensor([[[9.0, 2.9, 2.1], [9.0, 1.4, 2.6]]])
    w = torch.ones((1, 1, 2))
    dens_grad = case in ("density", "both", "mip")
    pose_grad = case != "density"
    density = vol.clone().requires_grad_(dens_grad)
    tgt = tgt.clone().requires_grad_(pose_grad)
    out = K.siddon_slab_raycast(density, src, tgt, w, axis=0,
                                reduce="max" if case == "mip" else "sum",
                                fused=case != "pose_two_pass")
    torch.sum(out ** 2).backward()
    assert called == want
    assert (density.grad is not None) == dens_grad
    assert (tgt.grad is not None) == pose_grad


# -----------------------------------------------------------------------------
# The DRR: MIP render, options, and the reconstruction step
# -----------------------------------------------------------------------------


def test_drr_mip_and_fused_option_match_jax():
    """DRR(reducefn="max") on the slab path and on the escape to the sort
    oracle (axis 0 pinned violates the slab bound at this pose) against the
    JAX DRR, which renders with that oracle on the CPU; ``fused_pose_bwd``
    is an accepted option with no effect on values.

    Tolerance 1e-4 * max, not the 1e-5 of the unit-weight scene above: a
    MIP pixel is one segment's len * w * V, so it carries the whole float32
    rounding of one segment length (about 6e-8 on lengths of about 3e-3 in
    alpha units here), which a sum spreads over the ray."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, delx=2.0)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    rot = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
    trans = np.array([[3.0, 401.0, -2.0]], np.float32)
    ref = np.asarray(jd(jnp.asarray(rot), jnp.asarray(trans), reducefn="max", **KW))
    r, t = torch.tensor(rot), torch.tensor(trans)
    _close(td(r, t, reducefn="max", **KW), ref, 1e-4)
    assert td.siddon_escapes == 0
    _close(td(r, t, reducefn="max", axis=0, **KW), ref, 1e-4)
    assert td.siddon_escapes == 1
    torch.testing.assert_close(td(r, t, fused_pose_bwd=False, **KW), td(r, t, **KW),
                               rtol=0, atol=0)


# The reconstruction CLI's trajectory (experiments/reconstruction.py:62-68),
# on a small CT: 4 views, the detector turning about its central ray.
RECON_THETAS = np.linspace(0, np.pi, 4, endpoint=False)
RECON_ROT = np.stack([RECON_THETAS, np.full(4, np.pi / 2), np.zeros(4)], 1).astype(np.float32)
RECON_TRANS = np.tile(np.array([[0.0, 850.0, 0.0]], np.float32), (4, 1))
RECON_LR = 5e-2
RECON_STEPS = 3


@pytest.fixture(scope="module")
def recon():
    """3 reconstruction steps from zeros in each package, with each step's
    density gradient (the JAX one by jax.grad of its step's loss)."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=1020.0, height=32, delx=3.0)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    rot, trans = jnp.asarray(RECON_ROT), jnp.asarray(RECON_TRANS)
    measured = np.asarray(jd(rot, trans, **KW))
    zeros = np.zeros(jd.density.shape, np.float32)

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    j_init, j_step = jmake_recon(jd, mesh, lr=RECON_LR)
    src, tgt = jd.detector(jconvert(rot, trans, **KW), None)

    def jloss(density):
        img = jd.reshape_transform(jd.render(density, src, tgt), batch_size=len(rot))
        return jnp.mean((img - jnp.asarray(measured)) ** 2)

    jdens, jstate = j_init(jnp.asarray(zeros))
    j = {"loss": [], "grad": [], "density": None}
    for _ in range(RECON_STEPS):
        j["grad"].append(np.asarray(jax.grad(jloss)(jdens)))
        jdens, jstate, loss = j_step(jdens, jstate, rot, trans, jnp.asarray(measured))
        j["loss"].append(float(loss))
    j["density"] = np.asarray(jdens)

    t_init, t_step = make_reconstruction_step(td, lr=RECON_LR)
    tdens, opt = t_init(torch.tensor(zeros))
    t = {"loss": [], "grad": [], "density": None}
    before = td.siddon_escapes
    for _ in range(RECON_STEPS):
        tdens, opt, loss = t_step(tdens, opt, torch.tensor(RECON_ROT), torch.tensor(RECON_TRANS),
                                  torch.tensor(measured))
        t["grad"].append(tdens.grad.detach().clone())
        t["loss"].append(loss.item())
    t["density"] = tdens.detach()
    t["escapes"] = td.siddon_escapes - before
    t["drr"], t["measured"] = td, measured
    return j, t


def test_reconstruction_losses_match_jax(recon):
    j, t = recon
    assert t["escapes"] == 0  # every step ran the slab kernels' plain versions
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-3)
    assert t["loss"][-1] < t["loss"][0]


def test_reconstruction_first_gradient_matches_jax(recon):
    j, t = recon
    _close(t["grad"][0], j["grad"][0], 1e-3)


def test_reconstruction_density_matches_jax(recon):
    """The density after 3 Adam steps, to 1e-3 * lr, on the voxels whose
    gradient exceeds 1e-3 * max|g| at every step. Adam divides each step by
    the gradient's running RMS, so a voxel whose gradient is float noise
    (rays grazing its edge, where the two packages round a near-zero
    length differently) takes a full step of either sign; such voxels are
    left out."""
    j, t = recon
    mask = np.ones(j["density"].shape, bool)
    for g in j["grad"]:
        mask &= np.abs(g) > 1e-3 * np.abs(g).max()
    assert mask.sum() > 1000
    moved = np.abs(j["density"][mask]).max()
    assert moved > RECON_LR  # more than one step's worth
    np.testing.assert_allclose(t["density"].numpy()[mask], j["density"][mask],
                               atol=1e-3 * RECON_LR, rtol=0)


def test_reconstruction_mesh_is_not_ported(recon):
    """The mesh step on a mesh of one rank (``make_mesh`` wires that world in
    a plain process) is the one-device step, bit for bit, and so matches the
    JAX package's step on its one-device mesh. Several ranks:
    ``tests/test_torch_parallel.py``."""
    j, t = recon
    assert not dist.is_initialized()
    try:
        init_fn, step_fn = make_reconstruction_step(t["drr"], tmake_mesh((1, 1), devices="cpu"),
                                                    lr=RECON_LR)
        dens, opt = init_fn(torch.zeros(t["drr"].density.shape))
        losses = []
        for _ in range(RECON_STEPS):
            dens, opt, loss = step_fn(dens, opt, torch.tensor(RECON_ROT),
                                      torch.tensor(RECON_TRANS), torch.tensor(t["measured"]))
            losses.append(loss.item())
    finally:
        dist.destroy_process_group()
    assert losses == t["loss"]
    torch.testing.assert_close(dens.detach(), t["density"], rtol=0, atol=0)
    np.testing.assert_allclose(losses, j["loss"], rtol=1e-3)
