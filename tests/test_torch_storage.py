"""bf16 density storage (``storage="bf16"``) in the port, on the CPU.

Against the JAX package: ``siddon_pallas_raycast`` and
``joseph_pallas_raycast`` in interpret mode with ``storage="bf16"`` (the
64x64x32 phantom, a 32x32 detector, the off-grid pose of
``tests/test_torch_siddon.py``, march axis 2), one value-and-gradient call
each under ``jax.jit``, against the port's raycasts with ``storage="bf16"``
(their plain versions on the CPU). Tolerances are the float32 parity tests': values atol
1e-4 * max|ref| (``tests/test_torch_siddon.py``,
``tests/test_torch_joseph.py``); the source, target and weights gradients
1e-3 * max|g_ref|; the density gradient 1e-3 (Siddon,
``tests/test_torch_siddon_bwd.py``) and 1e-4 (Joseph).

Against the port's own float32 path: every output of a render in bf16
storage (values, MIP argmaxes, pose gradients, density gradients; sum, MIP,
channels, both two-pass pose backwards, a ``p_subsample`` render) equals the
float32 render of the density rounded to bf16, bit for bit: bf16 -> float32
is exact and nothing after the load changes. The oracles (``force_xla``, a
slab-guard escape) read the float32 density, as in the JAX package.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.pallas.joseph import joseph_pallas_raycast
from diffdrr_tpu.ops.pallas.siddon import siddon_pallas_raycast

from diffdrr_tpu_torch import DRR, interop
from diffdrr_tpu_torch.ops.kernels import brick
from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
from diffdrr_tpu_torch.parallel import make_mesh, slab_sharded_joseph, slab_sharded_siddon
from diffdrr_tpu_torch.pose import convert
from diffdrr_tpu_torch.registration import rescaled_drr

H = W = 32
AXIS = 2  # the major ray axis at this pose
ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")
PALLAS = dict(image_shape=(H, W), axis=AXIS, tile=16, ky=64, zw=256, interpret=True,
              storage="bf16")
RENDERERS = ("siddon", "joseph", "trilinear")


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def _equal(got, ref):
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _rounded(x):
    return x.to(torch.bfloat16).to(torch.float32)


@pytest.fixture(scope="module")
def scene():
    """The rays, the density, and the JAX package's bf16-storage value and
    gradients (d/d density, source, target, weights) of sum(sin(0.1 img))."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=H, delx=2.0)
    pose = jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW)
    source, target = jd.detector(pose, None)
    weights = jnp.linalg.norm(target - source, axis=-1)[:, None, :]
    args = (jd.density, jd.affine_inverse(source), jd.affine_inverse(target), weights)

    def value_and_grads(fn):
        def loss(*a):
            img = fn(*a)
            return jnp.sum(jnp.sin(img * 0.1)), img
        # Under jax.jit: eager interpret mode runs the kernel op by op (~5x slower).
        (_, img), grads = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
        return np.asarray(img), [np.asarray(g) for g in grads]

    ref = {"siddon": value_and_grads(partial(siddon_pallas_raycast, **PALLAS)),
           "joseph": value_and_grads(partial(joseph_pallas_raycast, step=1, **PALLAS))}
    return dict(args=[np.asarray(a) for a in args], ref=ref, state=interop.export_state(jd))


def _port_value_and_grads(scene, renderer, storage="bf16"):
    leaves = [_t(a, True) for a in scene["args"]]
    if renderer == "siddon":
        img = K.siddon_slab_raycast(*leaves, axis=AXIS, storage=storage)
    else:
        img = J.joseph_march_raycast(*leaves, axis=AXIS, step=1, storage=storage)
    torch.sum(torch.sin(img * 0.1)).backward()
    return img.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("renderer", ["siddon", "joseph"])
def test_bf16_storage_matches_jax(scene, renderer):
    """The value, the pose gradients and the float32 density gradient of the
    port's bf16-storage raycast against the JAX package's kernels in
    interpret mode with storage="bf16"."""
    img, grads = _port_value_and_grads(scene, renderer)
    ref_img, ref_grads = scene["ref"][renderer]
    assert img.shape == ref_img.shape
    _close(img, ref_img, 1e-4)
    density_rel = 1e-3 if renderer == "siddon" else 1e-4
    for name, g, ref, rel in zip(("density", "source", "target", "weights"), grads, ref_grads,
                                 (density_rel, 1e-3, 1e-3, 1e-3)):
        assert np.abs(ref).max() > 0, name
        _close(g, ref, rel)


@pytest.mark.parametrize("renderer", ["siddon", "joseph"])
def test_bf16_storage_moves_the_image(scene, renderer):
    """bf16 storage is another function than float32 storage: the image
    moves by a small fraction of its maximum (the JAX package's too)."""
    img, _ = _port_value_and_grads(scene, renderer)
    f32, _ = _port_value_and_grads(scene, renderer, storage=None)
    diff = (img - f32).abs().max() / f32.abs().max()
    assert 1e-5 < diff < 5e-3


# -----------------------------------------------------------------------------
# The port's bf16 path equals its float32 path on the rounded density
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drrs(scene):
    """For each renderer, a bf16-storage DRR and a float32 one whose density
    is the first's rounded to bf16 (with the labelmap, for channels)."""
    out = {}
    for renderer in RENDERERS:
        bf = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer,
                                    storage="bf16")
        f32 = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer)
        f32.set_density(_rounded(bf.density))
        out[renderer] = (bf, f32)
    return out


def _pose_and_density_grads(drr, weight, **kw):
    """(image, d/d rotation and translation, d/d density) of sum(img * weight),
    the density a leaf with the DRR's values."""
    r, t = torch.tensor(ROT, requires_grad=True), torch.tensor(TRANS, requires_grad=True)
    d = drr.density.detach().clone().requires_grad_(True)
    source, target = drr.detector(convert(r, t, **KW))
    img = drr.render(d, source, target, **kw)
    torch.sum(img * weight.reshape(img.shape[0], -1, img.shape[-1])).backward()
    return img.detach(), torch.cat([r.grad, t.grad], -1), d.grad


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
@pytest.mark.parametrize("renderer", RENDERERS)
def test_bf16_render_equals_f32_on_rounded_density(drrs, renderer, fused):
    """Sum mode: the image, the pose gradient (fused, or by the two-pass
    backward) and the density gradient, bit for bit."""
    bf, f32 = drrs[renderer]
    weight = torch.tensor(np.random.default_rng(1).normal(size=(1, 1, H * W)),
                          dtype=torch.float32)
    got = _pose_and_density_grads(bf, weight, fused_pose_bwd=fused)
    ref = _pose_and_density_grads(f32, weight, fused_pose_bwd=fused)
    for a, b in zip(got, ref):
        _equal(a, b)
    assert torch.count_nonzero(got[1]) == 6 and torch.count_nonzero(got[2]) > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
@pytest.mark.parametrize("renderer", ["siddon", "joseph"])
def test_bf16_mip_equals_f32_on_rounded_density(drrs, renderer, fused):
    """MIP: the image and its pose and density gradients (the two-pass
    backward gated to the argmax), bit for bit."""
    bf, f32 = drrs[renderer]
    weight = torch.tensor(np.random.default_rng(2).normal(size=(1, 1, H * W)),
                          dtype=torch.float32)
    kw = dict(reducefn="max", fused_pose_bwd=fused)
    got = _pose_and_density_grads(bf, weight, **kw)
    ref = _pose_and_density_grads(f32, weight, **kw)
    for a, b in zip(got, ref):
        _equal(a, b)


@pytest.mark.parametrize("renderer", ["siddon", "joseph"])
def test_bf16_mip_argmax_equals_f32_on_rounded_density(scene, renderer):
    """The MIP forwards' values and argmaxes, and the MIP two-pass pose rows,
    at the wrappers, bit for bit."""
    sv, tv, w = (_t(a) for a in scene["args"][1:])
    dens = _t(scene["args"][0])
    g = torch.tensor(np.random.default_rng(3).normal(size=H * W), dtype=torch.float32)
    if renderer == "siddon":
        rows = prep_rays(sv, tv, w, AXIS, dens.shape)
        got = K.siddon_fwd_max(rows, dens, AXIS, "bf16")
        ref = K.siddon_fwd_max(rows, _rounded(dens), AXIS)
        rays = (K.siddon_bwd_rays(rows, dens, AXIS, g, got[1], "bf16"),
                K.siddon_bwd_rays(rows, _rounded(dens), AXIS, g, ref[1]))
    else:
        X = dens.shape[AXIS]
        rows = prep_rays(sv, tv, w, AXIS, dens.shape, quadrature="joseph", h=1.0)
        got = J.joseph_fwd_max(rows, dens, AXIS, 1.0, X, "bf16")
        ref = J.joseph_fwd_max(rows, _rounded(dens), AXIS, 1.0, X)
        rays = (J.joseph_bwd_rays(rows, dens, AXIS, 1.0, X, g, got[1], "bf16"),
                J.joseph_bwd_rays(rows, _rounded(dens), AXIS, 1.0, X, g, ref[1]))
    _equal(got[0], ref[0])
    _equal(got[1], ref[1])
    assert int((got[1] >= 0).sum()) > 0
    _equal(*rays)


@pytest.mark.parametrize("renderer", ["joseph", "trilinear"])
def test_bf16_channels_equal_f32_on_rounded_density(drrs, renderer):
    """Per-structure channels on the Joseph kernels' channel mode: the
    (1, C, H, W) image and its pose gradient (joseph_bwd_rays_ch), bit for
    bit; the labels keep their int32 bits."""
    bf, f32 = drrs[renderer]
    assert bf.n_channels > 1

    def run(drr):
        r, t = torch.tensor(ROT, requires_grad=True), torch.tensor(TRANS, requires_grad=True)
        img = drr(r, t, mask_to_channels=True, **KW)
        torch.sum(img ** 2).backward()
        return img.detach(), torch.cat([r.grad, t.grad], -1)

    got, ref = run(bf), run(f32)
    assert got[0].shape == (1, bf.n_channels, H, W)
    for a, b in zip(got, ref):
        _equal(a, b)


@pytest.mark.parametrize("renderer", RENDERERS)
def test_bf16_subsampled_render_equals_f32_on_rounded_density(scene, renderer):
    """A p_subsample render (the sampled rays on the kernels), bit for bit."""
    bf = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer,
                                p_subsample=0.25, storage="bf16")
    f32 = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer,
                                 p_subsample=0.25)
    f32.set_density(_rounded(bf.density))
    got = bf(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    _equal(got, f32(torch.tensor(ROT), torch.tensor(TRANS), **KW))
    assert torch.count_nonzero(got) > 0


# -----------------------------------------------------------------------------
# What stays float32, and the options
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("renderer", RENDERERS)
def test_force_xla_reads_the_float32_density(scene, renderer):
    """The oracle (force_xla) of a bf16-storage DRR renders the float32
    density: the float32 DRR's oracle image, bit for bit."""
    bf = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer,
                                storage="bf16")
    f32 = interop.drr_from_state(scene["state"], device="cpu", renderer=renderer)
    pose = (torch.tensor(ROT), torch.tensor(TRANS))
    _equal(bf(*pose, force_xla=True, **KW), f32(*pose, force_xla=True, **KW))


def test_slab_guard_escape_reads_the_float32_density(scene):
    """A pose whose worst ray breaks the slab bound escapes to the sort
    oracle, which reads the float32 density."""
    bf = interop.drr_from_state(scene["state"], device="cpu", storage="bf16")
    f32 = interop.drr_from_state(scene["state"], device="cpu")
    rot = torch.tensor([[0.75, 3 * np.pi / 8, -0.75]])
    trans = torch.tensor([[5.0, 150.0, -3.0]])
    got = bf(rot, trans, **KW)
    assert bf.siddon_escapes == 1
    _equal(got, f32(rot, trans, **KW))


def test_storage_and_precision_options(scene):
    """storage: None or "bf16"; precision: "f32" or "highest" (one function
    here), the default storage float32 whatever the precision;
    precision="bf16" and any other value raise, and so does a bad storage,
    in the DRR and in the wrappers."""
    state = scene["state"]
    d = interop.drr_from_state(state, device="cpu")
    assert d.pallas_precision == "f32" and d.pallas_storage is None
    hi = interop.drr_from_state(state, device="cpu", precision="highest")
    assert hi.pallas_precision == "highest" and hi.pallas_storage is None
    _equal(hi(torch.tensor(ROT), torch.tensor(TRANS), **KW),
           d(torch.tensor(ROT), torch.tensor(TRANS), **KW))
    bf = interop.drr_from_state(state, device="cpu", storage="bf16", precision="highest")
    assert bf.pallas_storage == "bf16" and "storage" not in bf.renderer_kwargs
    with pytest.raises(ValueError, match="storage='bf16'"):
        interop.drr_from_state(state, device="cpu", precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        interop.drr_from_state(state, device="cpu", precision="default")
    with pytest.raises(ValueError, match="storage"):
        interop.drr_from_state(state, device="cpu", storage="fp16")
    rows = prep_rays(*(_t(a) for a in scene["args"][1:]), AXIS, scene["args"][0].shape)
    with pytest.raises(ValueError, match="storage"):
        K.siddon_fwd(rows, _t(scene["args"][0]), AXIS, storage="bfloat16")
    with pytest.raises(ValueError, match="storage"):
        brick.brick_density(_t(scene["args"][0]), storage="f16")
    with pytest.raises(TypeError, match="unexpected renderer option"):
        d(torch.tensor(ROT), torch.tensor(TRANS), storage="bf16", **KW)


def test_rescaled_drr_keeps_storage_and_shares_one_copy():
    """rescaled_drr keeps precision and storage and the other constructor
    options (the port of tests/test_registration.py's
    test_rescaled_drr_preserves_fov_and_options), and the twin reads the
    source DRR's density, so both find one bf16 bricked copy."""
    from diffdrr_tpu_torch import load_example_ct

    subject = load_example_ct(shape=(32, 32, 16), device="cpu")
    drr = DRR(subject, sdd=700.0, height=32, width=64, delx=2.0, dely=3.0,
              renderer="trilinear", storage="bf16", checkpoint_gradients=True, device="cpu")
    c = rescaled_drr(drr, 0.3)
    np.testing.assert_allclose(c.detector.width * c.detector.delx, 64 * 2.0, rtol=1e-6)
    np.testing.assert_allclose(c.detector.height * c.detector.dely, 32 * 3.0, rtol=1e-6)
    assert c.pallas_storage == "bf16" and c.pallas_precision == "f32"
    assert c.checkpoint_gradients is True
    assert c.density is drr.density
    brick.clear_cache()
    try:
        copy = brick.bricked(drr.density, "bf16")
        assert copy.data.dtype == torch.bfloat16
        assert brick.bricked(c.density, "bf16") is copy
        # A float32 copy of the same density is another entry: neither
        # stands in for the other.
        f32 = brick.bricked(drr.density)
        assert f32.data.dtype == torch.float32 and brick.bricked(c.density, "bf16") is copy
    finally:
        brick.clear_cache()


def test_brick_copy_bf16_plain_version():
    """The plain bf16 copy is the float32 copy's layout of the rounded density."""
    rng = np.random.default_rng(4)
    d = torch.tensor(rng.uniform(0.0, 2.0, (9, 6, 7)), dtype=torch.float32)
    bf = brick.brick_density(d, "bf16")
    assert bf.storage == "bf16" and bf.entry("siddon_fwd") == "siddon_fwd_bf16"
    _equal(bf.data.float(), brick.brick_density(_rounded(d)).data)
    assert brick.brick_density(d).storage is None


@pytest.fixture
def world_of_one():
    """A plain process: make_mesh wires a world of one itself; torn down after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_slab_sharded_render_honours_storage(world_of_one, scene):
    """A slab-sharded render on the kernels in a world of one, with
    pallas_kwargs storage="bf16": the bf16 raycast's image bit for bit (and
    so the float32 one of the rounded density)."""
    mesh = make_mesh((1,), ("rays",), devices="cpu")
    vol, sv, tv, w = (_t(a) for a in scene["args"])
    pk = dict(storage="bf16", precision="highest")
    got = slab_sharded_siddon(vol, sv, tv, w, mesh, slab_axis=AXIS, use_pallas=True,
                              image_shape=(H, W), pallas_kwargs=pk)
    _equal(got, K.siddon_slab_raycast(vol, sv, tv, w, axis=AXIS, storage="bf16"))
    _equal(got, K.siddon_slab_raycast(_rounded(vol), sv, tv, w, axis=AXIS))
    got = slab_sharded_joseph(vol, sv, tv, w, mesh, march_axis=AXIS, use_pallas=True,
                              pallas_kwargs=pk)
    _equal(got, J.joseph_march_raycast(_rounded(vol), sv, tv, w, axis=AXIS))
    with pytest.raises(ValueError, match="storage"):
        slab_sharded_joseph(vol, sv, tv, w, mesh, march_axis=AXIS, use_pallas=True,
                            pallas_kwargs=dict(storage="fp8"))
