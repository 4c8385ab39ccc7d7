"""The port's Siddon path against the JAX package, on the CPU.

The same seeded NumPy inputs go through
``diffdrr_tpu.ops.pallas.siddon.siddon_pallas_raycast`` (in interpret mode,
f32 storage, as ``tests/test_pallas_siddon.py`` runs it), through the JAX
sort-based oracle ``diffdrr_tpu.ops.siddon.siddon_raycast``, and through the
port: ``prep_rays`` + the plain versions of ``siddon_fwd``/``siddon_fwdgrad``
(the wrappers' CPU path) + ``SiddonSlab``, and the port's own sort oracle.

Tolerances (from the issue that set up this slice, and why they hold):
  * forward vs the Pallas kernel: atol 1e-4 * max|ref|. Same slab
    decomposition and float32 arithmetic; only the summation order of the
    corner contraction differs.
  * forward vs the sort oracle: atol 1e-3 * max|ref|. A different
    algorithm (sorted crossings, midpoint lookup) for the same integral.
  * gradients w.r.t. source, target, weights: atol 1e-3 * max|g_ref|, at an
    off-grid pose (gradients at grid-aligned poses depend on subgradient
    choices at kinks).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.pallas.siddon import siddon_pallas_raycast
from diffdrr_tpu.ops.siddon import siddon_raycast as jax_oracle

from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
from diffdrr_tpu_torch.ops.siddon import siddon_raycast as torch_oracle

H = W = 32


def _loss_jax(fn, vol, s, t, w):
    return jnp.sum(jnp.sin(fn(vol, s, t, w) * 0.1))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


@pytest.fixture(scope="module")
def scene():
    """64x64x32 phantom, 32x32 detector, an off-grid pose; JAX references."""
    subject = jload(shape=(64, 64, 32))
    drr = JDRR(subject, sdd=800.0, height=H, delx=2.0)
    rot = jnp.array([[0.013, np.pi / 2 + 0.017, -0.011]], jnp.float32)
    trans = jnp.array([[3.0, 401.0, -2.0]], jnp.float32)
    pose = jconvert(rot, trans, parameterization="euler_angles", convention="ZXY")
    source, target = drr.detector(pose, None)
    weights = jnp.linalg.norm(target - source, axis=-1)[:, None, :]
    sv, tv = drr.affine_inverse(source), drr.affine_inverse(target)
    axis = 2  # the major ray axis at this pose
    pallas = partial(siddon_pallas_raycast, image_shape=(H, W), axis=axis, tile=16,
                     ky=64, zw=256, interpret=True, storage=None)
    args = (drr.density, sv, tv, weights)
    ref = {
        "pallas": np.asarray(pallas(*args)),
        "oracle": np.asarray(jax_oracle(*args)),
        "grad_pallas": [np.asarray(g) for g in jax.grad(
            partial(_loss_jax, pallas), argnums=(1, 2, 3))(*args)],
        "grad_oracle": [np.asarray(g) for g in jax.grad(
            partial(_loss_jax, jax_oracle), argnums=(1, 2, 3))(*args)],
    }
    return dict(density=np.asarray(drr.density), sv=np.asarray(sv), tv=np.asarray(tv),
                w=np.asarray(weights), axis=axis, ref=ref)


def _port_grads(scene):
    S, T, Wt = _t(scene["sv"], True), _t(scene["tv"], True), _t(scene["w"], True)
    out = K.siddon_slab_raycast(_t(scene["density"]), S, T, Wt, axis=scene["axis"])
    torch.sum(torch.sin(out * 0.1)).backward()
    return out.detach(), [S.grad, T.grad, Wt.grad]


def test_forward_matches_pallas_kernel(scene):
    rows = prep_rays(_t(scene["sv"]), _t(scene["tv"]), _t(scene["w"]),
                     scene["axis"], scene["density"].shape)
    got = K.siddon_fwd(rows, _t(scene["density"]), scene["axis"])
    _close(got.reshape(1, 1, -1), scene["ref"]["pallas"], 1e-4)


def test_forward_matches_sort_oracle(scene):
    rows = prep_rays(_t(scene["sv"]), _t(scene["tv"]), _t(scene["w"]),
                     scene["axis"], scene["density"].shape)
    got = K.siddon_fwd(rows, _t(scene["density"]), scene["axis"])
    _close(got.reshape(1, 1, -1), scene["ref"]["oracle"], 1e-3)


def test_streaming_plane_major_kernel_function():
    """The TPU's plane-major streaming kernel (#2) computes the same sum as
    #1; the port serves both with siddon_fwd. Held at a volume the TPU would
    stream (resident=False), a 32x32x24 random density, off-grid rays."""
    rng = np.random.default_rng(7)
    vol = rng.uniform(0.1, 1.0, (32, 32, 24)).astype(np.float32)
    u, v = np.meshgrid(np.linspace(-3.3, 35.1, 16), np.linspace(-2.7, 27.9, 16), indexing="ij")
    tv = np.stack([u, v, np.full_like(u, 60.37)], -1).reshape(1, 256, 3).astype(np.float32)
    sv = np.array([[[15.3, 16.1, -40.2]]], np.float32)
    w = np.linalg.norm(tv - sv, axis=-1)[:, None, :].astype(np.float32)
    ref = np.asarray(siddon_pallas_raycast(
        jnp.asarray(vol), jnp.asarray(sv), jnp.asarray(tv), jnp.asarray(w),
        image_shape=(16, 16), axis=2, tile=16, ky=64, zw=256, interpret=True,
        storage=None, resident=False))
    rows = prep_rays(_t(sv), _t(tv), _t(w), 2, vol.shape)
    _close(K.siddon_fwd(rows, _t(vol), 2).reshape(ref.shape), ref, 1e-4)


@pytest.mark.parametrize("ref_name", ["grad_pallas", "grad_oracle"])
def test_pose_gradients_match_jax(scene, ref_name):
    """d/d(source, target, weights) through prep_rays + SiddonSlab."""
    _, grads = _port_grads(scene)
    for got, ref in zip(grads, scene["ref"][ref_name]):
        _close(got, ref, 1e-3)


def test_fused_value_equals_forward(scene):
    rows = prep_rays(_t(scene["sv"]), _t(scene["tv"]), _t(scene["w"]),
                     scene["axis"], scene["density"].shape)
    vol = _t(scene["density"])
    fused = K.siddon_fwdgrad(rows, vol, scene["axis"])
    assert fused.shape == (10, rows.shape[1])
    torch.testing.assert_close(fused[9], K.siddon_fwd(rows, vol, scene["axis"]),
                               rtol=0, atol=0)


def test_fused_rows_pull_back_to_jax_gradients(scene):
    """rows * g, pulled back through prep_rays by autograd, is the JAX
    kernel's pose gradient (compared after the JAX side's untiling)."""
    S, T, Wt = _t(scene["sv"], True), _t(scene["tv"], True), _t(scene["w"], True)
    rows = prep_rays(S, T, Wt, scene["axis"], scene["density"].shape)
    fused = K.siddon_fwdgrad_plain(rows.detach(), _t(scene["density"]), scene["axis"])
    g = 0.1 * torch.cos(0.1 * fused[9])  # d sum(sin(0.1 v)) / dv
    grads = torch.autograd.grad(rows, (S, T, Wt), grad_outputs=fused[:9] * g)
    for got, ref in zip(grads, scene["ref"]["grad_pallas"]):
        _close(got, ref, 1e-3)


def test_torch_oracle_matches_jax_oracle(scene):
    S, T, Wt = _t(scene["sv"], True), _t(scene["tv"], True), _t(scene["w"], True)
    out = torch_oracle(_t(scene["density"]), S, T, Wt)
    _close(out.detach(), scene["ref"]["oracle"], 1e-4)
    torch.sum(torch.sin(out * 0.1)).backward()
    for got, ref in zip((S.grad, T.grad, Wt.grad), scene["ref"]["grad_oracle"]):
        _close(got, ref, 1e-3)


def test_partial_entry_slab_not_dropped():
    """Rays entering mid-slab through a transverse face keep the partial
    segment (exact match required on an all-ones volume)."""
    vol = np.ones((32, 32, 32), np.float32)
    n = 16 * 16
    x_e = 10.3
    y_s = -0.5 - 0.8 * (x_e + 50)
    jit = np.linspace(0, 0.02, n)
    sv = np.stack([np.full(n, -50.0), np.full(n, y_s), np.full(n, 16.0)], 1)[None]
    tv = np.stack([np.full(n, 50.0), np.full(n, y_s + 80.0), 16.0 + jit], 1)[None]
    sv, tv = sv.astype(np.float32), tv.astype(np.float32)
    w = np.ones((1, 1, n), np.float32)
    ref = np.asarray(jax_oracle(jnp.asarray(vol), jnp.asarray(sv), jnp.asarray(tv),
                                jnp.asarray(w)))
    got = K.siddon_slab_raycast(_t(vol), _t(sv), _t(tv), _t(w), axis=0)
    _close(got, ref, 1e-6)


def test_boundary_gradient_parity_dense_volume():
    """Non-air volume boundaries: the integral's boundary terms
    (-V(entry) d(amin) + V(exit) d(amax)) must reach the pose gradient."""
    rng = np.random.default_rng(1)
    vol = (1.0 + 0.5 * rng.random((32, 32, 32))).astype(np.float32)
    n = 16
    ys, zs = np.meshgrid(np.linspace(-4.0, 36.0, n), np.linspace(-4.0, 36.0, n), indexing="ij")
    tv = np.stack([np.full(ys.size, 70.0), ys.ravel(), zs.ravel()], 1)[None].astype(np.float32)
    sv = np.array([[[-70.0, 10.0, 12.0]]], np.float32)
    w = np.ones((1, 1, n * n), np.float32)

    def loss_ref(s, t, w_):
        return jnp.sum(jax_oracle(jnp.asarray(vol), s, t, w_) ** 2)

    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(jnp.asarray(sv), jnp.asarray(tv), jnp.asarray(w))
    S, T, Wt = _t(sv, True), _t(tv, True), _t(w, True)
    torch.sum(K.siddon_slab_raycast(_t(vol), S, T, Wt, axis=0) ** 2).backward()
    for got, ref in zip((S.grad, T.grad, Wt.grad), gr):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, atol=2e-5 * max(np.abs(ref).max(), 1.0))


def test_detector_inside_volume_full_line_semantics():
    """Siddon integrates the full line's crossing of the volume, not only
    [source, target]: detector planes inside a tall volume must not
    truncate the rays."""
    rng = np.random.default_rng(3)
    vol = rng.uniform(0.2, 1.0, (24, 24, 48)).astype(np.float32)
    u, v = np.meshgrid(np.linspace(1.3, 22.1, 16), np.linspace(0.7, 23.2, 16), indexing="ij")
    tv = np.stack([u, v, np.full_like(u, 30.17)], -1).reshape(1, 256, 3).astype(np.float32)
    sv = np.array([[[11.7, 12.2, -60.4]]], np.float32)
    w = np.linalg.norm(tv - sv, axis=-1)[:, None, :].astype(np.float32)
    ref = np.asarray(jax_oracle(jnp.asarray(vol), jnp.asarray(sv), jnp.asarray(tv),
                                jnp.asarray(w)))
    got = K.siddon_slab_raycast(_t(vol), _t(sv), _t(tv), _t(w), axis=2)
    _close(got, ref, 2e-4)
    # Rays end at alpha = 1 (z = 30.17) but the volume reaches z = 47.5.
    clipped = K.siddon_slab_raycast(_t(vol)[:, :, :31], _t(sv), _t(tv), _t(w), axis=2)
    assert (got - clipped).min() > 0


def test_wrappers_dispatch_by_device():
    """CPU tensors run the plain versions (no launch counted); the density
    gets its gradient; a device that is neither CPU nor CUDA raises."""
    vol = torch.ones((4, 4, 4))
    rows = prep_rays(torch.tensor([[[-9.0, 1.2, 1.7]]]), torch.tensor([[[9.0, 1.9, 2.1]]]),
                     torch.ones((1, 1, 1)), 0, vol.shape)
    before = (K.siddon_fwd.launches, K.siddon_fwdgrad.launches)
    K.siddon_fwd(rows, vol, 0)
    K.siddon_fwdgrad(rows, vol, 0)
    assert (K.siddon_fwd.launches, K.siddon_fwdgrad.launches) == before
    leaf = vol.clone().requires_grad_(True)
    K.SiddonSlab.apply(leaf, rows, 0).sum().backward()
    assert leaf.grad is not None and leaf.grad.shape == vol.shape
    # One unit-weight ray through an all-ones volume: the gradient holds its
    # path length in each voxel, and these sum to the value.
    torch.testing.assert_close(leaf.grad.sum(), K.siddon_fwd(rows, vol, 0)[0])
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        K.siddon_fwd(rows.to("meta"), vol.to("meta"), 0)
