"""Sparse rendering (``p_subsample``) against the JAX package, on the CPU.

The detector keeps ``int(H * W * p)`` pixels drawn once by
``np.random.default_rng(seed).permutation(H * W)``: the indices must equal
the JAX detector's. On the CPU the JAX DRR renders the sampled rays on its
oracles and scatters them into a zeroed frame; the port renders them on its
kernel path (Siddon: the slab kernels, whose function is the sort oracle's
to 1e-3 * max, as ``tests/test_torch_siddon.py`` holds them) or, for
trilinear with ``force_xla=True``, on the same oracle (1e-5 * max). Channels
go through the same routes (Siddon channels on the oracle). The kernel
path's sparse render must equal its own full render at the sampled pixels,
exactly, since every ray is marched on its own, and be 0 elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, load_example_ct as jload
from diffdrr_tpu.detector import Detector as JDetector

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.detector import Detector
from diffdrr_tpu_torch.pose import convert

ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


@pytest.mark.parametrize("height, width, n, seed", [(16, 16, 64, 0), (20, 13, 100, 3),
                                                     (8, 8, 64, 1)])
def test_detector_subsample_matches_jax(height, width, n, seed):
    reorient = np.eye(4, dtype=np.float32)
    jd = JDetector(800.0, height, width, 2.0, 2.5, 1.0, -1.5, jnp.asarray(reorient),
                   n_subsample=n, reverse_x_axis=True, seed=seed)
    td = Detector(800.0, height, width, 2.0, 2.5, 1.0, -1.5, reorient, n, True, seed=seed,
                  device="cpu")
    assert td.subsamples[-1] == jd.subsamples[-1] and len(td.subsamples[-1]) == n
    assert td.n_rays == jd.n_rays == n
    np.testing.assert_array_equal(td.target.numpy(), np.asarray(jd.target))
    np.testing.assert_array_equal(td.target_full.numpy(), np.asarray(jd.target_full))
    pose = convert(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    full = td.full_plane_target(pose)
    assert full.shape == (1, height * width, 3)
    torch.testing.assert_close(full[:, td.subsample_index], td(pose)[1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def scene():
    subject = jload(shape=(48, 48, 24))
    jd = JDRR(subject, sdd=800.0, height=16, delx=4.0)
    return subject, interop.export_state(jd)


@pytest.mark.parametrize("renderer, opts, channels, rel", [
    ("siddon", {}, False, 1e-3), ("siddon", {}, True, 1e-5),
    ("trilinear", dict(force_xla=True, n_points=64), False, 1e-5),
    ("trilinear", dict(force_xla=True, n_points=64), True, 1e-5),
], ids=["siddon", "siddon_channels", "trilinear_xla", "trilinear_xla_channels"])
def test_subsampled_drr_matches_jax_drr(scene, renderer, opts, channels, rel):
    """Mirrors tests/test_drr.py::test_subsample_with_mask_channels: the
    sampled pixels agree, the others are 0, every channel is kept."""
    subject, state = scene
    jr = JDRR(subject, sdd=800.0, height=16, delx=4.0, renderer=renderer, p_subsample=0.5)
    jopts = {k: v for k, v in opts.items() if k != "force_xla"}
    ref = np.asarray(jr(jnp.asarray(ROT), jnp.asarray(TRANS), mask_to_channels=channels,
                        **jopts, **KW))
    td = interop.drr_from_state(state, device="cpu", renderer=renderer, p_subsample=0.5)
    got = td(torch.tensor(ROT), torch.tensor(TRANS), mask_to_channels=channels, **opts, **KW)
    C = 7 if channels else 1
    assert got.shape == ref.shape == (1, C, 16, 16)
    _close(got, ref, rel)
    sampled = np.zeros(256, bool)
    sampled[td.detector.subsamples[-1]] = True
    assert np.all(got.reshape(1, C, 256).numpy()[..., ~sampled] == 0)


@pytest.mark.parametrize("renderer", ["joseph", "trilinear"])
@pytest.mark.parametrize("channels", [False, True])
def test_kernel_path_sparse_render_is_the_full_render_gathered(scene, renderer, channels):
    """Only the sampled rays are rendered, on the kernels, with the axis of
    the full frame: the full render at those pixels, exactly, 0 elsewhere;
    and one pose backward equals the full render's, restricted to them."""
    _, state = scene
    sparse = interop.drr_from_state(state, device="cpu", renderer=renderer, p_subsample=0.25)
    full = interop.drr_from_state(state, device="cpu", renderer=renderer)
    idx = sparse.detector.subsample_index
    kw = dict(mask_to_channels=channels, **KW)
    if renderer == "trilinear":
        kw["n_points"] = 24

    rot_s = torch.tensor(ROT, requires_grad=True)
    img_s = sparse(rot_s, torch.tensor(TRANS), **kw)
    rot_f = torch.tensor(ROT, requires_grad=True)
    img_f = full(rot_f, torch.tensor(TRANS), **kw)
    C = 7 if channels else 1
    assert img_s.shape == img_f.shape == (1, C, 16, 16)
    s, f = img_s.reshape(1, C, 256), img_f.reshape(1, C, 256)
    torch.testing.assert_close(s[..., idx], f[..., idx], rtol=0, atol=0)
    keep = torch.zeros(256, dtype=torch.bool)
    keep[idx] = True
    assert torch.count_nonzero(s[..., ~keep]) == 0 and torch.count_nonzero(s[..., idx]) > 0
    (s ** 2).sum().backward()
    ((f * keep) ** 2).sum().backward()
    # The rays' gradients are summed into the pose in another order (and with
    # the unsampled rays' zeros in the full render): 1e-4 relative.
    torch.testing.assert_close(rot_s.grad, rot_f.grad, rtol=1e-4, atol=0)
    assert rot_s.grad.abs().max() > 0


def test_sparse_render_takes_the_full_frame_axis(scene, monkeypatch):
    """The march axis is judged on the full frame's corner rays, not on the
    sampled ones; without reshape the sampled rays come back as they are."""
    _, state = scene
    sparse = interop.drr_from_state(state, device="cpu", renderer="joseph", p_subsample=0.1,
                                    reshape=False)
    seen = []
    orig = type(sparse).worst_ratios

    def spy(self, source, target):
        seen.append(target.shape[1])
        return orig(self, source, target)

    monkeypatch.setattr(type(sparse), "worst_ratios", spy)
    img = sparse(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    assert seen == [256] and img.shape == (1, 1, 25)
    assert sparse.detector.n_subsample == 25 == len(sparse.detector.subsamples[-1])
