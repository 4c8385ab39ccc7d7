"""Joseph and trilinear through the port's DRR, registration, reconstruction
and reconstruction CLI, against the JAX package on the CPU.

``interop`` builds the port's DRR from the JAX DRR's own arrays. On the CPU
the JAX DRR renders joseph and trilinear with its oracles, while the port's
kernel path runs the plain versions of its Joseph kernels, which compute the
TPU kernels' function (plane-aligned samples). So the kernel path is held
against the JAX kernel functions in interpret mode on the same detector
rays, and the JAX DRR only through ``force_xla=True``, where both packages
run their oracles.

Tolerances: renders 1e-4 * max (kernel path) and 1e-5 * max (oracles);
5-step registration scores to 1e-4 relative and parameters within 1% of the
distance each group moved (as ``tests/test_torch_drr_registration.py``);
reconstruction losses to 1e-3 relative and gradients to 1e-3 * max (as
``tests/test_torch_siddon_bwd.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.joseph import joseph_raycast as jjoseph
from diffdrr_tpu.ops.pallas.joseph import joseph_pallas_raycast
from diffdrr_tpu.ops.pallas.raymarch import raymarch_pallas_raycast
from diffdrr_tpu.registration import make_registration_step as jmake_step

from diffdrr_tpu_torch import checkpoint, interop
from diffdrr_tpu_torch.experiments import reconstruction as cli
from diffdrr_tpu_torch.ops.kernels import joseph as J
from diffdrr_tpu_torch.parallel import make_reconstruction_step
from diffdrr_tpu_torch.pose import convert
from diffdrr_tpu_torch.registration import optimize

ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)
ROT0 = ROT + np.array([[0.021, -0.017, 0.012]], np.float32)
TRANS0 = TRANS + np.array([[4.1, -3.3, 2.7]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")
PALLAS = dict(image_shape=(32, 32), tile=16, ky=64, zw=256, interpret=True)


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


@pytest.fixture(scope="module")
def jscene():
    """The JAX DRR (64x64x32 phantom, 32x32 detector) and its voxel-space rays."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, delx=2.0)
    source, target = jd.detector(jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW), None)
    weights = jnp.linalg.norm(target - source, axis=-1)[:, None, :]
    rays = (jd.density, jd.affine_inverse(source), jd.affine_inverse(target), weights)
    return jd, interop.export_state(jd), rays


def _port(state, renderer, **kw):
    return interop.drr_from_state(state, device="cpu", renderer=renderer, **kw)


def test_joseph_steps_and_march_axis_match_jax(jscene):
    jd, state, _ = jscene
    for renderer in ("joseph", "trilinear"):
        td = _port(state, renderer)
        jr = JDRR(jd.subject, sdd=800.0, height=32, delx=2.0, renderer=renderer)
        assert td.joseph_steps == jr.joseph_steps == (4, 4, 1)
        assert td.march_axis == jr.march_axis


@pytest.mark.parametrize("renderer", ["trilinear", "joseph"])
def test_kernel_path_matches_jax_kernels(jscene, renderer):
    """The full frame renders through the Joseph kernels (plain versions on
    the CPU): auto axis 2, one sample per plane (trilinear's n_points=500 is
    capped at 32 planes, joseph_steps[2] = 1)."""
    _, state, rays = jscene
    td = _port(state, renderer)
    J.reset_launch_counts()
    got = td(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    fn = raymarch_pallas_raycast if renderer == "trilinear" else joseph_pallas_raycast
    ref = np.asarray(fn(*rays, axis=2, **PALLAS)).reshape(got.shape)
    _close(got, ref, 1e-4)
    assert sum(k.launches for k in J.KERNELS) == 0  # the CPU ran the plain versions


def test_joseph_pinned_axis_marches_its_stride(jscene):
    """axis=0 pinned marches every joseph_steps[0] = 4 planes (h = 4), the
    JAX oracle's function at the same axis and step."""
    _, state, rays = jscene
    td = _port(state, "joseph")
    got = td(torch.tensor(ROT), torch.tensor(TRANS), axis=0, **KW)
    ref = np.asarray(jjoseph(*rays, axis=0, step=4)).reshape(got.shape)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("renderer, opts", [
    ("trilinear", {}), ("trilinear", dict(n_points=100)), ("joseph", {}),
    ("joseph", dict(axis=0)), ("joseph", dict(reducefn="max")),
], ids=["trilinear", "trilinear_n100", "joseph", "joseph_axis0", "joseph_max"])
def test_force_xla_matches_jax_drr(jscene, renderer, opts):
    """force_xla=True renders on the oracles, as the JAX DRR does on the CPU."""
    jd, state, _ = jscene
    jr = JDRR(jd.subject, sdd=800.0, height=32, delx=2.0, renderer=renderer)
    ref = np.asarray(jr(jnp.asarray(ROT), jnp.asarray(TRANS), **opts, **KW))
    got = _port(state, renderer)(torch.tensor(ROT), torch.tensor(TRANS), force_xla=True,
                                 **opts, **KW)
    _close(got, ref, 1e-5)


def test_trilinear_mip_and_options_take_the_oracle(jscene):
    """What the trilinear kernels do not take renders on the oracle: the
    MIP, nearest sampling; and a ray subset (not the full frame). Against
    the JAX DRR: the MIP to 1e-4 * max (a MIP pixel is one sample, with the
    whole rounding of its weight, as in ``tests/test_torch_siddon_bwd.py``);
    nearest sampling to 1e-5 * max on all but at most 2 pixels in 1024,
    where the last bit of a point moves a sample across a half voxel."""
    jd, state, _ = jscene
    td = _port(state, "trilinear")
    jr = JDRR(jd.subject, sdd=800.0, height=32, delx=2.0, renderer="trilinear")
    r, t = torch.tensor(ROT), torch.tensor(TRANS)
    for opts in (dict(reducefn="max"), dict(mode="nearest")):
        got = td(r, t, **opts, **KW)
        torch.testing.assert_close(got, td(r, t, force_xla=True, **opts, **KW), rtol=0, atol=0)
        ref = np.asarray(jr(jnp.asarray(ROT), jnp.asarray(TRANS), **opts, **KW))
        nearest = opts.get("mode") == "nearest"
        off = np.abs(got.numpy() - ref) > (1e-5 if nearest else 1e-4) * np.abs(ref).max()
        assert off.sum() <= (2 if nearest else 0)
    src, tgt = td.detector(convert(r, t, **KW))
    jsrc, jtgt = jr.detector(jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW), None)
    _close(td.render(td.density, src, tgt[:, :300]),
           jr.render(jr.density, jsrc, jtgt[:, :300]), 1e-5)


def test_n_points_cap_warns(jscene):
    _, state, _ = jscene
    td = _port(state, "trilinear")
    with pytest.warns(UserWarning, match="caps n_points=500"):
        td(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    with pytest.raises(TypeError, match="step"):
        td(torch.tensor(ROT), torch.tensor(TRANS), step=2, **KW)


def test_patch_size_chunks_the_joseph_oracle(jscene):
    """patch_size chunks the oracle; the auto axis comes from the whole ray set."""
    _, state, _ = jscene
    td = _port(state, "joseph", patch_size=8)
    src, tgt = td.detector(convert(torch.tensor(ROT), torch.tensor(TRANS), **KW))
    chunked = td.render(td.density, src, tgt, force_xla=True)
    whole = _port(state, "joseph").render(td.density, src, tgt, force_xla=True)
    _close(chunked, whole, 1e-6)


def test_trilinear_registration_trajectory_matches_jax(jscene):
    """5 Adam steps of trilinear registration on the oracles (force_xla) in
    the port against the JAX package's registration step."""
    jd, state, _ = jscene
    jr = JDRR(jd.subject, sdd=800.0, height=32, delx=2.0, renderer="trilinear")
    target = jr(jnp.asarray(ROT), jnp.asarray(TRANS), n_points=64, **KW)
    opt = dict(optimizer="adam", lr_rotation=1e-2, lr_translation=1.0)
    j_init, j_step = jmake_step(jr, target, "euler_angles", "ZXY", n_points=64, **opt)
    jp_, jstate = j_init(jnp.asarray(ROT0), jnp.asarray(TRANS0))
    j_scores = []
    for _ in range(5):
        jp_, jstate, s = j_step(jp_, jstate)
        j_scores.append(float(s))
    t_rot, t_trans, t_scores = optimize(_port(state, "trilinear"), torch.tensor(np.asarray(target)),
                                        torch.tensor(ROT0), torch.tensor(TRANS0), "euler_angles",
                                        "ZXY", n_iters=5, force_xla=True, n_points=64, **opt)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-4)
    for got, ref, start in ((t_rot, jp_["rotation"], ROT0), (t_trans, jp_["translation"], TRANS0)):
        moved = np.abs(np.asarray(ref) - start).max()
        assert moved > 0
        np.testing.assert_allclose(got, np.asarray(ref), atol=0.01 * moved, rtol=0)
    assert t_scores[-1] > t_scores[0]


# The reconstruction CLI's trajectory on a small CT: 4 views.
RECON_THETAS = np.linspace(0, np.pi, 4, endpoint=False)
RECON_ROT = np.stack([RECON_THETAS, np.full(4, np.pi / 2), np.zeros(4)], 1).astype(np.float32)
RECON_TRANS = np.tile(np.array([[0.0, 850.0, 0.0]], np.float32), (4, 1))
RECON_LR = 5e-2


def test_trilinear_reconstruction_matches_jax_kernels():
    """3 reconstruction steps on the kernel path (joseph_fwd + joseph_bwd_vol)
    against a JAX loop through raymarch_pallas_raycast (interpret mode) and
    optax.adam, from zeros, on the same measured views."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=1020.0, height=32, delx=3.0)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu", renderer="trilinear")
    rot, trans = jnp.asarray(RECON_ROT), jnp.asarray(RECON_TRANS)
    src, tgt = jd.detector(jconvert(rot, trans, **KW), None)
    w = jnp.linalg.norm(tgt - src, axis=-1)[:, None, :]
    sv, tv = jd.affine_inverse(src), jd.affine_inverse(tgt)
    assert int(np.argmin(td.worst_ratios(torch.tensor(np.asarray(sv)),
                                         torch.tensor(np.asarray(tv))))) == 2

    def jrender(density):
        img = raymarch_pallas_raycast(density, sv, tv, w, axis=2, n_points=500,
                                      fused_pose_bwd=False, **PALLAS)
        return img.reshape(4, 1, 32, 32)

    measured = jrender(jd.density)

    def jloss(density):
        return jnp.mean((jrender(density) - measured) ** 2)

    tx = optax.adam(RECON_LR)
    jdens = jnp.zeros_like(jd.density)
    jstate = tx.init(jdens)
    j_loss, j_grad = [], []
    for _ in range(3):
        loss, g = jax.value_and_grad(jloss)(jdens)
        updates, jstate = tx.update(g, jstate, jdens)
        jdens = optax.apply_updates(jdens, updates)
        j_loss.append(float(loss))
        j_grad.append(np.asarray(g))

    init, step = make_reconstruction_step(td, lr=RECON_LR)
    tdens, opt = init(torch.zeros(td.density.shape))
    t_loss, t_grad = [], []
    for _ in range(3):
        tdens, opt, loss = step(tdens, opt, torch.tensor(RECON_ROT), torch.tensor(RECON_TRANS),
                                torch.tensor(np.asarray(measured)))
        t_loss.append(loss.item())
        t_grad.append(tdens.grad.detach().clone())
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-3)
    assert t_loss[-1] < t_loss[0]
    for got, ref in zip(t_grad, j_grad):
        _close(got, ref, 1e-3)
    mask = np.ones(jd.density.shape, bool)
    for g in j_grad:
        mask &= np.abs(g) > 1e-3 * np.abs(g).max()
    assert mask.sum() > 1000
    np.testing.assert_allclose(tdens.detach().numpy()[mask], np.asarray(jdens)[mask],
                               atol=1e-3 * RECON_LR, rtol=0)


# -----------------------------------------------------------------------------
# The reconstruction CLI and checkpoint.py
# -----------------------------------------------------------------------------

CLI_ARGS = ["--cpu", "--volume-size", "32", "--height", "16", "--ckpt-every", "2"]


def test_cli_reconstructs_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = cli.main(CLI_ARGS + ["--n-iters", "4", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "iter    0  mse" in out and "iter    3  mse" in out
    assert "voxel RMSE" in out and "done in" in out and "(4 steps from step 0," in out
    assert first["start"] == 0 and len(first["losses"]) == 4 == len(first["step_ms"])
    assert first["losses"][-1] < first["losses"][0]
    assert 0 < first["rmse"] < first["rms"]
    assert sorted(os.listdir(ckpt)) == ["step_00000002.pt", "step_00000004.pt"]

    resumed = cli.main(CLI_ARGS + ["--n-iters", "6", "--ckpt-dir", ckpt])
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["start"] == 4 and len(resumed["losses"]) == 2
    assert sorted(os.listdir(ckpt)) == ["step_00000004.pt", "step_00000006.pt"]  # max_to_keep 2
    straight = cli.main(CLI_ARGS + ["--n-iters", "6"])
    np.testing.assert_allclose(resumed["losses"], straight["losses"][4:], rtol=1e-6)
    np.testing.assert_allclose(resumed["rmse"], straight["rmse"], rtol=1e-6)

    again = cli.main(CLI_ARGS + ["--n-iters", "6", "--ckpt-dir", ckpt])
    assert again["start"] == 6 and again["losses"] == []  # nothing left to run
    assert "(0 steps from step 6," in capsys.readouterr().out  # says it ran nothing


def test_cli_flags_and_defaults_match_jax_cli():
    args = cli.parse_args([])
    assert (args.n_views, args.n_iters, args.height, args.volume_size, args.lr,
            args.renderer, args.ckpt_every, args.cpu, args.mesh) == (
        8, 100, 64, 96, 5e-2, "trilinear", 25, False, False)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        cli.main(["--cpu", "--mesh"])
    joseph = cli.main(CLI_ARGS + ["--n-iters", "3", "--renderer", "joseph"])
    assert joseph["losses"][-1] < joseph["losses"][0]


def test_checkpoint_retention_atomic_writes_and_restore(tmp_path, monkeypatch):
    mgr = checkpoint.CheckpointManager(tmp_path, max_to_keep=2)
    dens = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    opt = torch.optim.Adam([dens], lr=0.1)
    dens.sum().backward()
    opt.step()
    assert mgr.latest() is None
    for step in (1, 2, 3):
        assert mgr.maybe_save(step, {"density": dens, "opt_state": opt.state_dict()}, every=1)
    assert not mgr.maybe_save(5, {}, every=2)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3

    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(4, {"density": dens})
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002.pt", "step_00000003.pt"]

    like = {"density": torch.zeros(2, 3, dtype=torch.float64), "opt_state": opt.state_dict()}
    step, state = mgr.latest(like=like)
    assert step == 3 and state["density"].dtype == torch.float64
    torch.testing.assert_close(state["density"], dens.detach().double())
    opt2 = torch.optim.Adam([torch.zeros(2, 3, requires_grad=True)], lr=0.1)
    opt2.load_state_dict(state["opt_state"])
    torch.testing.assert_close(opt2.state_dict()["state"][0]["exp_avg"],
                               opt.state_dict()["state"][0]["exp_avg"])
    checkpoint.save_pytree(tmp_path / "one.pt", {"x": torch.ones(2)})
    torch.testing.assert_close(checkpoint.load_pytree(tmp_path / "one.pt")["x"], torch.ones(2))


# -----------------------------------------------------------------------------
# Autograd: only the kernels a backward needs
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("case, want", [
    ("pose", {"joseph_fwdgrad"}),
    ("pose_two_pass", {"joseph_fwd", "joseph_bwd_rays"}),
    ("density", {"joseph_fwd", "joseph_bwd_vol"}),
    ("both", {"joseph_fwdgrad", "joseph_bwd_vol"}),
    ("mip", {"joseph_fwdgrad", "joseph_bwd_vol"}),
    ("mip_two_pass", {"joseph_fwd_max", "joseph_bwd_rays", "joseph_bwd_vol"}),
    ("mip_density", {"joseph_fwd_max", "joseph_bwd_vol"}),
])
def test_autograd_calls_only_the_kernels_it_needs(monkeypatch, case, want):
    """A pose-only backward runs no density gradient, a density-only one no
    fused forward (the wrappers are counted by name; on the CPU they run
    their plain versions)."""
    called = set()
    for fn in J.KERNELS:
        def counted(*a, _fn=fn, **k):
            called.add(_fn.__name__)
            return _fn(*a, **k)
        monkeypatch.setattr(J, fn.__name__, counted)
    vol = torch.rand((6, 5, 4), generator=torch.Generator().manual_seed(0))
    src = torch.tensor([[[-9.0, 2.2, 1.7]]])
    tgt = torch.tensor([[[9.0, 2.9, 2.1], [9.0, 1.4, 2.6]]])
    w = torch.ones((1, 1, 2))
    dens_grad = case in ("density", "both", "mip", "mip_two_pass", "mip_density")
    pose_grad = case not in ("density", "mip_density")
    density = vol.clone().requires_grad_(dens_grad)
    tgt = tgt.clone().requires_grad_(pose_grad)
    out = J.joseph_march_raycast(density, src, tgt, w, axis=0, step=1.3,
                                 reduce="max" if case.startswith("mip") else "sum",
                                 fused=not case.endswith("two_pass"))
    torch.sum(out ** 2).backward()
    assert called == want
    assert (density.grad is not None) == dens_grad
    assert (tgt.grad is not None) == pose_grad
