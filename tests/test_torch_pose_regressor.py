"""The port's ``PoseRegressor`` and its trainer against the JAX package's flax
model and ``experiments/pose_regressor.py``, on the CPU.

Weights are the flax model's own (``PoseRegressor.init`` from
``PRNGKey(0)``), carried across by ``interop.pose_regressor_state_from_flax``;
inputs are seeded NumPy arrays. The poses of every parameterization in
``N_ANGULAR_COMPONENTS`` (Euler angles in two conventions: 9 cases) agree to
1e-5 at 32x32 and at 33x33 inputs, whose stride-2 convolutions flax pads
(0, 1) and (1, 1). One training step's loss (the trainer's Frobenius
rotation error plus 1e-4 times the squared translation error) and every
weight's gradient agree with ``jax.value_and_grad`` to 1e-4 relative (of
each tensor's largest entry). The trainer's batch (the poses it draws,
rendered and normalised) equals the JAX package's render of those poses,
and a resumed run continues the uninterrupted one exactly.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.registration import PoseRegressor as JPoseRegressor

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.experiments import pose_regressor as trainer
from diffdrr_tpu_torch.pose import convert
from diffdrr_tpu_torch.registration import N_ANGULAR_COMPONENTS, PoseRegressor

ROOT = Path(__file__).resolve().parents[1]
CASES = ([(p, "ZYX" if p == "euler_angles" else None) for p in N_ANGULAR_COMPONENTS]
         + [("euler_angles", "ZXY")])


def _pair(parameterization, convention, size, model_name="small"):
    """The flax model with its initial weights, and the port's with the same."""
    jm = JPoseRegressor(parameterization=parameterization, convention=convention,
                        model_name=model_name)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, size, size), jnp.float32))
    tm = PoseRegressor(parameterization, convention, model_name=model_name)
    tm.load_state_dict(interop.pose_regressor_state_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return jm, variables, tm


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("parameterization,convention", CASES)
def test_carried_weights_give_the_jax_pose(parameterization, convention, size):
    jm, variables, tm = _pair(parameterization, convention, size)
    x = np.random.default_rng(size).normal(size=(2, 1, size, size)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)).matrix)
    with torch.no_grad():
        got = tm(torch.tensor(x)).matrix.numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    R = got[:, :3, :3]
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-4)


def test_training_step_matches_jax_value_and_grad():
    """The trainer's loss and its gradient to every weight, on one batch."""
    jm, variables, tm = _pair("rotation_6d", None, 32)
    rng = np.random.default_rng(4)
    imgs = rng.normal(size=(3, 1, 32, 32)).astype(np.float32)
    rot = (np.array([[0.0, np.pi / 2, 0.0]]) + rng.normal(0, 0.1, (3, 3))).astype(np.float32)
    trans = (np.array([[0.0, 850.0, 0.0]]) + rng.normal(0, 15, (3, 3))).astype(np.float32)
    kw = dict(parameterization="euler_angles", convention="ZXY")
    jtrue = jconvert(jnp.asarray(rot), jnp.asarray(trans), **kw)

    def jloss(params):  # experiments/pose_regressor.py's loss_fn
        pred = jm.apply(params, jnp.asarray(imgs))
        dR = jnp.sum((pred.rotation - jtrue.rotation) ** 2, axis=(1, 2))
        dt = jnp.sum((pred.translation - jtrue.translation) ** 2, axis=1)
        return jnp.mean(dR + 1e-4 * dt)

    jl, jg = jax.value_and_grad(jloss)(variables)
    loss = trainer.loss_fn(tm, torch.tensor(imgs), convert(torch.tensor(rot),
                                                            torch.tensor(trans), **kw))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    ref = interop.pose_regressor_state_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    grads = dict(tm.named_parameters())
    assert set(ref) == set(grads)
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(),
                                   atol=1e-4 * g.abs().max().item(), err_msg=name)


def test_batch_is_the_jax_render_of_its_poses():
    """``sample_batch``'s images are the JAX package's renders of the poses
    it drew (trilinear on both oracles), normalised per image."""
    jd = JDRR(jload(shape=(32, 32, 16)), sdd=1020.0, height=16, delx=3.0, renderer="trilinear")
    td = interop.drr_from_state(interop.export_state(jd), device="cpu", renderer="trilinear",
                                force_xla=True)
    gen = torch.Generator().manual_seed(1)
    imgs, pose = trainer.sample_batch(td, gen, 3)
    again = torch.Generator().manual_seed(1)
    rot = torch.tensor([[0.0, np.pi / 2, 0.0]]) + 0.1 * torch.randn(3, 3, generator=again)
    trans = torch.tensor([[0.0, 850.0, 0.0]]) + 15.0 * torch.randn(3, 3, generator=again)
    ref = np.asarray(jd(jnp.asarray(rot.numpy()), jnp.asarray(trans.numpy()),
                        parameterization="euler_angles", convention="ZXY"))
    ref = (ref - ref.mean((1, 2, 3), keepdims=True)) / (ref.std((1, 2, 3), keepdims=True) + 1e-6)
    np.testing.assert_allclose(imgs.numpy(), ref, atol=1e-3 * np.abs(ref).max())
    np.testing.assert_allclose(
        pose.matrix.numpy(),
        np.asarray(jconvert(jnp.asarray(rot.numpy()), jnp.asarray(trans.numpy()),
                            parameterization="euler_angles", convention="ZXY").matrix),
        rtol=1e-5, atol=1e-4)


SMALL = ["--cpu", "--volume-size", "32", "--height", "16", "--batch-size", "2"]


def test_trainer_resumes_where_it_stopped(tmp_path):
    """4 steps saved every 2, then a run to 6 from the checkpoint: it starts
    at step 4 and its two losses are the uninterrupted 6-step run's."""
    straight = trainer.main(SMALL + ["--n-steps", "6"])
    first = trainer.main(SMALL + ["--n-steps", "4", "--ckpt-dir", str(tmp_path),
                                  "--ckpt-every", "2"])
    resumed = trainer.main(SMALL + ["--n-steps", "6", "--ckpt-dir", str(tmp_path),
                                    "--ckpt-every", "2"])
    assert (first["start"], resumed["start"], resumed["steps"]) == (0, 4, 2)
    assert first["losses"] == straight["losses"][:4]
    assert resumed["losses"] == straight["losses"][4:]
    assert len(straight["step_ms"]) == 6 and np.isfinite(straight["losses"]).all()


def test_trainer_flags_match_jax_script_and_rotation_10d_trains():
    spec = importlib.util.spec_from_file_location("jax_pose_regressor",
                                                  ROOT / "experiments" / "pose_regressor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax_defaults = {p.name: p.default for p in mod.main.params}
    args = vars(trainer.parse_args([]))
    assert set(jax_defaults) == set(args)
    for name, default in jax_defaults.items():
        assert args[name] == default, name
    run = trainer.main(SMALL + ["--n-steps", "3", "--parameterization", "rotation_10d"])
    assert len(run["losses"]) == 3 and np.isfinite(run["losses"]).all()
    assert run["model"].rotation_head.out_features == 10
