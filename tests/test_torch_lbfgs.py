"""The port's L-BFGS (``diffdrr_tpu_torch.lbfgs``) against ``optax.lbfgs()``,
and LBFGS registration against the JAX package's, on the CPU.

Analytic functions: Rosenbrock and an ill-conditioned quadratic (condition
number 1e3), each of five or six variables split over a two-leaf dict, in
float32, 10 steps from a seeded start. Both optimizers are handed the same
function: its value and gradient are computed in float64 by NumPy and
rounded to float32 (for optax through ``jax.pure_callback`` under a custom
VJP), so the test holds the two optimizers against each other rather than
two autodiff systems' float32 rounding, which Rosenbrock amplifies to
~2e-5 in 10 steps. The parameters agree to 1e-5 relative at every step and
the line search makes optax's ``num_linesearch_steps`` evaluations at every
step; also with a memory of 3 (the ring buffer wraps) and with at most 2
line-search evaluations (the line search fails and takes its fallback).

On a DRR: 4 LBFGS steps on ``tests/test_registration.py``'s small CT (the
48x48x24 example CT, sdd 800, a 32x32 detector of 3 mm pixels, trilinear
with 200 points, the port on its oracle through ``force_xla``) against the
JAX package: the same evaluations a step, the scores to 1e-4 relative, the
rotation to 1e-3 rad and the translation to 0.05 mm (reached: ~5e-5
relative, ~8e-4 rad, ~3e-3 mm at step 4; L-BFGS's curvature pairs amplify
the renderers' ~1e-6 differences). Multistart: each restart equals its own
serial run bit for bit, and the near restart equals the JAX package's
multistart to the JAX package's own test's tolerances (its ``lax.map``
restarts and its serial runs differ by that much). The CLI: ``--optimizer
lbfgs`` against the JAX CLI.
"""

import csv
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from diffdrr_tpu import DRR as JDRR, load_example_ct as jload
from diffdrr_tpu import registration as JR

from diffdrr_tpu_torch import interop, lbfgs as L
from diffdrr_tpu_torch import registration as TR
from diffdrr_tpu_torch.drr import DRR
from diffdrr_tpu_torch.experiments import registration as cli
from diffdrr_tpu_torch.pose import convert

ROOT = Path(__file__).resolve().parents[1]
KW = dict(parameterization="euler_angles", convention="ZXY")


def _rosenbrock(x):
    v = np.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    g = np.zeros_like(x)
    g[1:] += 200 * (x[1:] - x[:-1] ** 2)
    g[:-1] += -400 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    return v, g


_D = np.logspace(0, 3, 6)
_C = np.random.default_rng(1).normal(size=6)


def _quadratic(x):
    return 0.5 * np.sum(_D * (x - _C) ** 2), _D * (x - _C)


FUNCTIONS = {"rosenbrock": (_rosenbrock, (3, 2)), "quadratic": (_quadratic, (4, 2))}


def _float32_objective(fn, n_a):
    """(a, b) float32 -> float32 value and gradients, computed in float64."""
    def vg(a, b):
        v, g = fn(np.concatenate([a, b]).astype(np.float64))
        return np.float32(v), g[:n_a].astype(np.float32), g[n_a:].astype(np.float32)
    return vg


def _optax_objective(vg):
    def call(p):
        shapes = (jax.ShapeDtypeStruct((), jnp.float32),
                  jax.ShapeDtypeStruct(p["a"].shape, jnp.float32),
                  jax.ShapeDtypeStruct(p["b"].shape, jnp.float32))
        return jax.pure_callback(lambda a, b: vg(np.asarray(a), np.asarray(b)), shapes,
                                 p["a"], p["b"])

    @jax.custom_vjp
    def f(p):
        return call(p)[0]

    def fwd(p):
        v, ga, gb = call(p)
        return v, {"a": ga, "b": gb}

    f.defvjp(fwd, lambda g, ct: ({k: ct * v for k, v in g.items()},))
    return f


def _port_state(sj):
    """The port's state holding optax's chain state ``sj``."""
    lb, _, ls = sj

    def tree(t):
        return {k: torch.tensor(np.asarray(v)) for k, v in t.items()}

    return L.LBFGSState(
        count=int(lb.count), params=tree(lb.params), updates=tree(lb.updates),
        diff_params_memory=tree(lb.diff_params_memory),
        diff_updates_memory=tree(lb.diff_updates_memory),
        weights_memory=torch.tensor(np.asarray(lb.weights_memory)),
        learning_rate=torch.tensor(np.asarray(ls.learning_rate)),
        value=torch.tensor(np.asarray(ls.value)), grad=tree(ls.grad),
        num_linesearch_steps=int(ls.info.num_linesearch_steps),
        decrease_error=torch.tensor(np.asarray(ls.info.decrease_error)),
        curvature_error=torch.tensor(np.asarray(ls.info.curvature_error)))


@pytest.mark.parametrize("name,memory,max_ls", [("rosenbrock", 10, 20), ("quadratic", 10, 20),
                                                ("rosenbrock", 3, 20), ("rosenbrock", 10, 1)])
def test_matches_optax_step_for_step(name, memory, max_ls):
    """Each step taken from optax's own state (params, memory, last value
    and gradient) equals optax's step: the parameters to 1e-5 relative, the
    evaluations and the line search's final errors. Run free, the port
    makes optax's evaluations at every step, and its parameters stay within
    1e-5 relative on the quadratic; on Rosenbrock float32 rounding of the
    two-loop recursion (~1e-7) grows to ~1e-3 by step 10 (the zoom at its
    step 9 is that sensitive), so there the free run's bound is 2e-3."""
    fn, (n_a, n_b) = FUNCTIONS[name]
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=n_a).astype(np.float32),
          "b": rng.normal(size=n_b).astype(np.float32)}
    vg = _float32_objective(fn, n_a)
    f = _optax_objective(vg)
    tx = optax.lbfgs(memory_size=memory, linesearch=optax.scale_by_zoom_linesearch(
        max_linesearch_steps=max_ls, initial_guess_strategy="one"))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = tx.init(pj)
    j_vg = optax.value_and_grad_from_state(f)

    def t_vg(p):
        v, ga, gb = vg(p["a"].numpy(), p["b"].numpy())
        return torch.tensor(v), {"a": torch.tensor(ga), "b": torch.tensor(gb)}

    def t_step(p, s):
        v, g = L.value_and_grad_from_state(t_vg, p, s)
        u, s = T.update(g, s, p, value=v, value_and_grad_fn=t_vg)
        return {k: p[k] + u[k] for k in p}, s

    T = L.LBFGS(memory_size=memory, max_linesearch_steps=max_ls)
    pt = {k: torch.tensor(v) for k, v in p0.items()}
    st = T.init(pt)
    counts, errors = [], []
    free_rtol = 1e-5 if name == "quadratic" else 2e-3
    for _ in range(10):
        forced, sf = t_step({k: torch.tensor(np.asarray(v)) for k, v in pj.items()},
                            _port_state(sj))
        v, g = j_vg(pj, state=sj)
        u, sj = tx.update(g, sj, pj, value=v, grad=g, value_fn=f)
        pj = optax.apply_updates(pj, u)
        pt, st = t_step(pt, st)
        info = sj[2].info
        n = int(info.num_linesearch_steps)
        assert sf.num_linesearch_steps == st.num_linesearch_steps == n
        for k in pj:
            np.testing.assert_allclose(forced[k].numpy(), np.asarray(pj[k]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=free_rtol,
                                       atol=1e-7)
        np.testing.assert_allclose([float(sf.decrease_error), float(sf.curvature_error)],
                                   [float(info.decrease_error), float(info.curvature_error)],
                                   rtol=1e-4, atol=1e-6)
        counts.append(n)
        errors.append(float(info.curvature_error) + float(info.decrease_error))
    if max_ls == 1:  # some line search failed and returned its fallback step
        assert max(errors) > 0
    else:
        assert max(errors) == 0


def test_first_evaluation_from_state_and_counts():
    """``value_and_grad_from_state`` evaluates only when the stored value is
    not finite (before the first step); ``evaluations`` counts both kinds."""
    def vg(p):
        x = p["x"]
        return torch.sum((x - 3.0) ** 2), {"x": 2 * (x - 3.0)}

    T = L.LBFGS()
    p = {"x": torch.zeros(4)}
    s = T.init(p)
    L.reset_evaluations()
    total = 0
    for _ in range(3):
        v, g = L.value_and_grad_from_state(vg, p, s)
        u, s = T.update(g, s, p, value=v, value_and_grad_fn=vg)
        p = {"x": p["x"] + u["x"]}
        total += s.num_linesearch_steps
    assert L.evaluations == {"linesearch": total, "first": 1}
    np.testing.assert_allclose(p["x"].numpy(), 3.0, atol=1e-5)


@pytest.fixture(scope="module")
def small():
    """``tests/test_registration.py``'s scene in both packages."""
    rot = np.array([[0.05, np.pi / 2 + 0.03, -0.04]], np.float32)
    trans = np.array([[2.0, 400.0, -3.0]], np.float32)
    jd = JDRR(jload(shape=(48, 48, 24)), sdd=800.0, height=32, delx=3.0, renderer="trilinear")
    target = jd(jnp.asarray(rot), jnp.asarray(trans), n_points=200, **KW)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu", renderer="trilinear")
    return jd, td, target, torch.tensor(np.asarray(target)), rot, trans


def test_drr_registration_matches_jax(small):
    jd, td, jtarget, ttarget, rot, trans = small
    rot0 = rot + np.array([[0.02, -0.015, 0.01]], np.float32)
    trans0 = trans + np.array([[4.0, -3.0, 2.5]], np.float32)
    j_init, j_step = JR.make_registration_step(jd, jtarget, "euler_angles", "ZXY",
                                               optimizer="lbfgs", n_points=200)
    t_init, t_step = TR.make_registration_step(td, ttarget, "euler_angles", "ZXY",
                                               optimizer="lbfgs", n_points=200, force_xla=True)
    jp, js = j_init(jnp.asarray(rot0), jnp.asarray(trans0))
    tp, ts = t_init(torch.tensor(rot0), torch.tensor(trans0))
    scores = []
    for _ in range(4):
        jp, js, j_score = j_step(jp, js)
        tp, ts, t_score = t_step(tp, ts)
        assert ts.state.num_linesearch_steps == int(
            optax.tree_utils.tree_get(js, "num_linesearch_steps"))
        np.testing.assert_allclose(float(t_score), float(j_score), rtol=1e-4)
        np.testing.assert_allclose(tp["rotation"].numpy(), np.asarray(jp["rotation"]), atol=1e-3)
        np.testing.assert_allclose(tp["translation"].numpy(), np.asarray(jp["translation"]),
                                   atol=0.05)
        scores.append(float(t_score))
    assert scores == sorted(scores) and scores[-1] > scores[0]  # accepted steps ascend


def test_multistart_restarts_equal_serial_runs(small):
    """Each restart is its own single-pose run (bit for bit) and the JAX
    package's multistart's restart (``tests/test_registration.py``'s starts)."""
    jd, td, jtarget, ttarget, rot, trans = small
    rots0 = rot[0] + np.array([[0.01, -0.01, 0.0], [0.2, 0.15, -0.18]], np.float32)
    transs0 = trans[0] + np.array([[1.0, -1.0, 0.5], [15.0, 12.0, -14.0]], np.float32)
    run = dict(optimizer="lbfgs", n_iters=4, n_points=200)
    rots, transs, final, trace = TR.optimize_multistart(
        td, ttarget, torch.tensor(rots0), torch.tensor(transs0), "euler_angles", "ZXY",
        force_xla=True, **run)
    assert rots.shape == transs.shape == (2, 3) and final.shape == (2,)
    assert trace.shape == (4, 2)
    for i in range(2):
        r, t, single = TR.optimize(td, ttarget, torch.tensor(rots0[i:i + 1]),
                                   torch.tensor(transs0[i:i + 1]), "euler_angles", "ZXY",
                                   force_xla=True, **run)
        assert torch.equal(r[0], rots[i]) and torch.equal(t[0], transs[i])
        assert single == trace[:, i].tolist()
    # The JAX package's own test holds its lax.map restarts against its
    # serial runs to these tolerances (scores atol 1e-3, rotation 2e-3) for
    # the near start; the far start (0.2 rad, 15 mm off) only scores lower.
    j = JR.optimize_multistart(jd, jtarget, jnp.asarray(rots0), jnp.asarray(transs0),
                               "euler_angles", "ZXY", **run)
    np.testing.assert_allclose(trace[:, 0].numpy(), np.asarray(j[3])[:, 0], atol=1e-3)
    np.testing.assert_allclose(final[0].item(), float(j[2][0]), atol=1e-3)
    np.testing.assert_allclose(rots[0].numpy(), np.asarray(j[0])[0], atol=2e-3)
    np.testing.assert_allclose(transs[0].numpy(), np.asarray(j[1])[0], atol=0.3)
    assert torch.isfinite(final).all() and final[0] >= final[1] - 1e-4


def test_until_and_multiscale_take_lbfgs(small):
    """``optimize_until`` and ``optimize_multiscale`` run LBFGS: the first
    stops where its replay's distance first meets the tolerance, the second
    ends each scale's trace higher than it began."""
    _, td, _, ttarget, rot, trans = small
    rot0 = torch.tensor(rot + np.array([[0.02, -0.015, 0.01]], np.float32))
    trans0 = torch.tensor(trans + np.array([[4.0, -3.0, 2.5]], np.float32))
    true_pose = convert(torch.tensor(rot), torch.tensor(trans), **KW)
    r, t, n, dist = TR.optimize_until(td, ttarget, rot0, trans0, "euler_angles", "ZXY",
                                      true_pose=true_pose, tol_mm=0.0, max_iters=3,
                                      optimizer="lbfgs", n_points=200)
    r3, t3, _ = TR.optimize(td, ttarget, rot0, trans0, "euler_angles", "ZXY", n_iters=3,
                            optimizer="lbfgs", n_points=200)
    assert n == 3 and torch.equal(r, r3) and torch.equal(t, t3)
    _, _, traces = TR.optimize_multiscale(td, ttarget, rot0, trans0, "euler_angles", "ZXY",
                                          scales=(0.5, 1.0), n_iters_per_scale=3,
                                          optimizer="lbfgs", n_points=200)
    assert [len(tr) for tr in traces] == [3, 3]
    assert all(tr[-1] >= tr[0] for tr in traces)


# -- the CLI against the JAX CLI ----------------------------------------------

def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_registration_cli",
                                                  ROOT / "experiments" / "registration.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_phantom(shape, device=None):
    js = jload(shape=shape)
    return interop.subject_from_state({
        "density": np.asarray(js.density.data), "affine": np.asarray(js.volume.affine),
        "reorient": np.asarray(js.reorient), "mask": None, "orientation": js.orientation},
        device)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("argv,files", [
    (["--renderer", "siddon", "--n-runs", "2", "--n-iters", "2"],
     ["run_000.csv", "run_001.csv", "summary.csv"]),
    (["--multistart", "--n-runs", "2", "--n-iters", "2"], ["multistart.csv"]),
], ids=["serial", "multistart"])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, argv, files):
    """``--optimizer lbfgs`` through both CLIs on one CT (the JAX phantom's
    arrays), a 48x48x16 CT and a 24x24 detector; the trilinear runs on the
    oracles, 2 steps a run. L-BFGS's first step is up to 1 in parameter
    space (1 rad of rotation), which takes these small-CT runs hundreds of
    mm off, where the renderers' ~1e-6 differences grow: by step 4 a run's
    geodesic differs by ~1%. Over 2 steps each CSV's scores agree to 1e-4
    relative and its geodesics to 1e-3 relative, the iteration counts and
    flags exactly."""
    monkeypatch.setattr(cli, "load_example_ct", _jax_phantom)
    monkeypatch.setattr(cli, "DRR", functools.partial(DRR, force_xla=True))
    small = ["--cpu", "--volume-size", "48", "--height", "24", "--optimizer", "lbfgs"]
    res = CliRunner().invoke(_jax_cli().main, small + argv + ["--outdir", str(tmp_path / "jax")])
    assert res.exit_code == 0, res.output
    record = cli.main(small + argv + ["--outdir", str(tmp_path / "port")])
    for name in files:
        a, b = _rows(tmp_path / "jax" / name), _rows(tmp_path / "port" / name)
        assert len(a) == len(b) and a[0] == b[0]
        for ra, rb in zip(a[1:], b[1:]):
            for col, x, y in zip(a[0], ra, rb):
                if col in ("run", "iter", "converged", "iters"):
                    assert x == y, col
                elif "score" in col:
                    np.testing.assert_allclose(float(y), float(x), rtol=1e-4, atol=1e-5,
                                               err_msg=col)
                elif col.endswith("_mm"):
                    np.testing.assert_allclose(float(y), float(x), rtol=1e-3, err_msg=col)
    if record["mode"] == "serial":
        for run in record["runs"]:
            assert len(run["linesearch_steps"]) == len(run["scores"]) == 2
            assert all(n >= 1 for n, _ in run["linesearch_steps"])
