"""The port's ``utils`` (resampling, PnP, the pinhole camera) and its scipy
baseline against the JAX package's, on the CPU.

``utils``: ``tests/test_utils.py``'s five cases, each also held against the
JAX function on the same seeded inputs: resampled images to 1e-5 of their
largest value (bilinear weights and antialiased resizes in float32), PnP in
float64 to 1e-9, the pinhole camera's projection matrix to 1e-4 relative
(it is fitted to float32 projections of the same corners). ``reg_scipy``:
both scripts from the same seed, on one CT (the JAX phantom's arrays) and
both trilinear oracles, a few Nelder-Mead iterations: the same function
evaluations and final geodesics to 0.01 mm. One Powell iteration (~70
evaluations, whose Brent line searches end on differences of the size of
the renderers' ~1e-6, and which at this 32 mm field wanders ~900 mm off):
evaluations within 2 and geodesics to 1e-3 relative (reached: 1 and 3e-5).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from scipy.spatial.transform import Rotation

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu import utils as ju

from diffdrr_tpu_torch import interop, utils as tu
from diffdrr_tpu_torch.drr import DRR
from diffdrr_tpu_torch.experiments import reg_scipy
from diffdrr_tpu_torch.pose import convert

ROOT = Path(__file__).resolve().parents[1]


def _both_resample(img, *args, **kwargs):
    ref = np.asarray(ju.resample(jnp.asarray(img), *args, **kwargs))
    got = tu.resample(torch.tensor(img), *args, **kwargs).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0))
    return got


def test_resample_identity():
    img = np.random.default_rng(0).uniform(0, 1, (1, 1, 32, 32)).astype(np.float32)
    out = _both_resample(img, focal_len=1000.0, delx=2.0)
    np.testing.assert_allclose(out, img, atol=1e-4)


def test_resample_focal_change_zooms():
    img = np.zeros((1, 1, 33, 33), np.float32)
    img[0, 0, 16, 16] = 1.0
    out = _both_resample(img, 1000.0, 2.0, new_focal_len=2000.0)
    assert out.shape == img.shape and out[0, 0, 10:23, 10:23].max() > 0.1
    # A principal-point shift too (a fractional pixel shift).
    _both_resample(np.random.default_rng(1).uniform(0, 1, (2, 1, 24, 24)).astype(np.float32),
                   1000.0, 2.0, new_x0=3.0, new_y0=-1.5, new_focal_len=800.0)


def test_solve_pnp_dlt_recovers_extrinsics():
    rng = np.random.default_rng(1)
    R = Rotation.random(random_state=2).as_matrix()
    t = np.array([0.3, -0.2, 5.0])
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    X = rng.uniform(-1, 1, (12, 3))
    uv = (K @ ((R @ X.T).T + t).T).T
    uv = uv[:, :2] / uv[:, 2:]
    E = tu.solve_pnp_dlt(X[None], uv[None], K[None])[0]
    np.testing.assert_allclose(E[:, :3], R, atol=1e-6)
    np.testing.assert_allclose(E[:, 3], t, atol=1e-6)
    np.testing.assert_allclose(E, ju.solve_pnp_dlt(X[None], uv[None], K[None])[0], atol=1e-9)


def test_get_pinhole_camera_consistency():
    jd = JDRR(jload(shape=(32, 32, 16)), sdd=600.0, height=32, delx=2.0)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    rot = np.array([[0.1, np.pi / 2, -0.05]], np.float32)
    trans = np.array([[3.0, 350.0, -2.0]], np.float32)
    kw = dict(parameterization="euler_angles", convention="ZXY")
    pose = convert(torch.tensor(rot), torch.tensor(trans), **kw)
    cam = tu.get_pinhole_camera(td, pose)
    jcam = ju.get_pinhole_camera(jd, jconvert(jnp.asarray(rot), jnp.asarray(trans), **kw))
    np.testing.assert_allclose(cam.projmat, jcam.projmat, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cam.intrinsics, jcam.intrinsics)

    # The projection matrix reprojects the bbox corners onto the DRR's pixels.
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = td.subject.volume.get_bounds()
    assert td.subject.volume.get_bounds() == jd.subject.volume.get_bounds()
    X = np.array([[xmin, ymin, zmin], [xmax, ymax, zmax], [xmin, ymax, zmax],
                  [xmax, ymin, zmin]])
    expect = td.perspective_projection(pose, torch.tensor(X[None], dtype=torch.float32))[0]
    P = cam.projmat[0].astype(np.float64)
    proj = (P @ np.concatenate([X, np.ones((4, 1))], axis=1).T).T
    np.testing.assert_allclose(proj[:, :2] / proj[:, 2:], expect.numpy(), atol=0.1)

    # The camera centre is the X-ray source, and cam.pose is a (1, 4, 4) pose.
    source, _ = td.detector(pose, None)
    np.testing.assert_allclose(cam.center[0], source[0, 0].numpy(), atol=0.5)
    assert cam.pose.matrix.shape == (1, 4, 4)
    np.testing.assert_allclose(cam.pose.matrix.numpy(), np.asarray(jcam.pose.matrix),
                               rtol=1e-4, atol=1e-3)


def test_resample_pixel_shrink_crops():
    img = np.zeros((1, 1, 32, 32), np.float32)
    img[0, 0, 16, 16] = 1.0
    out = _both_resample(img, 1000.0, 2.0, new_delx=1.0)
    r, c = np.unravel_index(np.argmax(out[0, 0]), out[0, 0].shape)
    assert abs(r - 16) <= 2 and abs(c - 16) <= 2 and out[0, 0].max() > 0.1
    _both_resample(img, 1000.0, 2.0, new_delx=3.0)  # larger pixels: padding


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_phantom(shape, device=None):
    js = jload(shape=shape)
    return interop.subject_from_state({
        "density": np.asarray(js.density.data), "affine": np.asarray(js.volume.affine),
        "reorient": np.asarray(js.reorient), "mask": None, "orientation": js.orientation},
        device)


_RUN = re.compile(r"run (\d+): (\S+) nfev=(\d+) final=\s*([\d.]+) mm")


@pytest.mark.parametrize("method", ["Nelder-Mead", "Powell"])
def test_reg_scipy_matches_jax_script(monkeypatch, method):
    jscript = _jax_script("reg_scipy")
    jax_defaults = {p.name: p.default for p in jscript.main.params}
    assert jax_defaults == vars(reg_scipy.parse_args([]))
    monkeypatch.setattr(reg_scipy, "load_example_ct", _jax_phantom)
    monkeypatch.setattr(reg_scipy, "DRR", functools.partial(DRR, force_xla=True))
    argv = ["--volume-size", "32", "--height", "16", "--n-runs", "2", "--maxiter",
            "6" if method == "Nelder-Mead" else "1", "--method", method]
    # The JAX script's --cpu branch reads ``jax`` before the function's own
    # later ``import jax`` binds it (UnboundLocalError); the tests' JAX runs
    # on the CPU anyway, so it is run without the flag.
    res = CliRunner().invoke(jscript.main, argv)
    assert res.exit_code == 0, res.output
    jruns = _RUN.findall(res.output)
    record = reg_scipy.main(["--cpu"] + argv)
    assert len(jruns) == len(record["runs"]) == 2
    for (i, m, nfev, mm), run in zip(jruns, record["runs"]):
        assert m == method
        if method == "Nelder-Mead":
            assert int(nfev) == run["nfev"]
            np.testing.assert_allclose(run["final_mm"], float(mm), atol=0.01)
        else:  # Brent's line searches stop on the renderers' ~1e-6 differences
            assert abs(int(nfev) - run["nfev"]) <= 2
            np.testing.assert_allclose(run["final_mm"], float(mm), rtol=1e-3)
