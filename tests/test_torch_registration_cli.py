"""The port's registration CLI against the JAX package's CLI itself, on the CPU.

Both CLIs run from the same seed at a small size (``--volume-size 32
--height 16``: a 32x32x16 CT, a 16x16 detector of 2 mm pixels) into
``tmp_path``; the JAX one through ``click.testing.CliRunner``. The two
packages' example phantoms differ in the last bit of some voxels (float
arithmetic in another order), and a run this short on a CT this small
amplifies that (a patch NCC variance at the flat-patch gate); so the port's
CLI is handed the JAX phantom's own arrays (``interop``), and the test holds
the CLIs' flows against each other on one CT.

Renderers: ``--renderer siddon`` computes the exact Siddon integral in both
packages (the JAX sort-based oracle, the port's slab march). The default,
trilinear, is the JAX oracle's evenly spaced samples on the CPU but the
plane-aligned march of the kernels in the port, so there the port's DRR is
given ``force_xla=True`` and both run their oracles.

Tolerances (``test_sixty_step_registration_matches_jax``'s): scores 1e-4
relative, or 1e-5 absolute for scores near 0 (at this size the random
starts put much of the CT out of the 32 mm field, and NCCs of ~0.005 carry
float32 rounding of ~2e-6), geodesics 0.01 mm (the translation's 0.01 mm;
a rotation 1e-5 rad off is 0.005 mm at sdd / 2).
"""

import csv
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from diffdrr_tpu import load_example_ct as jload

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.drr import DRR
from diffdrr_tpu_torch.experiments import registration as cli

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--cpu", "--volume-size", "32", "--height", "16"]


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
        "reorient": np.asarray(js.reorient),
        "mask": None if js.mask is None else np.asarray(js.mask.data),
        "orientation": js.orientation}, device)


@pytest.fixture
def both(tmp_path, monkeypatch):
    """Run ``argv`` through both CLIs: (JAX output, port record, port output dirs)."""
    jcli = _jax_cli()
    monkeypatch.setattr(cli, "load_example_ct", _jax_phantom)

    def run(argv, oracle=False):
        if oracle:
            monkeypatch.setattr(cli, "DRR", functools.partial(DRR, force_xla=True))
        res = CliRunner().invoke(jcli.main, SMALL + argv + ["--outdir", str(tmp_path / "jax")])
        assert res.exit_code == 0, res.output
        record = cli.main(SMALL + argv + ["--outdir", str(tmp_path / "port")])
        return res.output, record, tmp_path / "jax", tmp_path / "port"

    return run


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_columns(a, b, exact=(), score=(), mm=()):
    assert len(a) == len(b) and a[0] == b[0]
    header = a[0]
    for ra, rb in zip(a[1:], b[1:]):
        for name in exact:
            assert ra[header.index(name)] == rb[header.index(name)], name
        for names, kw in ((score, dict(rtol=1e-4, atol=1e-5)), (mm, dict(rtol=0, atol=0.01))):
            for name in names:
                i = header.index(name)
                np.testing.assert_allclose(float(rb[i]), float(ra[i]), err_msg=name, **kw)


def test_flags_and_defaults_match_jax_cli():
    jcli = _jax_cli()
    args = vars(cli.parse_args([]))
    jax_defaults = {p.name: p.default for p in jcli.main.params}
    assert set(jax_defaults) == set(args)
    for name, default in jax_defaults.items():
        assert args[name] == default, name
    assert args["renderer"] == "trilinear"


def test_serial_runs_match_jax_cli(both):
    """2 runs of 5 Siddon steps: each run's CSV (score and the three
    geodesics) and the summary."""
    _, record, jdir, pdir = both(["--renderer", "siddon", "--n-runs", "2", "--n-iters", "5"])
    for name in ("run_000.csv", "run_001.csv"):
        _same_columns(_rows(jdir / name), _rows(pdir / name), exact=["iter"], score=["score"],
                      mm=["rot_geodesic_mm", "xyz_geodesic_mm", "double_geodesic_mm"])
    _same_columns(_rows(jdir / "summary.csv"), _rows(pdir / "summary.csv"),
                  exact=["run", "converged", "iters"], mm=["final_mm"])
    assert record["mode"] == "serial" and len(record["runs"]) == 2
    for run, name in zip(record["runs"], ("run_000.csv", "run_001.csv")):
        assert len(run["step_ms"]) == len(run["scores"]) == 5
        assert run["final_mm"] == pytest.approx(float(_rows(pdir / name)[-1][4]))


_SCALE = re.compile(r"scale (\S+):\s+([\d.]+) mm, score (\S+) -> (\S+)")


def test_multiscale_run_matches_jax_cli(both):
    """One run of ``--multiscale 0.5,1.0 --polish-iters 2`` (5 + 5 steps of
    the default trilinear renderer on the oracles, then 2 of gradient NCC):
    the summary, and each stage's echoed distance and first and last score
    (printed to 3 and 4 decimals). The 8x8 half-scale detector is smaller
    than the 13x13 patches, so that stage's score is NaN in both CLIs (its
    gradient comes from the global NCC alone)."""
    out, record, jdir, pdir = both(["--n-runs", "1", "--n-iters", "10", "--multiscale", "0.5,1.0",
                                    "--polish-iters", "2"], oracle=True)
    _same_columns(_rows(jdir / "multiscale_summary.csv"), _rows(pdir / "multiscale_summary.csv"),
                  exact=["run", "converged", "iters"], mm=["final_mm"])
    jlines = _SCALE.findall(out)
    assert [s[0] for s in jlines] == ["0.5", "1.0", "polish"] == record["stages"]
    (run,) = record["runs"]
    assert [len(s) for s in run["scores"]] == [len(s) for s in run["step_ms"]] == [5, 5, 2]
    for (_, mm, first, last), scores, label in zip(jlines, run["scores"], record["stages"]):
        np.testing.assert_allclose([scores[0], scores[-1]], [float(first), float(last)],
                                   atol=1.5e-4, err_msg=label)
    np.testing.assert_allclose(run["final_mm"], float(jlines[-1][1]), atol=0.011)
    assert run["final_mm"] < run["start_mm"]


def test_multistart_matches_jax_cli(both):
    """Three restarts of 4 Siddon steps as one batched run: multistart.csv's
    final scores and geodesics."""
    _, record, jdir, pdir = both(["--renderer", "siddon", "--multistart", "--n-runs", "3",
                                  "--n-iters", "4"])
    _same_columns(_rows(jdir / "multistart.csv"), _rows(pdir / "multistart.csv"), exact=["run"],
                  score=["final_score"], mm=["double_geodesic_mm"])
    assert record["mode"] == "multistart"
    assert np.asarray(record["trace"]).shape == (4, 3)


def test_lbfgs_raises_and_a_dropped_polish_warns(tmp_path, tmp_path_factory):
    """``--optimizer lbfgs``, once unported, runs: a 2-step run records its
    scores and each step's line-search evaluations. A polish stage without
    ``--multiscale`` warns that it is dropped."""
    lbfgs = cli.main(SMALL + ["--optimizer", "lbfgs", "--n-runs", "1", "--n-iters", "2",
                              "--outdir", str(tmp_path_factory.mktemp("lbfgs"))])
    (run,) = lbfgs["runs"]
    assert len(run["scores"]) == len(run["linesearch_steps"]) == 2
    assert all(n >= 1 for n, _ in run["linesearch_steps"]) and run["scores"][1] >= run["scores"][0]
    with pytest.warns(UserWarning, match="only with --multiscale"):
        record = cli.main(SMALL + ["--polish-iters", "3", "--n-runs", "1", "--n-iters", "2",
                                   "--outdir", str(tmp_path)])
    assert record["mode"] == "serial" and len(record["runs"][0]["scores"]) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run_000.csv", "summary.csv"]
