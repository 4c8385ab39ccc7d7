"""The port's bench harness (``diffdrr_tpu_torch.bench``) on the CPU.

``--smoke`` runs all 13 metrics of the JAX harness at its tiny shapes
through the plain versions, with the JAX harness's output contract; without
``--smoke`` and without a card it measures nothing and exits non-zero. Each
render metric's first output (its DRR, pose and options, at the smoke
shapes) is held against the JAX package: on the CPU the JAX DRR renders on
its oracles, so, as in ``tests/test_torch_drr_joseph.py``, the reference is
the JAX kernel function the DRR would run (``siddon_pallas_raycast``,
``joseph_pallas_raycast``, ``raymarch_pallas_raycast`` in interpret mode,
with the JAX DRR's own tile configuration for axis 2) on the JAX DRR's
rays. Tolerance: 1e-4 * max, the renders' in ``tests/test_torch_siddon.py``
and ``tests/test_torch_drr_joseph.py``; the pose backwards' rotation
gradients 1e-3 * max.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu.ops.pallas.joseph import joseph_pallas_raycast
from diffdrr_tpu.ops.pallas.raymarch import raymarch_pallas_raycast
from diffdrr_tpu.ops.pallas.siddon import siddon_pallas_raycast

import diffdrr_tpu_torch as T
from diffdrr_tpu_torch import bench, bench_scaling

ROOT = Path(__file__).resolve().parents[1]
S = bench.SMOKE


def _expected_metrics():
    spec = importlib.util.spec_from_file_location("_jax_bench_smoke",
                                                  ROOT / "tests" / "test_bench_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.EXPECTED_METRICS


def _cli(*args, cwd):
    # One thread: the test workers share the cores (as tests/test_torch_parallel.py's ranks).
    env = {**{k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}, "PYTHONPATH": str(ROOT),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "diffdrr_tpu_torch.bench", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_smoke_cli_emits_the_jax_harness_metric_set(tmp_path):
    proc = _cli("--smoke", "--detail", "d.json", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["smoke"] is True and out["unit"] == "rays/s" and out["value"] > 0
    assert out["metric"] == "siddon_render_rays_per_s_200x200_512ct"
    assert "errors" not in out and "extra" not in out
    detail = json.loads(lines[-2])
    assert os.listdir(tmp_path) == ["d.json"]  # its own detail file, no BENCH_DETAIL.json
    assert detail == json.loads((tmp_path / "d.json").read_text())
    assert detail["device"] == {"name": "cpu", "count": 1}
    assert set(detail["extra"]) == _expected_metrics()
    for name, m in detail["extra"].items():
        if name == "scaling":
            assert m["scaling_efficiency"] > 0 and m["device"] == "cpu", m
            assert list(m["by_height"]) == ["64"] and m["volume"] == [32, 32, 8], m
            continue
        assert m.get("ms", m.get("ms_per_iter")) > 0, name
        win = m["window"]
        assert win["ms"] > 0 and win["device_ms"] is None and win["iterations"] == 2, name
        assert win["ms_each"] == [pytest.approx(win["ms"])] and win["spread"] == 0.0, name
        assert m["launches_per_iter"] == {}, name  # the CPU runs the plain versions
        assert m.get("max_abs_err", m.get("loss_abs_err")) == 0.0, name
    sparse = detail["extra"]["joseph_sparse_p10_200"]
    assert sparse["rays_per_s"] == pytest.approx(int(S.h200 ** 2 * 0.1) / (sparse["ms"] * 1e-3))


def test_without_a_card_the_cli_measures_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli("--detail", "d.json", cwd=tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert proc.stdout.strip() == "" and os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(smoke=False)


@pytest.fixture(scope="module")
def subjects():
    shape = {False: S.volume, True: S.cube}
    spacing = {False: {}, True: dict(spacing=bench.CUBE_SPACING)}
    return {cube: (T.load_example_ct(shape=shape[cube], device="cpu", **spacing[cube]),
                   jload(shape=shape[cube], **spacing[cube])) for cube in (False, True)}


def _jax_kernel(metric, jd, axis=2):
    # Where the JAX DRR finds no tile plan (the 48^2 detectors), windows
    # wider than the smoke volumes' planes, so that nothing is clipped.
    tile, ky, zw, zc = jd.pallas_cfg[axis] or (16, 128, 256, 128)
    common = dict(image_shape=(jd.detector.height, jd.detector.width), axis=axis, tile=tile,
                  ky=ky, zw=zw, zc=zc, interpret=True, storage=None)
    if metric.renderer == "siddon":
        return partial(siddon_pallas_raycast, **common)
    if metric.renderer == "joseph":
        return partial(joseph_pallas_raycast, step=jd.joseph_steps[axis], **common)
    return partial(raymarch_pallas_raycast, **common, **metric.kw)


@pytest.fixture(scope="module")
def jax_refs(subjects):
    """The JAX kernel's render, and the rotation gradient of its mean, of
    each (renderer, options, detector, volume), computed once: a forward
    metric shares its pose backward's render."""
    cache = {}

    def ref(metric, shapes):
        h, delx = (shapes.h1000, shapes.delx1000) if metric.size == 1000 else (
            shapes.h200, shapes.delx200)
        key = (metric.renderer, tuple(sorted(metric.kw.items())), h, metric.cube)
        if key not in cache:
            jd = JDRR(subjects[metric.cube][1], sdd=bench.SDD, height=h, delx=delx,
                      renderer=metric.renderer)
            fn = _jax_kernel(metric, jd)

            def jrender(jrot):
                src, tgt = jd.detector(jconvert(jrot, jnp.asarray(bench.TRANS), **bench.KW), None)
                w = jnp.linalg.norm(tgt - src, axis=-1)[:, None, :]
                return fn(jd.density, jd.affine_inverse(src), jd.affine_inverse(tgt), w)

            img, pullback = jax.vjp(jrender, jnp.asarray(bench.ROT0, jnp.float32))
            posebwd = any(m.posebwd and (m.renderer, m.kw) == (metric.renderer, metric.kw)
                          for m in bench.METRICS)
            main_200 = (h, metric.cube) == (S.h200, False)
            grad = (pullback(jnp.full_like(img, 1.0 / img.size))[0]
                    if posebwd and main_200 else None)
            cache[key] = (np.asarray(img).reshape(1, 1, h, h), grad)
        return cache[key]

    return ref


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


SPARSE = next(m for m in bench.METRICS if m.p_subsample is not None)
# The sparse metric again on the 96^2 detector of the 1000^2 metric's smoke
# shape: at 48^2 the smoke CT covers ~40 pixels and none of the 230 sampled.
CASES = [(m, S) for m in bench.METRICS] + [
    (SPARSE, dataclasses.replace(S, h200=S.h1000, delx200=S.delx1000))]


@pytest.mark.parametrize("metric, shapes", CASES,
                         ids=[m.name for m in bench.METRICS] + [SPARSE.name + "_96px"])
def test_first_output_matches_jax(subjects, jax_refs, metric, shapes):
    drr = bench.make_drr(metric, subjects[metric.cube][0], shapes, "cpu")
    img, grad = bench.first_output(drr, metric, torch.tensor(bench.ROT0),
                                   torch.tensor(bench.TRANS))
    ref, jgrad = jax_refs(metric, shapes)
    h = drr.detector.height
    assert img.shape == ref.shape == (1, 1, h, h)
    if metric.p_subsample is not None:
        # The JAX detector's seeded draw, and the full frame's render at the
        # sampled pixels, 0 elsewhere.
        sparse = JDRR(subjects[metric.cube][1], sdd=bench.SDD, height=h,
                      delx=drr.detector.delx, renderer=metric.renderer,
                      p_subsample=metric.p_subsample)
        sampled = drr.detector.subsamples[-1]
        assert sampled == sparse.detector.subsamples[-1]
        assert len(sampled) == int(h * h * metric.p_subsample)
        keep = np.zeros(h * h, bool)
        keep[sampled] = True
        ref = np.where(keep.reshape(ref.shape), ref, 0.0)
    assert np.abs(ref).max() > 0 or shapes.h200 == S.h200 and metric is SPARSE
    _close(img, ref, 1e-4)
    if metric.posebwd:
        _close(grad, jgrad, 1e-3)


class _Clock:
    """A host clock that moves only when a fake ``run`` says how long it took."""

    def __init__(self, monkeypatch):
        self.now = 0.0
        monkeypatch.setattr(bench.time, "perf_counter", lambda: self.now)


def test_per_iter_takes_the_k_vs_1_difference_and_counts_iterations(monkeypatch):
    clock = _Clock(monkeypatch)

    def run(rot, k):  # 5 ms of fixed cost, 2 ms an iteration
        clock.now += 0.005 + 0.002 * k
        return rot.sum()

    res = bench.per_iter(run, torch.zeros(1, 3), iters=3, reps=3)
    assert res["n"] == 3 and res["iterations"] == 3 * (2 + 3)
    for key in ("s", "min_s", "max_s"):
        assert res[key] == pytest.approx(0.002)
    assert all(v == 0 for v in res["launches"].values())


def test_per_iter_raises_rather_than_return_an_invalid_time(monkeypatch):
    clock = _Clock(monkeypatch)

    def run(rot, k):  # one iteration takes longer than four
        clock.now += 0.02 if k == 1 else 0.001
        return rot.sum()

    with pytest.raises(RuntimeError, match="unmeasurable"):
        bench.per_iter(run, torch.zeros(1, 3), iters=3, reps=1)


def test_window_is_all_the_iterations_over_all_their_time(monkeypatch):
    clock = _Clock(monkeypatch)
    seen = []

    def run(rot, k):  # 5 ms of fixed cost, 2 ms an iteration, the second window 3
        seen.append(k)
        clock.now += 0.005 + (0.002 if len(seen) == 1 else 0.003) * k
        return rot.sum()

    res = bench.window(run, torch.zeros(1, 3), iters=10, windows=2)
    assert seen == [10, 10] and res["iterations"] == 20 and res["device_s"] is None
    assert res["s"] == pytest.approx((0.025 + 0.035) / 20)
    assert res["windows_s"] == [pytest.approx(0.0025), pytest.approx(0.0035)]
    assert all(v == 0 for v in res["launches"].values())


def test_scaling_record_reports_raw_efficiency_of_each_detector():
    rec = bench_scaling.record({200: 0.002, 1000: 0.010}, {200: 0.004, 1000: 0.002}, 4, 1)
    assert rec["by_height"]["200"]["scaling_efficiency"] == pytest.approx(0.125)
    # Above 1 stays as measured; the record's figure is the largest detector's.
    assert rec["scaling_efficiency"] == rec["by_height"]["1000"]["scaling_efficiency"]
    assert rec["scaling_efficiency"] == pytest.approx(1.25)
    assert rec["by_height"]["1000"]["allgather_bytes_per_step"] == 3_000_000


def test_scaling_on_the_cards_uses_the_harness_ct_and_detectors():
    assert bench_scaling.VOLUME == bench.FULL.volume
    assert bench_scaling.HEIGHTS == (bench.FULL.h200, bench.FULL.h1000)
    if torch.cuda.device_count() < 2:
        assert "skipped" in bench_scaling.scaling("cuda")


@pytest.mark.parametrize("launches, ok", [
    ({"siddon_fwd": 10}, True), ({"siddon_fwd": 9}, False),
    ({"siddon_fwd": 10, "brick_copy": 1}, False), ({"joseph_fwd": 10}, False)])
def test_launches_per_iter_holds_the_exact_counts(launches, ok):
    timing = {"iterations": 10, "launches": dict({"siddon_fwd": 0, "brick_copy": 0}, **launches)}
    if ok:
        assert bench.launches_per_iter(timing, {"siddon_fwd": 1}, "m") == {"siddon_fwd": 1}
    else:
        with pytest.raises(AssertionError, match="launches"):
            bench.launches_per_iter(timing, {"siddon_fwd": 1}, "m")


def test_plain_reference_rebinds_every_wrapper_and_restores_them():
    from diffdrr_tpu_torch.ops.kernels import joseph as J, siddon as K

    with pytest.raises(ValueError):
        with bench.plain_reference():
            for mod in (K, J):
                for fn in mod.KERNELS:
                    assert getattr(mod, fn.__name__) is getattr(mod, fn.__name__ + "_plain")
            raise ValueError
    for mod in (K, J):
        for fn in mod.KERNELS:
            assert getattr(mod, fn.__name__) is fn
