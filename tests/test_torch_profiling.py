"""The port's ``profiling`` against the JAX package's and ``chip_smoke.py``, on the CPU.

``trace`` writes a Chrome trace, ``annotate`` nests, ``render_cost`` marches
the JAX package's axis and steps over the same rays and counts the bytes
and operations ``chip_smoke.py``'s bounds count (exactly: the same roofline
to the last bit), and ``enable_compilation_cache`` moves the kernels' build.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, load_example_ct as jload
from diffdrr_tpu.profiling import render_cost as jrender_cost

from diffdrr_tpu_torch import interop
from diffdrr_tpu_torch.ops.kernels import build
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.ops.kernels.prep import prep_rays
from diffdrr_tpu_torch.pose import convert
from diffdrr_tpu_torch.profiling import annotate, enable_compilation_cache, render_cost, trace

REPO = Path(__file__).resolve().parent.parent
KW = dict(parameterization="euler_angles", convention="ZXY")
ROT = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
TRANS = np.array([[3.0, 401.0, -2.0]], np.float32)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def scene():
    """test_profiling.py's DRR: a 64x64x32 phantom, 32x32 detector, 2 mm."""
    jd = JDRR(jload(shape=(64, 64, 32)), sdd=800.0, height=32, delx=2.0, renderer="joseph")
    return jd, interop.export_state(jd)


def test_trace_writes_profile(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        x = torch.ones((64, 64))
        (x @ x).sum()
    found = [f for _, _, files in os.walk(log_dir) for f in files if f.endswith(".json")]
    assert found, "profiler produced no trace files"
    assert any("aten::mm" in e.name for e in prof.events())


def test_annotate_nests(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("outer"):
            with annotate("inner"):
                out = torch.arange(4.0) * 2.0
    np.testing.assert_allclose(out.numpy(), [0.0, 2.0, 4.0, 6.0])
    spans = {e.name: e.time_range for e in prof.events() if e.name in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    assert spans["outer"].start <= spans["inner"].start <= spans["inner"].end <= spans["outer"].end


@pytest.mark.parametrize("renderer", ["joseph", "siddon"])
def test_render_cost_matches_jax(scene, renderer):
    """rays, axis and n_steps are the JAX package's for the same DRR."""
    jd, state = scene
    jr = JDRR(jd.subject, sdd=800.0, height=32, delx=2.0, renderer=renderer)
    td = interop.drr_from_state(state, device="cpu", renderer=renderer)
    ref, got = jrender_cost(jr), render_cost(td)
    assert (got.rays, got.axis, got.n_steps) == (ref.rays, ref.axis, ref.n_steps) == (
        32 * 32, jr.march_axis, got.n_steps)
    assert got.renderer == renderer and renderer in str(got)
    other = render_cost(td, axis=0)
    assert other.axis == 0 and other.n_steps == jrender_cost(jr, axis=0).n_steps


@pytest.mark.parametrize("renderer", ["siddon", "joseph", "trilinear"])
def test_render_cost_counts_as_chip_smoke(scene, chip_smoke, renderer):
    """On a pose's rays, the bytes and operations are chip_smoke.py's: the
    same roofline, bit for bit, as its bound of siddon_fwd or joseph_fwd;
    without a pose, an upper bound of them."""
    td = interop.drr_from_state(scene[1], device="cpu", renderer=renderer)
    pose = convert(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    rc = render_cost(td, pose=pose)
    src, tgt = td.detector(pose)
    w = torch.linalg.vector_norm(tgt - src, dim=-1)[:, None, :]
    sv, tv = td.affine_inverse(src), td.affine_inverse(tgt)
    ax, X = rc.axis, td.density.shape[rc.axis]
    if renderer == "siddon":
        rows = prep_rays(sv, tv, w, ax, td.density.shape)
        want = chip_smoke.bound(rows, td.density, ax, **chip_smoke.FWD_BOUND)
        # The voxels it counts are those the density gradient reaches.
        g = K.siddon_bwd_vol_plain(rows, torch.ones(rows.shape[1]), td.density.shape, ax)
        assert rc.bytes == 40 * rows.shape[1] + 4 * int(torch.count_nonzero(g))
    else:
        h = float(td.joseph_steps[ax]) if renderer == "joseph" else (X - 1) / (min(500, X) - 1)
        rows = prep_rays(sv, tv, w, ax, td.density.shape, quadrature="joseph", h=h)
        want = chip_smoke.march_bound(rows, td.density, ax, h, rc.n_steps,
                                      **chip_smoke.J_FWD_BOUND)
    assert chip_smoke.roofline(rc.bytes, rc.flops) == want
    assert rc.exact and rc.rays == rows.shape[1]
    most = render_cost(td)
    assert not most.exact and most.bytes >= rc.bytes and most.flops >= rc.flops


def test_enable_compilation_cache(tmp_path):
    saved = build.BUILD_ROOT
    try:
        assert enable_compilation_cache() == str(saved)  # the package's own build
        d = enable_compilation_cache(str(tmp_path / "cache"), min_compile_secs=0.0)
        assert Path(d) == (tmp_path / "cache").resolve() and Path(d).is_dir()
        for name in build.SOURCES:
            assert build._lib_path(name).is_relative_to(d)
    finally:
        build.BUILD_ROOT = saved
