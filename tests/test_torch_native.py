"""The port's native C++ components against the JAX package's, on the CPU.

``diffdrr_tpu_torch/native`` builds its own copies of the JAX package's
sources (the same code, the same g++ flags) under the port's ``_build/``.
On the same inputs the two libraries give the same arrays exactly: the
meshers (Surface Nets with and without Taubin smoothing, marching cubes),
QEM decimation, the HU -> density transfer (int16 and float32) and gunzip.
Each native route is held against the port's NumPy route as
``tests/test_viz.py`` and ``tests/test_data.py`` hold the JAX package's:
Surface Nets' vertex count and vertices rounded to the voxel, marching
cubes' vertex set to 1e-4, the HU transfer to 1e-6. A failed build keeps
g++'s message, and each entry point counts its calls.
"""

import gzip

import numpy as np
import pytest

from diffdrr_tpu import data as jdata
from diffdrr_tpu import meshops as jmeshops
from diffdrr_tpu import nifti as jnifti
from diffdrr_tpu import viz as jviz

from diffdrr_tpu_torch import data as tdata
from diffdrr_tpu_torch import meshops, nifti, viz
from diffdrr_tpu_torch.native import build

ROOT = build.SRC.parents[1]


def _sphere(n=24, r=8.0):
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    return (r - np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)).astype(np.float32)


def _equal_mesh(a, b):
    assert a.vertices.dtype == b.vertices.dtype and a.faces.dtype == b.faces.dtype
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """``build`` with nothing loaded, building into ``tmp_path/build``."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_errors", {})
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    return tmp_path


@pytest.mark.parametrize("mesher, smooth", [("surface_nets", 0), ("surface_nets", 10),
                                            ("marching_cubes", 0)])
def test_meshers_equal_jax_native(mesher, smooth):
    vol = _sphere()
    got = getattr(viz, mesher)(vol, 0.0, smooth)
    ref = getattr(jviz, mesher)(vol, 0.0, smooth)
    assert got.n_faces > 100
    _equal_mesh(got, ref)


def test_qem_decimate_equals_jax_native():
    mesh = viz.surface_nets(_sphere(), 0.0, 5)
    target = mesh.n_faces // 2
    got = meshops._decimate_native(mesh.vertices, mesh.faces, target)
    ref = jmeshops._decimate_native(mesh.vertices, mesh.faces, target)
    assert len(got[1]) <= target + 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_hu_to_density_equals_jax_native_and_numpy(dtype, monkeypatch):
    hu = np.random.default_rng(3).uniform(-1200, 2200, (48, 48, 17)).astype(dtype)
    got = tdata._hu_to_density_native(hu, 1.7)
    np.testing.assert_array_equal(got, jdata._hu_to_density_native(hu, 1.7))
    np.testing.assert_array_equal(tdata.transform_hu_to_density(hu, 1.7), got)
    monkeypatch.setattr(tdata, "_hu_to_density_native", lambda *a: None)
    np.testing.assert_allclose(got, tdata.transform_hu_to_density(hu, 1.7), atol=1e-6)
    # All air: no soft-tissue voxel.
    air = np.full((8, 8, 8), -1000.0, np.float32)
    np.testing.assert_array_equal(tdata.transform_hu_to_density(air), np.zeros_like(air))


def test_gunzip_equals_jax_native_and_gzip():
    payload = np.random.default_rng(0).integers(0, 255, 300_000, np.uint8).tobytes()
    raw = gzip.compress(payload[:100_000]) + gzip.compress(payload[100_000:])  # two members
    got = nifti._gunzip_native(raw)
    assert got == jnifti._gunzip_native(raw) == gzip.decompress(raw) == payload
    assert nifti._gunzip_native(raw[:-20]) is None  # truncated


def test_native_routes_match_numpy_routes():
    """As tests/test_viz.py:64-126 requires of the JAX package."""
    vol = _sphere(16, 5.0)
    a = viz._surface_nets_numpy(vol, 0.0)
    b = viz.surface_nets(vol, 0.0, smooth_iters=0)
    assert a.n_vertices == b.n_vertices > 0
    np.testing.assert_allclose(np.sort(a.vertices.round(0), axis=0),
                               np.sort(b.vertices.round(0), axis=0), atol=1.0)
    a = viz._marching_cubes_numpy(vol, 0.0)
    b = viz.marching_cubes(vol, 0.0)
    assert a.n_vertices == b.n_vertices and a.n_faces == b.n_faces > 0
    sa = {tuple(r) for r in np.round(a.vertices.astype(np.float64), 4)}
    sb = {tuple(r) for r in np.round(b.vertices.astype(np.float64), 4)}
    assert sa == sb
    # The NumPy routes equal the JAX package's.
    _equal_mesh(viz._surface_nets_numpy(vol, 0.0), jviz._surface_nets_numpy(vol, 0.0))
    _equal_mesh(viz._marching_cubes_numpy(vol, 0.0), jviz._marching_cubes_numpy(vol, 0.0))


def test_build_reads_the_port_sources_and_writes_under_its_build(fresh_build, monkeypatch):
    home = fresh_build / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("DIFFDRR_TPU_CACHE", str(fresh_build / "jax_cache"))
    port_src = ROOT / "diffdrr_tpu_torch" / "native"
    for name in build.SOURCES:
        cmd = build.command(name, build.lib_path(name))
        sources = [a for a in cmd if a.endswith(".cpp")]
        assert sources == [str(port_src / f"{name}.cpp")]
        assert "diffdrr_tpu/" not in " ".join(cmd).replace("diffdrr_tpu_torch/", "")
    assert build.CXX_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")
    assert build.command("nifti_loader", build.lib_path("nifti_loader"))[-2:] == [
        "-pthread", "-lz"]
    lib = build.load_library("surface_nets")
    assert lib is not None and not build.build_errors
    built = sorted(p.name for p in (fresh_build / "build").iterdir())
    assert built == [build.lib_path("surface_nets").name]
    assert built[0].startswith("surface_nets-") and built[0].endswith(".so")
    assert not home.exists() and not (fresh_build / "jax_cache").exists()
    # The package's own build root is diffdrr_tpu_torch/_build/native.
    assert build.SRC.parent / "_build" / "native" == ROOT / "diffdrr_tpu_torch/_build/native"


def test_failed_build_keeps_gcc_message(fresh_build, monkeypatch):
    src = fresh_build / "src"
    src.mkdir()
    for name in build.SOURCES:
        (src / f"{name}.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(build, "SRC", src)
    build.reset_call_counts()
    assert build.load_library("surface_nets") is None
    assert "error" in build.build_errors["surface_nets"]
    with pytest.raises(RuntimeError, match=r"(?s)native decimate unavailable: .*error: "):
        meshops.decimate(viz._surface_nets_numpy(_sphere(12, 4.0), 0.0), 0.5,
                         use_native=True)
    # The NumPy routes still run, and no native call is counted.
    vol = _sphere(12, 4.0)
    _equal_mesh(viz.surface_nets(vol, 0.0, 2),
                viz._taubin_numpy(viz._surface_nets_numpy(vol, 0.0), 2))
    assert viz.marching_cubes(vol, 0.0).n_faces > 0
    assert sum(build.call_counts().values()) == 0
    assert not list((fresh_build / "build").glob("*.so"))


def test_counters_count_native_calls_only():
    vol = _sphere(12, 4.0)
    build.reset_call_counts()
    viz._surface_nets_numpy(vol, 0.0)
    viz._marching_cubes_numpy(vol, 0.0)
    assert sum(build.call_counts().values()) == 0
    mesh = viz.surface_nets(vol, 0.0, 3)
    viz.surface_nets(vol, 0.0, 0)
    viz.marching_cubes(vol, 0.0)
    meshops.decimate(mesh, 0.5)
    meshops.decimate(mesh, 0.5, use_native=False)
    tdata.transform_hu_to_density(np.full((4, 4, 4), 100.0, np.float32))
    nifti._gunzip_native(gzip.compress(b"x" * 100))
    assert build.call_counts() == {"surface_nets": 2, "taubin_smooth": 1, "marching_cubes": 1,
                                   "qem_decimate": 1, "hu_to_density": 1, "gunzip": 1}
    build.reset_call_counts()
    assert sum(build.call_counts().values()) == 0
