"""The port's mesh post-processing against the JAX package's, on the CPU.

``clean``, ``fill_holes``, ``extract_largest`` and ``decimate`` (the native
QEM core and the pure-Python route) give the JAX package's meshes exactly
on the same inputs: a Surface Nets sphere, the same sphere with a cap cut
off (open boundary loops) and with a small island added. The JAX file's
quality checks (``tests/test_meshops.py``) are carried over on the port:
a decimated sphere stays on the sphere and closed, an open patch keeps its
border and corners, and a reduction outside [0, 1) is refused.
"""

import numpy as np
import pytest

from diffdrr_tpu import meshops as jmeshops
from diffdrr_tpu.viz import Mesh as JMesh

from diffdrr_tpu_torch import meshops
from diffdrr_tpu_torch.viz import Mesh, surface_nets


def sphere_mesh(n=48, r=18.0, smooth=5):
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - (n - 1) / 2
    vol = r - np.sqrt((g**2).sum(0))
    return surface_nets(vol, 0.0, smooth_iters=smooth), (n - 1) / 2, r


def edge_use_counts(faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    return counts


@pytest.fixture(scope="module")
def meshes():
    """Meshes that exercise each operation: a closed sphere, the sphere
    with its top cap cut off (boundary loops), and with a far island and
    duplicate vertices appended."""
    m, c, _ = sphere_mesh(n=24, r=9.0)
    top = m.vertices[m.faces].mean(axis=1)[:, 2] > c + 6.0
    cut = Mesh(m.vertices, m.faces[~top])
    island_v = np.concatenate([m.vertices, m.vertices[:3] + 100.0, m.vertices[:5]])
    island_f = np.concatenate([m.faces, np.array([[0, 1, 2]]) + len(m.vertices),
                               m.faces[:4] % 5 + len(m.vertices) + 3])
    return {"sphere": m, "cut": cut,
            "island": Mesh(island_v.astype(np.float32), island_f.astype(np.int64))}


NAMES = ("cut", "island", "sphere")


def _equal(got, ref):
    assert isinstance(got, Mesh)
    assert got.vertices.dtype == ref.vertices.dtype and got.faces.dtype == ref.faces.dtype
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("op", ["clean", "fill_holes", "extract_largest"])
def test_postprocessing_equals_jax(meshes, op, name):
    m = meshes[name]
    got = getattr(meshops, op)(m)
    ref = getattr(jmeshops, op)(JMesh(m.vertices, m.faces))
    _equal(got, ref)
    if op == "fill_holes" and name == "cut":
        assert got.n_faces > m.n_faces and (edge_use_counts(got.faces) == 2).all()


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", ["sphere", "cut"])
def test_decimate_equals_jax(meshes, name, use_native):
    m = meshes[name]
    got = meshops.decimate(m, 0.5, use_native=use_native)
    ref = jmeshops.decimate(JMesh(m.vertices, m.faces), 0.5, use_native=use_native)
    assert got.n_faces <= int(m.n_faces * 0.5) + 2
    _equal(got, ref)


def test_decimate_native_matches_python_semantics():
    m, c, r = sphere_mesh(n=24, r=9.0)
    a = meshops.decimate(m, 0.5, use_native=True)
    b = meshops.decimate(m, 0.5, use_native=False)
    assert a.n_faces == b.n_faces
    assert a.n_vertices == b.n_vertices
    ra = np.abs(np.linalg.norm(a.vertices - c, axis=1) - r).mean()
    rb = np.abs(np.linalg.norm(b.vertices - c, axis=1) - r).mean()
    assert abs(ra - rb) < 0.02


@pytest.mark.parametrize("use_native", [False, True])
def test_decimate_sphere_quality(use_native):
    m, c, r = sphere_mesh()
    out = meshops.decimate(m, 0.5, use_native=use_native)
    assert out.n_faces <= int(m.n_faces * 0.5) + 2
    assert out.n_faces >= int(m.n_faces * 0.4)  # didn't over-collapse
    rad = np.linalg.norm(out.vertices - c, axis=1)
    assert np.abs(rad - r).mean() < 0.05
    assert np.abs(rad - r).max() < 0.5
    assert (edge_use_counts(out.faces) == 2).all()  # still a closed 2-manifold


@pytest.mark.parametrize("use_native", [False, True])
def test_decimate_preserves_boundary(use_native):
    # Open flat grid patch: the boundary penalty keeps the border frame in
    # place while interior vertices collapse.
    n = 12
    gx, gy = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    v = np.stack([gx.ravel(), gy.ravel(), np.zeros(n * n, np.float32)], 1)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = (i * n + j, i * n + j + 1, (i + 1) * n + j, (i + 1) * n + j + 1)
            f += [(a, b, d), (a, d, c)]
    m = Mesh(v, np.asarray(f, np.int64))
    out = meshops.decimate(m, 0.6, use_native=use_native)
    _equal(out, jmeshops.decimate(JMesh(v, m.faces), 0.6, use_native=use_native))
    assert out.n_faces <= int(m.n_faces * 0.4) + 2
    assert np.abs(out.vertices[:, 2]).max() < 1e-3
    assert out.vertices[:, :2].min() > -0.5
    assert out.vertices[:, :2].max() < n - 0.5
    # The 4 corners are pinned by crossing boundary constraint planes.
    for corner in ([0, 0], [0, n - 1], [n - 1, 0], [n - 1, n - 1]):
        d = np.linalg.norm(out.vertices[:, :2] - corner, axis=1).min()
        assert d < 0.51, corner


@pytest.mark.parametrize("reduction", [1.0, -0.1, 1.5])
def test_decimate_rejects_bad_reduction(reduction):
    m, _, _ = sphere_mesh(n=16, r=6.0, smooth=0)
    with pytest.raises(ValueError, match="reduction must be in"):
        meshops.decimate(m, reduction)


def test_operations_do_not_mutate_and_handle_empty(meshes):
    m = meshes["cut"]
    v, f = m.vertices.copy(), m.faces.copy()
    for op in (meshops.clean, meshops.fill_holes, meshops.extract_largest,
               lambda x: meshops.decimate(x, 0.3)):
        op(m)
        np.testing.assert_array_equal(m.vertices, v)
        np.testing.assert_array_equal(m.faces, f)
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    for op in (meshops.clean, meshops.fill_holes, meshops.extract_largest,
               lambda x: meshops.decimate(x, 0.3)):
        out = op(empty)
        assert out.n_vertices == 0 and out.n_faces == 0
