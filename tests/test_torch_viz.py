"""The port's ``viz`` against the JAX package's, on the CPU.

``drr_to_mesh`` (Surface Nets and marching cubes, ``smooth_iters``
honoured) and ``labelmap_to_mesh`` give the JAX package's meshes exactly:
the same example CT from each package's ``load_example_ct`` (HU volume,
affine and labelmap equal), and the labelmap also through
``export_state``/``drr_from_state``, where the port holds it as a tensor.
``img_to_mesh`` is within 1e-3 mm of the JAX package's frustum, detector
points and principal ray (coordinates ~1000 mm, where a float32 ulp is
6e-5). ``animate``'s frames are the DRR's renders at each row: on the
oracles (``force_xla=True``, trilinear as ``experiments/gif.py`` renders)
within 1e-5 * max of the JAX DRR's, the tolerance of
``tests/test_torch_drr_joseph.py`` for oracle renders, and on the kernel
path equal to a direct render; the GIF has one frame per row, from a
DataFrame and from ``csv.DictReader`` rows. The plots, ``visualize_scene``
(a camera alone autoscales) and ``add_image`` run under Agg.
"""

import csv
import io

import matplotlib

matplotlib.use("Agg")

import imageio.v2 as imageio
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu import viz as jviz

import diffdrr_tpu_torch as T
from diffdrr_tpu_torch import interop, viz
from diffdrr_tpu_torch.native import build
from diffdrr_tpu_torch.pose import convert

SHAPE = (48, 48, 24)
ROT = np.array([[0.0, np.pi / 2, 0.0]], np.float32)
TRANS = np.array([[0.0, 300.0, 0.0]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")
TRACE = {"r1": [0.0, 0.01, 0.02], "r2": [np.pi / 2, np.pi / 2 + 0.01, np.pi / 2 - 0.01],
         "r3": [0.0, 0.0, 0.005], "tx": [0.0, 1.0, -2.0], "ty": [300.0, 300.0, 302.5],
         "tz": [0.0, 0.0, 1.5]}


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-12), rtol=0)


def _equal(got, ref):
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)


@pytest.fixture(scope="module")
def subjects():
    js, ts = jload(shape=SHAPE), T.load_example_ct(shape=SHAPE, device="cpu")
    np.testing.assert_array_equal(ts.volume.data, js.volume.data)
    np.testing.assert_array_equal(ts.volume.affine, js.volume.affine)
    return js, ts


@pytest.fixture(scope="module")
def drrs(subjects):
    """The JAX DRR (siddon, 16x16) and the port's built from its state."""
    jd = JDRR(subjects[0], sdd=600.0, height=16, delx=4.0)
    return jd, interop.drr_from_state(interop.export_state(jd), device="cpu")


@pytest.mark.parametrize("method, smooth", [("surface_nets", None), ("surface_nets", 2),
                                            ("marching_cubes", None), ("marching_cubes", 5)])
def test_drr_to_mesh_equals_jax(subjects, method, smooth):
    js, ts = subjects
    build.reset_call_counts()
    got = viz.drr_to_mesh(ts, method=method, threshold=300.0, smooth_iters=smooth)
    _equal(got, jviz.drr_to_mesh(js, method=method, threshold=300.0, smooth_iters=smooth))
    assert got.n_faces > 0
    counts = build.call_counts()
    assert counts[method] == 1
    assert counts["qem_decimate"] == (method == "marching_cubes")
    (xmin, xmax), _, _ = ts.volume.get_bounds()
    assert xmin - 1 <= got.vertices[:, 0].min() and got.vertices[:, 0].max() <= xmax + 1


def test_drr_to_mesh_smooth_iters_honoured_and_bad_method(subjects):
    _, ts = subjects
    m0 = viz.drr_to_mesh(ts, method="marching_cubes", threshold=300.0, smooth_iters=0)
    m5 = viz.drr_to_mesh(ts, method="marching_cubes", threshold=300.0, smooth_iters=5)
    assert m0.n_vertices == m5.n_vertices
    assert not np.allclose(m0.vertices, m5.vertices)
    with pytest.raises(ValueError, match="unknown mesh method"):
        viz.drr_to_mesh(ts, method="bogus")


def test_drr_to_mesh_takes_a_tensor_volume(subjects):
    _, ts = subjects
    ref = viz.drr_to_mesh(ts, threshold=300.0)
    vol = ts.volume.data
    try:
        ts.volume.data = torch.as_tensor(vol)
        _equal(viz.drr_to_mesh(ts, threshold=300.0), ref)
    finally:
        ts.volume.data = vol


@pytest.mark.parametrize("labels, method, smooth", [
    (4, "surface_nets", 2), ([2, 3], "surface_nets", 10), (5, "marching_cubes", 10)])
def test_labelmap_to_mesh_equals_jax(subjects, drrs, labels, method, smooth):
    js, ts = subjects
    ref = jviz.labelmap_to_mesh(js, labels, smooth_iters=smooth, method=method)
    _equal(viz.labelmap_to_mesh(ts, labels, smooth_iters=smooth, method=method), ref)
    # Through the exported state the labelmap is a tensor on the device.
    state_subject = drrs[1].subject
    assert torch.is_tensor(state_subject.mask.data)
    _equal(viz.labelmap_to_mesh(state_subject, labels, smooth_iters=smooth, method=method), ref)


def test_mesh_transform_and_save_obj(subjects, tmp_path):
    _, ts = subjects
    mesh = viz.labelmap_to_mesh(ts, labels=5, smooth_iters=0)
    out = tmp_path / "spine.obj"
    mesh.save_obj(out)
    text = out.read_text()
    assert text.count("\nf ") + text.startswith("f ") == mesh.n_faces
    assert text.count("v ") == mesh.n_vertices
    shift = np.eye(4)
    shift[:3, 3] = [1.0, -2.0, 3.0]
    np.testing.assert_allclose(mesh.transform(shift).vertices, mesh.vertices + [1.0, -2.0, 3.0],
                               atol=1e-4)


def test_img_to_mesh_within_1e_3_mm_of_jax(drrs):
    jd, td = drrs
    jf, jdet, jray = jviz.img_to_mesh(jd, jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW))
    tf, tdet, tray = viz.img_to_mesh(td, convert(torch.tensor(ROT), torch.tensor(TRANS), **KW))
    np.testing.assert_array_equal(tf.faces, jf.faces)
    for got, ref in ((tf.vertices, jf.vertices), (tdet, jdet), (tray, jray)):
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert tf.n_vertices == 5 and np.array_equal(tf.vertices[0], tray[0])  # apex == source


def _trace_rows(kind):
    df = pd.DataFrame(TRACE)
    if kind == "dataframe":
        return df
    buf = io.StringIO()
    df.to_csv(buf, index=False)
    return list(csv.DictReader(io.StringIO(buf.getvalue())))


@pytest.mark.parametrize("kind", ["dataframe", "dictreader"])
def test_animation_frames_match_jax_renders(subjects, kind):
    jd = JDRR(subjects[0], sdd=600.0, height=16, delx=4.0, renderer="trilinear")
    td = interop.drr_from_state(interop.export_state(jd), device="cpu",
                                renderer="trilinear", force_xla=True)
    frames = viz.animation_frames(_trace_rows(kind), td)
    assert len(frames) == 3
    for k, frame in enumerate(frames):
        rot = jnp.asarray([[TRACE[c][k] for c in ("r1", "r2", "r3")]], jnp.float32)
        trans = jnp.asarray([[TRACE[c][k] for c in ("tx", "ty", "tz")]], jnp.float32)
        assert frame.shape == (16, 16) and frame.dtype == np.float32
        _close(frame, np.asarray(jd(rot, trans, **KW))[0, 0], 1e-5)


def test_animation_frames_equal_direct_renders(drrs):
    td = interop.drr_from_state(interop.export_state(drrs[0]), device="cpu",
                                renderer="trilinear")
    frames = viz.animation_frames(_trace_rows("dictreader"), td,
                                  rotation_columns=["r1", "r2", "r3"])
    for k, frame in enumerate(frames):
        rot = torch.tensor([[TRACE[c][k] for c in ("r1", "r2", "r3")]], dtype=torch.float32)
        trans = torch.tensor([[TRACE[c][k] for c in ("tx", "ty", "tz")]], dtype=torch.float32)
        np.testing.assert_array_equal(frame, td(rot, trans, **KW)[0, 0].numpy())


@pytest.mark.parametrize("kind", ["dataframe", "dictreader"])
def test_animate_writes_one_frame_per_row(drrs, tmp_path, kind):
    _, td = drrs
    gt = td(torch.tensor(ROT), torch.tensor(TRANS), **KW)[0, 0]
    out = viz.animate(tmp_path / "run", _trace_rows(kind), td, ground_truth=gt, verbose=False)
    assert out == tmp_path / "run.gif" and out.stat().st_size > 1000
    assert len(imageio.mimread(out)) == 3


def test_plot_functions(drrs):
    _, td = drrs
    img = td(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    chans = td(torch.tensor(ROT), torch.tensor(TRANS), mask_to_channels=True, **KW)
    assert len(viz.plot_drr(img, title="test")) == 1
    assert len(viz.plot_drr(torch.cat([img, img]), title=["a", "b"], ticks=False)) == 2
    assert len(viz.plot_mask(chans)) == 1
    viz.plot_img_and_mask(img, chans)
    plt.close("all")


def test_visualize_scene_camera_only_autoscales(subjects, drrs):
    _, ts = subjects
    _, td = drrs
    pose = convert(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    frustum, det, ray = viz.img_to_mesh(td, pose)
    ax = viz.visualize_scene((frustum, det, ray))
    lo, hi = ax.get_xlim3d()
    span = frustum.vertices
    assert hi - lo > 0.5 * (span[:, 0].max() - span[:, 0].min())
    mesh = viz.labelmap_to_mesh(ts, labels=5, smooth_iters=0)
    assert viz.visualize_scene(mesh, (frustum, det, ray), max_faces=100) is not None
    plt.close("all")


def test_add_image_composes_scene(subjects):
    _, ts = subjects
    td = T.DRR(ts, sdd=800.0, height=16, delx=8.0, device="cpu")
    pose = convert(torch.tensor(ROT), torch.tensor([[0.0, 400.0, 0.0]]), **KW)
    ax = viz.visualize_scene(viz.drr_to_mesh(ts, threshold=300.0))
    n_before = len(ax.collections) + len(ax.lines)
    ax = viz.add_image(td, pose, ax)
    assert len(ax.collections) + len(ax.lines) > n_before
    src = td.detector(pose, None)[0][0, 0].numpy()
    for c, (lo, hi) in zip(src, (ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d())):
        assert lo - 1e-3 <= c <= hi + 1e-3
    pose2 = convert(torch.tensor([[0.3, np.pi / 2, 0.2]]), torch.tensor([[10.0, 380.0, -5.0]]),
                    **KW)
    viz.add_image(td, pose2, ax, texture=False)
    plt.close("all")
