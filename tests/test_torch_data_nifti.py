"""The port's NIfTI I/O and labelmap ingest against the JAX package.

Files are written into ``tmp_path`` by ``diffdrr_tpu.nifti.save`` (sform),
some then patched to a qform-only or a pixdim-only header, and read by both
packages: arrays and affines must be equal. ``read`` of a labelmap stored in
another orientation than its CT, ``resample_subject`` and
``synthesize_ct_from_labelmap`` run the same NumPy/SciPy arithmetic in both
packages, so their arrays must be equal too (the density by sha256, with the
JAX package's optional C++ HU transfer turned off, as in
``tests/test_torch_data_detector.py``).
"""

import gzip
import hashlib
import struct

import numpy as np
import pandas as pd
import pytest
import torch

import diffdrr_tpu.data as jdata
from diffdrr_tpu import nifti as jnifti

import diffdrr_tpu_torch as T
from diffdrr_tpu_torch import data as tdata
from diffdrr_tpu_torch import nifti as tnifti


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _affine():
    """An oblique affine: rotated about z, anisotropic, with an origin."""
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    A = np.eye(4)
    A[:3, :3] = R * np.array([0.8, 0.9, 2.5])
    A[:3, 3] = [-12.5, 30.25, 7.0]
    return A


def _qform_only(path, pixdim0=-1.0):
    """Rewrite a saved file's header: qform (a rotation about z by 0.3 rad,
    qfac from ``pixdim0``) and no sform."""
    raw = bytearray(path.read_bytes())
    struct.pack_into("<2h", raw, 252, 1, 0)  # qform_code=1, sform_code=0
    struct.pack_into("<f", raw, 76, pixdim0)
    struct.pack_into("<3f", raw, 256, 0.0, 0.0, float(np.sin(0.15)))  # quatern b, c, d
    struct.pack_into("<3f", raw, 268, -12.5, 30.25, 7.0)
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("header", ["sform", "qform", "pixdim"])
def test_nifti_loads_as_in_jax(tmp_path, suffix, header):
    rng = np.random.default_rng(0)
    data = rng.integers(-1000, 1500, (7, 6, 5)).astype(np.int16)
    path = tmp_path / f"vol{suffix}"
    jnifti.save(path, data, _affine())
    if header != "sform":
        plain = tmp_path / "plain.nii"
        jnifti.save(plain, data, _affine())
        if header == "qform":
            _qform_only(plain)
        else:
            raw = bytearray(plain.read_bytes())
            struct.pack_into("<2h", raw, 252, 0, 0)
            plain.write_bytes(bytes(raw))
        raw = plain.read_bytes()
        path.write_bytes(gzip.compress(raw) if suffix == ".nii.gz" else raw)
    ref_data, ref_aff = jnifti.load(path)
    got_data, got_aff = tnifti.load(path)
    assert got_data.dtype == ref_data.dtype == np.int16
    np.testing.assert_array_equal(got_data, ref_data)
    np.testing.assert_array_equal(got_aff, ref_aff)
    np.testing.assert_array_equal(got_data, data)
    if header == "sform":
        np.testing.assert_allclose(got_aff, _affine(), atol=1e-5)
    img = tdata.Image.load(path)
    assert img.orientation == jdata.Image.load(path).orientation


def test_port_save_is_read_back_by_both(tmp_path):
    data = np.random.default_rng(1).uniform(-1, 1, (4, 5, 6)).astype(np.float32)
    path = tmp_path / "x.nii.gz"
    tdata.Image(data, _affine()).save(path)
    for load in (jnifti.load, tnifti.load):
        got, aff = load(path)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_allclose(aff, _affine(), atol=1e-5)


@pytest.mark.parametrize("codes", [("L", "P", "S"), ("A", "R", "I"), ("S", "L", "A")])
def test_orientation_helpers_match_jax(codes):
    start = tnifti.axcodes2ornt(("R", "A", "S"))
    end = tnifti.axcodes2ornt(codes)
    np.testing.assert_array_equal(end, jnifti.axcodes2ornt(codes))
    tf = tnifti.ornt_transform(start, end)
    np.testing.assert_array_equal(tf, jnifti.ornt_transform(start, end))
    arr = np.arange(2 * 3 * 4).reshape(2, 3, 4)
    np.testing.assert_array_equal(tnifti.apply_orientation(arr, tf),
                                  jnifti.apply_orientation(arr, tf))
    A = _affine()[:, [2, 0, 1, 3]] * np.array([1.0, -1.0, 1.0, 1.0])
    assert tnifti.aff2axcodes(A) == jnifti.aff2axcodes(A)
    np.testing.assert_array_equal(tnifti.io_orientation(A), jnifti.io_orientation(A))


@pytest.fixture
def ct_files(tmp_path):
    """The 32x32x16 phantom as NIfTI files: the CT in RAS, its labelmap
    stored flipped in x and y (LPS) with the matching affine."""
    hu, labels = jdata._chest_phantom((32, 32, 16))
    A = np.diag([0.9, 0.8, 2.5, 1.0])
    vol_path, lab_path = tmp_path / "ct.nii.gz", tmp_path / "labels.nii.gz"
    jnifti.save(vol_path, hu, A)
    B = A.copy()
    B[0, 0], B[1, 1] = -0.9, -0.8
    B[:3, 3] = A[:3, :3] @ np.array([31.0, 31.0, 0.0])
    jnifti.save(lab_path, labels[::-1, ::-1], B)
    return vol_path, lab_path, labels


def test_read_reorients_the_labelmap_as_jax(ct_files, monkeypatch):
    monkeypatch.setattr(jdata, "_hu_to_density_native", lambda *a, **k: None)
    vol_path, lab_path, labels = ct_files
    js = jdata.read(vol_path, lab_path, labels=[2, 3, 5])
    ts = tdata.read(str(vol_path), lab_path, labels=[2, 3, 5])
    assert ts.mask.orientation == ("L", "P", "S") and ts.volume.orientation == ("R", "A", "S")
    assert _sha(ts.density.data) == _sha(js.density.data)
    np.testing.assert_array_equal(ts.volume.data, js.volume.data)
    np.testing.assert_array_equal(ts.mask.data, js.mask.data)
    np.testing.assert_array_equal(ts.volume.affine, js.volume.affine)
    np.testing.assert_array_equal(ts.mask.affine, js.mask.affine)
    # The kept voxels are those of the structures 2, 3 and 5, in the CT's frame.
    keep = np.isin(labels, [2, 3, 5])
    assert keep.sum() > 100
    assert np.all(ts.density.data[~keep] == 0) and np.any(ts.density.data[keep] != 0)


def test_resample_subject_matches_jax(ct_files, monkeypatch):
    monkeypatch.setattr(jdata, "_hu_to_density_native", lambda *a, **k: None)
    vol_path, lab_path, _ = ct_files
    js = jdata.read(vol_path, lab_path, resample_target=1.7)
    ts = tdata.read(vol_path, lab_path, resample_target=1.7)
    for a, b in ((ts.volume, js.volume), (ts.density, js.density), (ts.mask, js.mask)):
        assert a.data.dtype == b.data.dtype
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.affine, b.affine)
    assert ts.mask.data.dtype == np.int16 and ts.density.data.shape == (17, 15, 24)


def test_synthesize_ct_from_labelmap_matches_jax():
    _, labels = jdata._chest_phantom((32, 32, 16))
    table = pd.DataFrame([(1, "body"), (2, "lung_left"), (3, "lung_right"), (4, "heart"),
                          (5, "vertebrae_T5"), (6, "rib_left_3")], columns=["id", "structure"])
    ref = jdata.synthesize_ct_from_labelmap(labels, table)
    np.testing.assert_array_equal(tdata.synthesize_ct_from_labelmap(labels, table), ref)
    pairs = list(zip(table["id"], table["structure"]))
    np.testing.assert_array_equal(tdata.synthesize_ct_from_labelmap(labels, pairs), ref)
    np.testing.assert_array_equal(tdata.synthesize_ct_from_labelmap(labels),
                                  jdata.synthesize_ct_from_labelmap(labels))


def test_read_from_files_feeds_a_channel_drr(ct_files):
    """A subject read from files renders its structures on the CPU."""
    vol_path, lab_path, _ = ct_files
    subject = tdata.read(vol_path, lab_path).to("cpu")
    drr = T.DRR(subject, sdd=800.0, height=8, delx=4.0, renderer="joseph", device="cpu")
    assert drr.n_channels == 7
    img = drr(torch.zeros(1, 3), torch.tensor([[0.0, 400.0, 0.0]]),
              parameterization="euler_angles", convention="ZXY", mask_to_channels=True)
    assert img.shape == (1, 7, 8, 8) and float(img[:, 1:].sum()) > 0


def test_read_applies_a_pretransform_as_jax(ct_files, monkeypatch):
    """``transform``: a rigid transform composed onto the CT's affine first."""
    from diffdrr_tpu.pose import convert as jconvert

    from diffdrr_tpu_torch.pose import convert

    monkeypatch.setattr(jdata, "_hu_to_density_native", lambda *a, **k: None)
    vol_path, _, _ = ct_files
    rot = np.array([[0.1, -0.2, 0.3]], np.float32)
    trans = np.array([[5.0, -3.0, 12.0]], np.float32)
    kw = dict(parameterization="euler_angles", convention="ZXY")
    js = jdata.read(vol_path, transform=jconvert(rot, trans, **kw))
    ts = tdata.read(vol_path, transform=convert(torch.tensor(rot), torch.tensor(trans), **kw))
    np.testing.assert_allclose(ts.volume.affine, js.volume.affine, atol=1e-4)
    assert _sha(ts.density.data) == _sha(js.density.data)
