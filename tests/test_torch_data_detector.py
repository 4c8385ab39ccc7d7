"""The port's CT ingest and detector against the JAX package.

``load_example_ct`` builds the same procedural phantom with the same float32
NumPy arithmetic, so its density must be byte-identical to the JAX
package's NumPy path (sha256). The JAX package's default path may take its
native C++ HU transfer instead, which may round differently: that one is
held to 1 ulp. Detector rays are compared at atol 1e-4 mm on O(1000 mm)
coordinates (float32 einsums in both packages).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffdrr_tpu.data as jdata
from diffdrr_tpu import DRR as JDRR, convert as jconvert
import diffdrr_tpu_torch as T
from diffdrr_tpu_torch import interop

SHAPE = (64, 64, 32)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def subjects():
    return jdata.load_example_ct(shape=SHAPE), T.load_example_ct(shape=SHAPE, device="cpu")


def test_example_ct_density_matches_numpy_path_bytes(monkeypatch):
    # Both packages' NumPy routes (each tries its native transfer first).
    monkeypatch.setattr(jdata, "_hu_to_density_native", lambda *a, **k: None)
    monkeypatch.setattr(T.data, "_hu_to_density_native", lambda *a, **k: None)
    hu, _ = jdata._chest_phantom(SHAPE)
    ref = jdata.transform_hu_to_density(hu)
    port = T.load_example_ct(shape=SHAPE, device="cpu").density.data
    assert port.dtype == torch.float32 and port.device.type == "cpu"
    assert _sha(port.numpy()) == _sha(ref)


def test_example_ct_matches_jax_subject(subjects):
    js, ts = subjects
    ref = np.asarray(js.density.data, np.float32)
    got = ts.density.data.numpy()
    ulp = np.spacing(np.maximum(np.abs(ref), np.abs(got)))
    assert np.all(np.abs(got - ref) <= ulp)
    np.testing.assert_array_equal(ts.volume.affine, js.volume.affine)
    np.testing.assert_array_equal(ts.reorient, js.reorient)
    np.testing.assert_array_equal(ts.mask.data.numpy(), np.asarray(js.mask.data))
    np.testing.assert_allclose(ts.fiducials, js.fiducials, rtol=1e-6)
    assert [n for _, n in ts.structures] == list(js.structures["name"])


@pytest.mark.parametrize("height,width", [(32, 32), (31, 27), (16, 21)])
def test_detector_rays_match(subjects, height, width):
    js, _ = subjects
    jd = JDRR(js, sdd=800.0, height=height, width=width, delx=2.0, dely=2.5,
              x0=3.0, y0=-1.5)
    td = interop.drr_from_state(interop.export_state(jd), device="cpu")
    rot = np.array([[0.013, np.pi / 2 + 0.017, -0.011]], np.float32)
    trans = np.array([[3.0, 401.0, -2.0]], np.float32)
    js_src, js_tgt = jd.detector(jconvert(jnp.asarray(rot), jnp.asarray(trans),
                                          parameterization="euler_angles", convention="ZXY"))
    ts_src, ts_tgt = td.detector(T.convert(torch.tensor(rot), torch.tensor(trans),
                                           parameterization="euler_angles", convention="ZXY"))
    np.testing.assert_allclose(ts_src, np.asarray(js_src), atol=1e-4)
    np.testing.assert_allclose(ts_tgt, np.asarray(js_tgt), atol=1e-4)
    np.testing.assert_allclose(td.detector.intrinsic, np.asarray(jd.detector.intrinsic),
                               rtol=1e-6)
    assert (td.detector.x0, td.detector.y0) == (jd.detector.x0, jd.detector.y0)


def test_canonical_plane_is_centred_for_odd_sizes():
    from diffdrr_tpu_torch.detector import _canonical_plane

    for h, w in ((5, 7), (4, 6), (1, 3)):
        _, tgt = _canonical_plane(h, w, reverse_x_axis=False)
        np.testing.assert_allclose(tgt[0, :, :2].mean(axis=0), 0.0, atol=1e-6)
