"""The port's HTML scene export against the JAX package's, on the CPU.

``export_scene_html`` writes the JAX package's file byte for byte for the
same meshes and cameras (the template is the same). ``visualize_scene_html``
over the same example CT and detector gives the same anatomy mesh payload
exactly, its frustum and ray within 1e-3 mm, and its DRR texture within
one 8-bit level (the port's Siddon render is within 1e-3 * max of the JAX
package's sort-based oracle, as ``tests/test_torch_drr_rest.py`` holds it,
and a level is 1/255 of the range). The file is self-contained, as
``tests/test_scene_html.py`` checks.
"""

import base64
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdrr_tpu import DRR as JDRR, convert as jconvert, load_example_ct as jload
from diffdrr_tpu import scene_html as jscene
from diffdrr_tpu.viz import Mesh as JMesh

import diffdrr_tpu_torch as T
from diffdrr_tpu_torch import scene_html
from diffdrr_tpu_torch.ops.kernels import siddon as K
from diffdrr_tpu_torch.pose import convert
from diffdrr_tpu_torch.viz import Mesh

ROT = np.array([[0.0, np.pi / 2, 0.0]], np.float32)
TRANS = np.array([[0.0, 850.0, 0.0]], np.float32)
KW = dict(parameterization="euler_angles", convention="ZXY")


def _scene_json(text):
    m = re.search(r"const SCENE = (\{.*?\});\n", text, re.S)
    assert m, "SCENE payload missing"
    return json.loads(m.group(1))


def _buf(item, key, dtype):
    return np.frombuffer(base64.b64decode(item[key]), dtype)


def _tetra(cls, scale=60.0):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32) * scale
    f = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int64)
    return cls(v, f)


def test_export_scene_html_writes_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.uniform(0.0, 3.0, (8, 6)).astype(np.float32)
    corners = rng.normal(0.0, 100.0, (4, 3)).astype(np.float32)
    ray = np.array([[0, 0, 0], [0, 200, 0]], np.float32)

    def scene(cls, mod, path):
        cams = [{"frustum": _tetra(cls, 30.0), "ray": ray, "corners": corners,
                 "image": image}, {"frustum": _tetra(cls, 20.0)}]
        return mod.export_scene_html(path, meshes=[_tetra(cls), (_tetra(cls, 5.0),
                                                                 (0.1, 0.2, 0.3), 0.5)],
                                     cameras=cams, title="a <scene>")

    got = scene(Mesh, scene_html, tmp_path / "port.html").read_bytes()
    assert got == scene(JMesh, jscene, tmp_path / "jax.html").read_bytes()
    kinds = [it["type"] for it in _scene_json(got.decode())["items"]]
    assert kinds == ["mesh", "mesh", "mesh", "texquad", "lines", "mesh"]
    assert scene_html._HTML_TEMPLATE == jscene._HTML_TEMPLATE


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Both packages' visualize_scene_html over the 64x64x32 example CT, a
    32x32 detector; the port's DRR on its own load_example_ct (HU volume,
    density and affine equal to the JAX package's)."""
    tmp = tmp_path_factory.mktemp("scenes")
    js, ts = jload(shape=(64, 64, 32)), T.load_example_ct(shape=(64, 64, 32), device="cpu")
    np.testing.assert_array_equal(ts.density.data.numpy(), np.asarray(js.density.data))
    jd = JDRR(js, sdd=1020.0, height=32, delx=12.0)
    td = T.DRR(ts, sdd=1020.0, height=32, delx=12.0, device="cpu")
    K.reset_launch_counts()
    got = scene_html.visualize_scene_html(
        td, convert(torch.tensor(ROT), torch.tensor(TRANS), **KW), tmp / "port.html",
        threshold=300.0, max_faces=5000)
    ref = jscene.visualize_scene_html(
        jd, jconvert(jnp.asarray(ROT), jnp.asarray(TRANS), **KW), tmp / "jax.html",
        threshold=300.0, max_faces=5000)
    return _scene_json(got.read_text()), _scene_json(ref.read_text()), got.read_text()


def test_visualize_scene_html_payloads_match_jax(scenes):
    got, ref, _ = scenes
    assert [it["type"] for it in got["items"]] == ["mesh", "mesh", "texquad", "lines"]
    assert [it["type"] for it in ref["items"]] == ["mesh", "mesh", "texquad", "lines"]
    # The anatomy mesh: every key exactly (positions, normals, indices).
    assert got["items"][0] == ref["items"][0]
    assert 0 < got["items"][0]["nIndices"] <= 3 * 5000 + 6
    # The frustum, the detector corners and the ray: within 1e-3 mm.
    for k, key in ((1, "positions"), (2, "corners"), (3, "positions")):
        np.testing.assert_allclose(_buf(got["items"][k], key, np.float32),
                                   _buf(ref["items"][k], key, np.float32), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(_buf(got["items"][1], "indices", np.uint32),
                                  _buf(ref["items"][1], "indices", np.uint32))
    quad, jquad = got["items"][2], ref["items"][2]
    assert (quad["texW"], quad["texH"]) == (jquad["texW"], jquad["texH"]) == (32, 32)
    tex = _buf(quad, "texture", np.uint8).astype(int).reshape(32, 32, 4)
    jtex = _buf(jquad, "texture", np.uint8).astype(int).reshape(32, 32, 4)
    assert tex.max() == 255 and np.abs(tex - jtex).max() <= 1


def test_visualize_scene_html_is_self_contained(scenes):
    text = scenes[2]
    assert not re.search(r'(src|href)\s*=\s*["\']\s*http', text)
    assert "http" not in text.replace("http-equiv", "")
    assert "<script>" in text and "</script>" in text
    for needle in ['getContext("webgl"', "OES_element_index_uint", "drawElements",
                   'addEventListener("wheel"']:
        assert needle in text, needle


def test_visualize_scene_html_texture_is_the_render(tmp_path):
    """The texture is the DRR at the pose, normalized to 8 bits; the
    labelmap scene meshes the structures and draws no texture without one."""
    ts = T.load_example_ct(shape=(48, 48, 24), device="cpu")
    td = T.DRR(ts, sdd=1020.0, height=16, delx=20.0, renderer="trilinear", device="cpu")
    pose = convert(torch.tensor(ROT), torch.tensor(TRANS), **KW)
    img = td(pose)[0, 0].numpy()
    p = scene_html.visualize_scene_html(td, pose, tmp_path / "s.html", threshold=300.0)
    quad = _scene_json(p.read_text())["items"][2]
    lum = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.uint8)
    np.testing.assert_array_equal(_buf(quad, "texture", np.uint8).reshape(16, 16, 4)[..., 0], lum)
    p = scene_html.visualize_scene_html(td, pose, tmp_path / "lab.html", labelmap=True,
                                        texture=False, max_faces=2000)
    items = _scene_json(p.read_text())["items"]
    assert [it["type"] for it in items] == ["mesh", "mesh", "lines"]
    assert 0 < items[0]["nIndices"] <= 3 * 2000 + 6
