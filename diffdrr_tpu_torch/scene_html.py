"""Interactive 3D scene export to a self-contained HTML file.

Counterpart of ``diffdrr_tpu/scene_html.py``, with its HTML template byte
for byte, so both packages write the same file for the same scene. The
reference's ``visualize_scene`` returns a pyvista Plotter whose scenes ship
as interactive HTML in the tutorials (diffdrr/visualization.py:393-426,
notebooks/tutorials/*.html). This module is the vtk-free equivalent: it
writes ONE standalone .html embedding the scene geometry (base64 raw
buffers) and a ~200-line vanilla-WebGL viewer — orbit / pan / zoom, Lambert
shading, a textured detector plane showing the rendered DRR, and the camera
frustum + principal ray. No external assets, works offline in any browser.

Public API:
    export_scene_html(path, meshes=[...], cameras=[...])   # low-level
    visualize_scene_html(drr, pose, path, ...)             # reference parity
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["export_scene_html", "visualize_scene_html"]


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (accumulated face normals)."""
    n = np.zeros_like(verts, dtype=np.float64)
    p0, p1, p2 = (verts[faces[:, i]].astype(np.float64) for i in range(3))
    fn = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(lens, 1e-30)).astype(np.float32)


def _mesh_payload(mesh, color, opacity):
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.uint32)
    return {
        "type": "mesh",
        "positions": _b64(verts),
        "normals": _b64(_vertex_normals(verts, faces)),
        "indices": _b64(faces),
        "nIndices": int(faces.size),
        "color": list(color),
        "opacity": float(opacity),
    }


def _line_payload(points, color, width=2.0):
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    return {
        "type": "lines",
        "positions": _b64(pts),
        "nPoints": int(len(pts)),
        "color": list(color),
        "width": float(width),
    }


def _image_quad_payload(corners, image, cmap_gray=True):
    """Textured quad: corners (4, 3) in detector order [r0c0, r0cW, rHc0,
    rHcW]; image (H, W) mapped as a luminance texture."""
    img = np.asarray(image, np.float32)
    lo, hi = float(img.min()), float(img.max())
    norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    lum = (norm * 255).astype(np.uint8)
    h, w = lum.shape
    rgba = np.repeat(lum[..., None], 3, axis=-1)
    rgba = np.concatenate([rgba, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return {
        "type": "texquad",
        "corners": _b64(np.asarray(corners, np.float32)),
        "texture": _b64(rgba),
        "texW": int(w),
        "texH": int(h),
    }


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#1a1a1e;
   font-family:system-ui,sans-serif}
 canvas{width:100%;height:100%;display:block}
 #hud{position:fixed;left:10px;bottom:8px;color:#9a9aa2;font-size:12px;
   user-select:none}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; shift-drag / right-drag:
 pan &middot; wheel: zoom</div>
<script>
"use strict";
const SCENE = __SCENE_JSON__;

function buf(b64, T){
  const s = atob(b64), u = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) u[i] = s.charCodeAt(i);
  return new T(u.buffer);
}

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias: true});
const OES = gl.getExtension("OES_element_index_uint");

function sh(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if(!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
function prog(vs, fs){
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(p);
  if(!gl.getProgramParameter(p, gl.LINK_STATUS))
    throw gl.getProgramInfoLog(p);
  return p;
}

const meshProg = prog(
`attribute vec3 aPos; attribute vec3 aNrm;
 uniform mat4 uMVP; uniform mat4 uView;
 varying vec3 vN; varying vec3 vP;
 void main(){ gl_Position = uMVP * vec4(aPos,1.0);
   // GLSL ES 1.00 lacks matrix-from-matrix constructors; the view is
   // rigid, so transforming the normal as a direction is exact.
   vN = (uView * vec4(aNrm, 0.0)).xyz;
   vP = (uView * vec4(aPos,1.0)).xyz; }`,
`precision mediump float;
 varying vec3 vN; varying vec3 vP;
 uniform vec3 uColor; uniform float uOpacity;
 void main(){
   vec3 n = normalize(vN);
   if(!gl_FrontFacing) n = -n;
   vec3 l = normalize(vec3(0.4, 0.7, 1.0));
   float d = max(dot(n, l), 0.0);
   vec3 h = normalize(l + vec3(0.0, 0.0, 1.0));
   float s = pow(max(dot(n, h), 0.0), 24.0) * 0.25;
   vec3 c = uColor * (0.35 + 0.65 * d) + vec3(s);
   gl_FragColor = vec4(c, uOpacity); }`);

const flatProg = prog(
`attribute vec3 aPos; uniform mat4 uMVP;
 void main(){ gl_Position = uMVP * vec4(aPos,1.0); }`,
`precision mediump float; uniform vec3 uColor; uniform float uOpacity;
 void main(){ gl_FragColor = vec4(uColor, uOpacity); }`);

const texProg = prog(
`attribute vec3 aPos; attribute vec2 aUV; uniform mat4 uMVP;
 varying vec2 vUV;
 void main(){ gl_Position = uMVP * vec4(aPos,1.0); vUV = aUV; }`,
`precision mediump float; varying vec2 vUV; uniform sampler2D uTex;
 void main(){ gl_FragColor = texture2D(uTex, vUV); }`);

// ---- build GL objects, accumulate scene bounds ----
let lo = [1e30,1e30,1e30], hi = [-1e30,-1e30,-1e30];
function grow(pos){
  for(let i = 0; i < pos.length; i += 3)
    for(let k = 0; k < 3; k++){
      if(pos[i+k] < lo[k]) lo[k] = pos[i+k];
      if(pos[i+k] > hi[k]) hi[k] = pos[i+k];
    }
}
function vbo(data){
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}
const items = [];
for(const it of SCENE.items){
  if(it.type === "mesh"){
    const pos = buf(it.positions, Float32Array);
    grow(pos);
    const idx = buf(it.indices, Uint32Array);
    const ib = gl.createBuffer();
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, idx, gl.STATIC_DRAW);
    items.push({t:"mesh", pb:vbo(pos), nb:vbo(buf(it.normals, Float32Array)),
                ib, n:it.nIndices, color:it.color, opacity:it.opacity});
  } else if(it.type === "lines"){
    const pos = buf(it.positions, Float32Array);
    grow(pos);
    items.push({t:"lines", pb:vbo(pos), n:it.nPoints, color:it.color,
                width:it.width});
  } else if(it.type === "texquad"){
    const c = buf(it.corners, Float32Array);
    grow(c);
    // corners order: r0c0, r0cW, rHc0, rHcW ; two triangles
    const pos = new Float32Array([
      c[0],c[1],c[2],  c[3],c[4],c[5],  c[6],c[7],c[8],
      c[3],c[4],c[5],  c[9],c[10],c[11], c[6],c[7],c[8]]);
    const uv = new Float32Array([0,0, 1,0, 0,1,  1,0, 1,1, 0,1]);
    const tex = gl.createTexture();
    gl.bindTexture(gl.TEXTURE_2D, tex);
    gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, it.texW, it.texH, 0, gl.RGBA,
                  gl.UNSIGNED_BYTE, buf(it.texture, Uint8Array));
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
    gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
    items.push({t:"tex", pb:vbo(pos), uvb:vbo(uv), tex, n:6});
  }
}
const center = [(lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2];
const radius = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) * 0.75 + 1e-6;

// ---- ground grid ----
(function(){
  const g = [], n = 10, s = radius * 2 / n, y0 = lo[1];
  for(let i = 0; i <= n; i++){
    const x = center[0] - radius + i * s;
    g.push(x, y0, center[2]-radius, x, y0, center[2]+radius);
    const z = center[2] - radius + i * s;
    g.push(center[0]-radius, y0, z, center[0]+radius, y0, z);
  }
  items.unshift({t:"grid", pb:vbo(new Float32Array(g)), n:g.length/3,
                 color:[0.28,0.28,0.32], width:1});
})();

// ---- matrices ----
function mat_mul(a, b){
  const o = new Float32Array(16);
  for(let c = 0; c < 4; c++) for(let r = 0; r < 4; r++){
    let s = 0;
    for(let k = 0; k < 4; k++) s += a[k*4+r] * b[c*4+k];
    o[c*4+r] = s;
  }
  return o;
}
function persp(fov, asp, near, far){
  const f = 1/Math.tan(fov/2), o = new Float32Array(16);
  o[0]=f/asp; o[5]=f; o[10]=(far+near)/(near-far); o[11]=-1;
  o[14]=2*far*near/(near-far);
  return o;
}
let theta = 0.6, phi = 1.1, dist = radius * 2.6,
    pan = [0, 0, 0];
function view(){
  const cx = center[0]+pan[0], cy = center[1]+pan[1], cz = center[2]+pan[2];
  const ex = cx + dist*Math.sin(phi)*Math.cos(theta),
        ey = cy + dist*Math.cos(phi),
        ez = cz + dist*Math.sin(phi)*Math.sin(theta);
  // lookAt
  let zx = ex-cx, zy = ey-cy, zz = ez-cz;
  const zl = Math.hypot(zx,zy,zz); zx/=zl; zy/=zl; zz/=zl;
  let xx = -zz, xy = 0, xz = zx;           // up = (0,1,0) cross z
  const xl = Math.hypot(xx,xy,xz) || 1; xx/=xl; xy/=xl; xz/=xl;
  const yx = zy*xz-zz*xy, yy = zz*xx-zx*xz, yz = zx*xy-zy*xx;
  return new Float32Array([
    xx, yx, zx, 0,  xy, yy, zy, 0,  xz, yz, zz, 0,
    -(xx*ex+xy*ey+xz*ez), -(yx*ex+yy*ey+yz*ez), -(zx*ex+zy*ey+zz*ez), 1]);
}

// ---- input ----
let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY,
          pan: e.shiftKey || e.button === 2};
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if(!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if(drag.pan){
    const v = view(), s = dist * 0.0015;
    pan[0] -= (v[0]*dx - v[1]*dy) * s;
    pan[1] -= (v[4]*dx - v[5]*dy) * s;
    pan[2] -= (v[8]*dx - v[9]*dy) * s;
  } else {
    theta += dx * 0.008;
    phi = Math.min(Math.PI - 0.05, Math.max(0.05, phi - dy * 0.008));
  }
  draw();
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  dist = Math.max(radius * 0.2, Math.min(radius * 20, dist));
  draw();
}, {passive: false});
canvas.addEventListener("contextmenu", e => e.preventDefault());

// ---- draw ----
function draw(){
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if(canvas.width !== w || canvas.height !== h){
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.10, 0.10, 0.12, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const V = view();
  const P = persp(0.9, w/h, radius*0.01, radius*60);
  const MVP = mat_mul(P, V);
  for(const it of items){
    if(it.t === "mesh"){
      gl.useProgram(meshProg);
      gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"uMVP"), false, MVP);
      gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"uView"), false, V);
      gl.uniform3fv(gl.getUniformLocation(meshProg,"uColor"), it.color);
      gl.uniform1f(gl.getUniformLocation(meshProg,"uOpacity"), it.opacity);
      if(it.opacity < 1.0){ gl.enable(gl.BLEND);
        gl.blendFunc(gl.SRC_ALPHA, gl.ONE_MINUS_SRC_ALPHA);
        gl.depthMask(false); }
      const ap = gl.getAttribLocation(meshProg, "aPos");
      gl.bindBuffer(gl.ARRAY_BUFFER, it.pb);
      gl.enableVertexAttribArray(ap);
      gl.vertexAttribPointer(ap, 3, gl.FLOAT, false, 0, 0);
      const an = gl.getAttribLocation(meshProg, "aNrm");
      gl.bindBuffer(gl.ARRAY_BUFFER, it.nb);
      gl.enableVertexAttribArray(an);
      gl.vertexAttribPointer(an, 3, gl.FLOAT, false, 0, 0);
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, it.ib);
      gl.drawElements(gl.TRIANGLES, it.n, gl.UNSIGNED_INT, 0);
      gl.depthMask(true); gl.disable(gl.BLEND);
    } else if(it.t === "lines" || it.t === "grid"){
      gl.useProgram(flatProg);
      gl.uniformMatrix4fv(gl.getUniformLocation(flatProg,"uMVP"), false, MVP);
      gl.uniform3fv(gl.getUniformLocation(flatProg,"uColor"), it.color);
      gl.uniform1f(gl.getUniformLocation(flatProg,"uOpacity"), 1.0);
      const ap = gl.getAttribLocation(flatProg, "aPos");
      gl.bindBuffer(gl.ARRAY_BUFFER, it.pb);
      gl.enableVertexAttribArray(ap);
      gl.vertexAttribPointer(ap, 3, gl.FLOAT, false, 0, 0);
      gl.lineWidth(it.width);
      gl.drawArrays(gl.LINES, 0, it.n);
    } else if(it.t === "tex"){
      gl.useProgram(texProg);
      gl.uniformMatrix4fv(gl.getUniformLocation(texProg,"uMVP"), false, MVP);
      const ap = gl.getAttribLocation(texProg, "aPos");
      gl.bindBuffer(gl.ARRAY_BUFFER, it.pb);
      gl.enableVertexAttribArray(ap);
      gl.vertexAttribPointer(ap, 3, gl.FLOAT, false, 0, 0);
      const au = gl.getAttribLocation(texProg, "aUV");
      gl.bindBuffer(gl.ARRAY_BUFFER, it.uvb);
      gl.enableVertexAttribArray(au);
      gl.vertexAttribPointer(au, 2, gl.FLOAT, false, 0, 0);
      gl.activeTexture(gl.TEXTURE0);
      gl.bindTexture(gl.TEXTURE_2D, it.tex);
      gl.uniform1i(gl.getUniformLocation(texProg,"uTex"), 0);
      gl.drawArrays(gl.TRIANGLES, 0, it.n);
    }
  }
}
window.addEventListener("resize", draw);
draw();
</script></body></html>
"""


def export_scene_html(
    path: Union[str, Path],
    meshes: Sequence = (),
    cameras: Sequence = (),
    title: str = "diffdrr_tpu scene",
) -> Path:
    """Write a standalone interactive HTML scene.

    ``meshes``: ``viz.Mesh`` objects or ``(mesh, color_rgb, opacity)``
    tuples. ``cameras``: dicts with keys ``frustum`` (Mesh), ``ray``
    ((2, 3) world line), and optionally ``corners`` ((4, 3) detector
    corners) + ``image`` ((H, W) DRR) for a textured detector plane.
    """
    items = []
    for m in meshes:
        if isinstance(m, tuple):
            mesh, color, opacity = m
        else:
            mesh, color, opacity = m, (0.76, 0.64, 0.52), 1.0
        items.append(_mesh_payload(mesh, color, opacity))
    for cam in cameras:
        items.append(_mesh_payload(cam["frustum"], (0.35, 0.55, 0.80), 0.25))
        if cam.get("corners") is not None and cam.get("image") is not None:
            items.append(_image_quad_payload(cam["corners"], cam["image"]))
        if cam.get("ray") is not None:
            items.append(_line_payload(cam["ray"], (0.2, 1.0, 0.3), 3.0))
    import html as _html

    html = (_HTML_TEMPLATE
            .replace("__TITLE__", _html.escape(title))
            .replace("__SCENE_JSON__", json.dumps({"items": items})))
    path = Path(path)
    path.write_text(html)
    return path


def visualize_scene_html(
    drr,
    pose,
    path: Union[str, Path],
    labelmap: bool = False,
    labels=None,
    max_faces: int = 200_000,
    texture: bool = True,
    **mesh_kwargs,
) -> Path:
    """Reference ``visualize_scene`` parity as an HTML export.

    Extracts the anatomy mesh (``drr_to_mesh``, or ``labelmap_to_mesh``
    when ``labelmap=True``), renders the DRR at ``pose`` onto the detector
    plane, and writes the standalone viewer. Meshes above ``max_faces``
    are QEM-decimated to keep the file size sane (raw 512^3 CT surfaces
    are tens of MB as base64). The DRR renders on its device, once, and the
    image comes to the host for the texture.
    """
    from . import meshops
    from .viz import drr_to_mesh, img_to_mesh, labelmap_to_mesh

    if labelmap:
        mesh = labelmap_to_mesh(drr.subject, labels if labels is not None
                                else np.arange(1, 100), **mesh_kwargs)
    else:
        mesh = drr_to_mesh(drr.subject, **mesh_kwargs)
    if max_faces and mesh.n_faces > max_faces:
        mesh = meshops.decimate(mesh, 1.0 - max_faces / mesh.n_faces)

    frustum, det, ray = img_to_mesh(drr, pose)
    cam = {"frustum": frustum, "ray": ray}
    if texture and drr.detector.n_subsample is None:
        H, W = drr.detector.height, drr.detector.width
        with torch.no_grad():
            img = drr(pose)[0, 0].cpu().numpy()
        pts = det.reshape(H, W, 3)
        cam["corners"] = np.stack([pts[0, 0], pts[0, -1], pts[-1, 0],
                                   pts[-1, -1]])
        cam["image"] = img
    return export_scene_html(path, meshes=[mesh], cameras=[cam])
