"""Visualization: DRR plots, optimization animations, and mesh extraction.

Counterpart of ``diffdrr_tpu/viz.py`` (the reference's matplotlib/pyvista
layer, diffdrr/visualization.py). Meshing runs on the host: native Surface
Nets and marching cubes (this package's own C++ in ``native/``, through
ctypes, each beside a NumPy route), QEM decimation and NumPy clean-up in
:mod:`meshops`, with the same operations in the same order as the JAX
package, so both give the same meshes. A subject's volume, labelmap and
affine, and a render or the detector's rays, may be CUDA tensors: they come
to the host once, as NumPy arrays, before meshing or plotting. Scenes show
in matplotlib 3D; meshes export to Wavefront OBJ.

matplotlib and imageio are imported only inside the functions that plot or
write a GIF: :func:`animation_frames` renders an animation's frames as NumPy
arrays without either.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .pose import RigidTransform

__all__ = [
    "Mesh",
    "plot_drr",
    "plot_mask",
    "plot_img_and_mask",
    "animate",
    "animation_frames",
    "surface_nets",
    "marching_cubes",
    "drr_to_mesh",
    "labelmap_to_mesh",
    "img_to_mesh",
    "visualize_scene",
    "add_image",
]



def _host(x) -> np.ndarray:
    """``x`` as a NumPy array on the host (a tensor is detached and copied)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# -----------------------------------------------------------------------------
# 2D plots (reference: visualization.py:21-107)
# -----------------------------------------------------------------------------


def plot_drr(
    img,
    title: Optional[Union[str, Sequence[str]]] = None,
    ticks: bool = True,
    axs=None,
    cmap: str = "gray",
    **imshow_kwargs,
):
    """Plot a batch of DRRs side by side (reference: visualization.py:21-56)."""
    import matplotlib.pyplot as plt

    img = _host(img)
    B = img.shape[0]
    if axs is None:
        _, axs = plt.subplots(ncols=B, figsize=(4 * B, 4), squeeze=False)
        axs = axs[0]
    if not isinstance(axs, (list, tuple, np.ndarray)):
        axs = [axs]
    titles = [title] * B if isinstance(title, str) or title is None else title
    for ax, im, t in zip(axs, img, titles):
        ax.imshow(im.squeeze(), cmap=cmap, **imshow_kwargs)
        if t is not None:
            ax.set_title(t)
        if not ticks:
            ax.set_xticks([])
            ax.set_yticks([])
    return axs


def plot_mask(mask_channels, axs=None, alpha: float = 0.625, colors=None):
    """Overlay per-structure channels in color (reference: visualization.py:59-87)."""
    import matplotlib.pyplot as plt
    from matplotlib import colormaps

    mask_channels = _host(mask_channels)
    B, C = mask_channels.shape[:2]
    if axs is None:
        _, axs = plt.subplots(ncols=B, figsize=(4 * B, 4), squeeze=False)
        axs = axs[0]
    if not isinstance(axs, (list, tuple, np.ndarray)):
        axs = [axs]
    cmap = colormaps.get_cmap("tab20")
    for ax, chans in zip(axs, mask_channels):
        H, W = chans.shape[-2:]
        rgba = np.zeros((H, W, 4), np.float32)
        for c in range(1, C):  # skip background channel 0
            m = chans[c] > 0
            color = colors[c] if colors is not None else cmap((c - 1) % 20)
            rgba[m, :3] = np.asarray(color)[:3]
            rgba[m, 3] = alpha
        ax.imshow(rgba)
        ax.set_xticks([])
        ax.set_yticks([])
    return axs


def plot_img_and_mask(img, mask_channels, axs=None, **kwargs):
    """DRR with colored structure overlays (reference: visualization.py:90-107)."""
    axs = plot_drr(img, axs=axs, ticks=False, **kwargs)
    plot_mask(mask_channels, axs=axs)
    return axs


# -----------------------------------------------------------------------------
# Optimization animation (reference: visualization.py:117-190)
# -----------------------------------------------------------------------------


def _trace_rows(df) -> list:
    """The rows of a trace: a DataFrame's (``iterrows``) or a sequence of
    mappings, such as ``csv.DictReader`` gives."""
    if hasattr(df, "iterrows"):
        return [row for _, row in df.iterrows()]
    return list(df)


def animation_frames(
    df,
    drr,
    verbose: bool = False,
    parameterization: str = "euler_angles",
    convention: Optional[str] = "ZXY",
    **rename_map,
) -> list:
    """One DRR per row of an optimization trace, as (H, W) NumPy arrays.

    ``df`` is a pandas DataFrame or a sequence of mappings (``csv.DictReader``
    rows, whose values are strings) holding the rotation and translation
    parameters (default columns r1 r2 r3 tx ty tz, remappable with
    ``rotation_columns=`` and ``translation_columns=``). Each row renders
    once, in order, at its pose as a (1, 3) float32 rotation and translation
    on the DRR's device: the JAX package's ``animate`` loop without the
    figures, so it needs neither matplotlib nor imageio.
    """
    rot_cols = rename_map.get("rotation_columns", ["r1", "r2", "r3"])
    trans_cols = rename_map.get("translation_columns", ["tx", "ty", "tz"])
    rows = _trace_rows(df)
    if verbose:
        try:
            from tqdm import tqdm

            rows = tqdm(rows, desc="Rendering frames")
        except ImportError:
            pass
    frames = []
    for row in rows:
        rot = torch.tensor([[float(row[c]) for c in rot_cols]], dtype=torch.float32,
                           device=drr.device)
        trans = torch.tensor([[float(row[c]) for c in trans_cols]], dtype=torch.float32,
                             device=drr.device)
        with torch.no_grad():
            img = drr(rot, trans, parameterization=parameterization, convention=convention)
        frames.append(_host(img)[0, 0])
    return frames


def animate(
    out: Union[str, Path],
    df,
    drr,
    ground_truth=None,
    verbose: bool = True,
    device=None,
    extension: str = ".gif",
    duration: float = 0.1,
    parameterization: str = "euler_angles",
    convention: Optional[str] = "ZXY",
    **rename_map,
):
    """Render each row of an optimization trace and write a GIF.

    ``df`` is a pandas DataFrame or a sequence of mappings (see
    :func:`animation_frames`, which renders the frames). Matches the
    reference's animate contract (visualization.py:117-190) with imageio as
    the writer. ``device`` is the reference's argument: the frames render
    on the DRR's device.
    """
    del device
    import imageio.v2 as imageio
    import matplotlib.pyplot as plt

    images = animation_frames(df, drr, verbose, parameterization, convention, **rename_map)
    frames = []
    for img in images:
        ncols = 2 if ground_truth is not None else 1
        fig, axs = plt.subplots(ncols=ncols, figsize=(4 * ncols, 4))
        axs = np.atleast_1d(axs)
        axs[0].imshow(img, cmap="gray")
        axs[0].set_title("Moving DRR")
        axs[0].axis("off")
        if ground_truth is not None:
            axs[1].imshow(_host(ground_truth).squeeze(), cmap="gray")
            axs[1].set_title("Fixed X-ray")
            axs[1].axis("off")
        fig.canvas.draw()
        frame = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(frame)
        plt.close(fig)

    out = Path(out).with_suffix(extension)
    imageio.mimsave(out, frames, duration=duration)
    return out


# -----------------------------------------------------------------------------
# Mesh extraction (reference: visualization.py:200-317)
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """Triangle mesh in world coordinates."""

    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int64

    @property
    def n_vertices(self):
        return len(self.vertices)

    @property
    def n_faces(self):
        return len(self.faces)

    def transform(self, affine: np.ndarray) -> "Mesh":
        R, t = affine[:3, :3], affine[:3, 3]
        return Mesh((self.vertices @ R.T + t).astype(np.float32), self.faces)

    def save_obj(self, path: Union[str, Path]) -> None:
        with open(path, "w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for a, b, c in self.faces + 1:
                f.write(f"f {a} {b} {c}\n")


def _surface_nets_numpy(volume: np.ndarray, level: float) -> Mesh:
    """Vectorized NumPy Surface Nets (fallback when g++ is unavailable)."""
    vol = np.asarray(volume, np.float32)
    inside = vol > level
    nx, ny, nz = vol.shape

    # Boundary cells: 2x2x2 corner blocks that straddle the level.
    c = inside
    blocks = (
        c[:-1, :-1, :-1].astype(np.int8)
        + c[1:, :-1, :-1] + c[:-1, 1:, :-1] + c[:-1, :-1, 1:]
        + c[1:, 1:, :-1] + c[1:, :-1, 1:] + c[:-1, 1:, 1:] + c[1:, 1:, 1:]
    )
    boundary = (blocks > 0) & (blocks < 8)
    cell_id = np.full(boundary.shape, -1, np.int64)
    idx = np.nonzero(boundary)
    cell_id[idx] = np.arange(len(idx[0]))

    # Vertex: cell center nudged toward the surface (cheap approximation of
    # the edge-crossing mean; Taubin smoothing recovers the rest).
    verts = np.stack(idx, axis=1).astype(np.float32) + 0.5

    faces = []

    def quads(axis):
        # Edges along `axis` crossing the level, interior only.
        a = inside
        sl0 = [slice(1, -1)] * 3
        sl1 = [slice(1, -1)] * 3
        sl0[axis] = slice(0, -1)
        sl1[axis] = slice(1, None)
        cross = a[tuple(sl0)] != a[tuple(sl1)]
        flip = a[tuple(sl0)][cross]
        xs = np.nonzero(cross)
        # Edge endpoint (x, y, z) in volume coords (offset the interior slice).
        coords = [xs[0].copy(), xs[1].copy(), xs[2].copy()]
        for d in range(3):
            if d != axis:
                coords[d] += 1
        x, y, z = coords
        u, v = [d for d in range(3) if d != axis]

        def cid(dx, dy, dz):
            cc = [x + dx, y + dy, z + dz]
            return cell_id[tuple(cc)]

        offs = [(0, 0), (-1, 0), (-1, -1), (0, -1)]
        ids = []
        for ou, ov in offs:
            d = [0, 0, 0]
            d[u] += ou
            d[v] += ov
            ids.append(cid(*d))
        q = np.stack(ids, axis=1)  # (E, 4) order: (0,0),(-u),( -u,-v),(-v)
        t1 = np.stack([q[:, 0], q[:, 1], q[:, 2]], axis=1)
        t2 = np.stack([q[:, 0], q[:, 2], q[:, 3]], axis=1)
        tris = np.concatenate([t1, t2], axis=0)
        flips = np.concatenate([flip, flip], axis=0)
        tris[flips] = tris[flips][:, ::-1]
        return tris

    for axis in range(3):
        t = quads(axis)
        if len(t):
            faces.append(t)
    faces = np.concatenate(faces, axis=0) if faces else np.zeros((0, 3), np.int64)
    valid = (faces >= 0).all(axis=1)
    return Mesh(verts, faces[valid])


def surface_nets(
    volume: np.ndarray, level: float = 0.5, smooth_iters: int = 10
) -> Mesh:
    """Extract an isosurface mesh with Surface Nets (+ Taubin smoothing).

    Uses the native C++ implementation when it builds (~100x faster than
    the NumPy route on 512^3 volumes; native/surface_nets.cpp), else the
    NumPy route (``native.build.build_errors`` says why).
    """
    from .native import build

    vol = np.ascontiguousarray(_host(volume), np.float32)
    lib = build.load_library("surface_nets")
    if lib is not None:
        build.count("surface_nets")
        out_verts = ctypes.POINTER(ctypes.c_float)()
        out_faces = ctypes.POINTER(ctypes.c_int64)()
        nverts = ctypes.c_int64()
        nfaces = ctypes.c_int64()
        lib.surface_nets(
            vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(vol.shape[0]),
            ctypes.c_int64(vol.shape[1]),
            ctypes.c_int64(vol.shape[2]),
            ctypes.c_float(level),
            ctypes.byref(out_verts),
            ctypes.byref(nverts),
            ctypes.byref(out_faces),
            ctypes.byref(nfaces),
        )
        V, F = nverts.value, nfaces.value
        verts = np.ctypeslib.as_array(out_verts, shape=(V, 3)).copy() if V else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(out_faces, shape=(F, 3)).copy() if F else np.zeros((0, 3), np.int64)
        if smooth_iters and V:
            build.count("taubin_smooth")
            lib.taubin_smooth(
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_int64(V),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(F),
                ctypes.c_int(smooth_iters),
                ctypes.c_float(0.5),
                ctypes.c_float(-0.53),
            )
        lib.sn_free(out_verts)
        lib.sn_free(out_faces)
        return Mesh(verts, faces)

    mesh = _surface_nets_numpy(vol, level)
    if smooth_iters and mesh.n_vertices:
        mesh = _taubin_numpy(mesh, smooth_iters)
    return mesh


def _marching_cubes_numpy(volume: np.ndarray, level: float) -> Mesh:
    """Vectorized NumPy marching cubes (fallback when g++ is unavailable).

    Same constructively-generated 256-case table as the native path
    (native/mc_tables.py); cells are processed grouped by case id.
    """
    from .native.mc_tables import CORNERS, EDGES, tri_table

    vol = np.asarray(volume, np.float32)
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    table = tri_table()
    corners = CORNERS.astype(np.int64)
    inside = vol > level

    case = np.zeros((nx - 1, ny - 1, nz - 1), np.uint16)
    for c in range(8):
        dx, dy, dz = corners[c]
        case |= inside[dx : dx + nx - 1, dy : dy + ny - 1, dz : dz + nz - 1].astype(
            np.uint16
        ) << c
    bx, by, bz = np.nonzero((case != 0) & (case != 255))
    cases = case[bx, by, bz]
    cells = np.stack([bx, by, bz], axis=1)  # (N, 3)
    edge_axis = np.array(
        [int(np.nonzero(corners[a] != corners[b])[0][0]) for a, b in EDGES]
    )

    keys, positions = [], []
    for cval in np.unique(cases):
        sel = cases == cval
        cell = cells[sel]  # (M, 3)
        row = table[cval]
        for e in row[row >= 0]:
            a, b = EDGES[e]
            pa = cell + corners[a]
            pb = cell + corners[b]
            va = vol[pa[:, 0], pa[:, 1], pa[:, 2]]
            vb = vol[pb[:, 0], pb[:, 1], pb[:, 2]]
            t = np.clip((level - va) / (vb - va), 0.0, 1.0)[:, None]
            positions.append(pa + t * (pb - pa))
            lp = cell + np.minimum(corners[a], corners[b])
            keys.append(
                ((lp[:, 0] * ny + lp[:, 1]) * nz + lp[:, 2]) * 3 + edge_axis[e]
            )
    if not keys:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    keys = np.concatenate(keys)
    positions = np.concatenate(positions, axis=0).astype(np.float32)
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    # Triangle entries were appended edge-major per case group, so reshape by
    # gathering in the original (cell, table-slot) order: rebuild the
    # per-triangle layout by interleaving back.
    # Build faces in emission order instead: re-walk the same grouping.
    faces = []
    offset = 0
    for cval in np.unique(cases):
        m = int((cases == cval).sum())
        row = table[cval]
        n_e = int((row >= 0).sum())
        block = inv[offset : offset + m * n_e].reshape(n_e, m)  # slot-major
        faces.append(block.T.reshape(-1, 3))  # (M * n_e/3, 3)
        offset += m * n_e
    faces = np.concatenate(faces, axis=0).astype(np.int64)
    verts = positions[first]
    return Mesh(verts, faces)


def marching_cubes(
    volume: np.ndarray, level: float = 0.5, smooth_iters: int = 0
) -> Mesh:
    """Extract an isosurface mesh with marching cubes.

    The reference's ``method="marching_cubes"`` flavor
    (visualization.py:200-279, via vtk). Vertices lie on volume grid edges
    with linear interpolation — versus Surface Nets' cell-center vertices —
    so no Taubin smoothing is applied by default. The 256-case triangle
    table is generated constructively (see native/mc_tables.py); the native
    C++ marcher (native/marching_cubes.cpp) is used when it builds.
    """
    from .native import build
    from .native.mc_tables import TABLE_STRIDE, tri_table

    vol = np.ascontiguousarray(_host(volume), np.float32)
    table = np.ascontiguousarray(tri_table())
    lib = build.load_library("marching_cubes")
    if lib is not None:
        build.count("marching_cubes")
        out_verts = ctypes.POINTER(ctypes.c_float)()
        out_faces = ctypes.POINTER(ctypes.c_int64)()
        nverts = ctypes.c_int64()
        nfaces = ctypes.c_int64()
        lib.marching_cubes(
            vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(vol.shape[0]),
            ctypes.c_int64(vol.shape[1]),
            ctypes.c_int64(vol.shape[2]),
            ctypes.c_float(level),
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int64(TABLE_STRIDE),
            ctypes.byref(out_verts),
            ctypes.byref(nverts),
            ctypes.byref(out_faces),
            ctypes.byref(nfaces),
        )
        V, F = nverts.value, nfaces.value
        verts = (
            np.ctypeslib.as_array(out_verts, shape=(V, 3)).copy()
            if V
            else np.zeros((0, 3), np.float32)
        )
        faces = (
            np.ctypeslib.as_array(out_faces, shape=(F, 3)).copy()
            if F
            else np.zeros((0, 3), np.int64)
        )
        lib.mc_free(out_verts)
        lib.mc_free(out_faces)
        mesh = Mesh(verts, faces)
    else:
        mesh = _marching_cubes_numpy(vol, level)
    if smooth_iters and mesh.n_vertices:
        mesh = _taubin_numpy(mesh, smooth_iters)
    return mesh


def _taubin_numpy(mesh: Mesh, n_iter: int, lam=0.5, mu=-0.53) -> Mesh:
    verts = mesh.vertices.copy()
    f = mesh.faces
    src = np.concatenate([f[:, 0], f[:, 0], f[:, 1], f[:, 1], f[:, 2], f[:, 2]])
    dst = np.concatenate([f[:, 1], f[:, 2], f[:, 0], f[:, 2], f[:, 0], f[:, 1]])
    deg = np.bincount(src, minlength=len(verts)).astype(np.float32)
    deg = np.maximum(deg, 1)[:, None]
    for it in range(2 * n_iter):
        w = lam if it % 2 == 0 else mu
        acc = np.zeros_like(verts)
        np.add.at(acc, src, verts[dst])
        verts += w * (acc / deg - verts)
    return Mesh(verts, f)


def drr_to_mesh(
    subject,
    method: str = "surface_nets",
    threshold: float = 300.0,
    smooth_iters: Optional[int] = None,
    extract_largest: bool = True,
    decimate_reduction: Optional[float] = None,
    fill_hole_size: float = 100.0,
    verbose: bool = True,
) -> Mesh:
    """CT volume -> bone-surface mesh in world coordinates.

    Reference pipeline (visualization.py:200-279): surface extraction ->
    extract_largest -> smooth -> decimate(0.25, marching_cubes only) ->
    fill_holes(100) -> clean. ``method="surface_nets"`` (the reference's
    recommended flavor for anatomy) runs the native Surface Nets mesher
    with Taubin smoothing; ``method="marching_cubes"`` runs true marching
    cubes (edge-interpolated vertices, native table marcher).

    ``smooth_iters=None`` uses each method's default (10 Taubin iterations
    for Surface Nets, 0 for marching cubes — its vertices are already
    edge-interpolated); an explicit value is honored by both methods.
    ``decimate_reduction=None`` mirrors the reference: 0.25 for marching
    cubes, no decimation for surface nets. Post-processing lives in
    :mod:`meshops` (native QEM decimation + NumPy fill/clean). The volume
    and its affine come to the host once (a CUDA tensor is copied back).
    """
    del verbose
    from . import meshops

    vol = np.asarray(_host(subject.volume.data), np.float32)
    if method == "marching_cubes":
        mesh = marching_cubes(
            vol, threshold, 0 if smooth_iters is None else smooth_iters)
        if decimate_reduction is None:
            decimate_reduction = 0.25
    elif method == "surface_nets":
        mesh = surface_nets(
            vol, threshold, 10 if smooth_iters is None else smooth_iters)
    else:
        raise ValueError(f"unknown mesh method {method!r}")
    if extract_largest and mesh.n_faces:
        mesh = meshops.extract_largest(mesh)
    if decimate_reduction and mesh.n_faces:
        mesh = meshops.decimate(mesh, decimate_reduction)
    if fill_hole_size and mesh.n_faces:
        mesh = meshops.fill_holes(mesh, fill_hole_size)
    mesh = meshops.clean(mesh)
    return mesh.transform(_host(subject.volume.affine))


def labelmap_to_mesh(
    subject,
    labels: Union[int, Sequence[int]],
    smooth_iters: int = 10,
    method: str = "surface_nets",
) -> Mesh:
    """Binary structure mask -> mesh (reference: visualization.py:282-317)."""
    if isinstance(labels, int):
        labels = [labels]
    from . import meshops

    mask = np.isin(_host(subject.mask.data), np.asarray(labels))
    if method == "marching_cubes":
        mesh = marching_cubes(mask.astype(np.float32), 0.5)
    else:
        mesh = surface_nets(mask.astype(np.float32), 0.5, smooth_iters)
    # Reference: smooth_taubin -> clean (visualization.py:301-311).
    mesh = meshops.clean(mesh)
    return mesh.transform(_host(subject.mask.affine))


# -----------------------------------------------------------------------------
# Camera / scene meshes (reference: visualization.py:323-426)
# -----------------------------------------------------------------------------


def img_to_mesh(drr, pose: RigidTransform, calibration=None):
    """Camera frustum + detector-plane geometry for a pose.

    Returns (camera_frustum Mesh, detector vertices (N, 3), principal ray
    line (2, 3)). Reference: visualization.py:323-390. The detector's rays
    are computed on the DRR's device and copied to the host.
    """
    with torch.no_grad():
        source, target = drr.detector(pose, calibration)
    source = _host(source)[0, 0]
    target = _host(target)[0]
    H, W = drr.detector.height, drr.detector.width
    corners = np.stack(
        [
            target[0],
            target[W - 1],
            target[(H - 1) * W],
            target[H * W - 1],
        ]
    )
    verts = np.concatenate([source[None], corners], axis=0).astype(np.float32)
    faces = np.asarray(
        [[0, 1, 2], [0, 2, 4], [0, 4, 3], [0, 3, 1], [1, 3, 2], [2, 3, 4]],
        np.int64,
    )
    frustum = Mesh(verts, faces)
    center = target.mean(axis=0)
    principal_ray = np.stack([source, center]).astype(np.float32)
    return frustum, target.astype(np.float32), principal_ray


def visualize_scene(
    *meshes_and_cameras,
    ax=None,
    max_faces: int = 20000,
):
    """Render meshes + camera frusta in a matplotlib 3D axis.

    pyvista-free analog of the reference's visualize_scene
    (visualization.py:393-426): adequate for orientation checks; export
    meshes with :meth:`Mesh.save_obj` for full-quality external rendering.
    """
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    los, his = [], []
    for item in meshes_and_cameras:
        if isinstance(item, Mesh):
            faces = item.faces
            if len(faces) > max_faces:
                sel = np.random.default_rng(0).choice(
                    len(faces), max_faces, replace=False
                )
                faces = faces[sel]
            tris = item.vertices[faces]
            ax.add_collection3d(
                Poly3DCollection(tris, alpha=0.3, facecolor="tan",
                                 edgecolor="none")
            )
            los.append(item.vertices.min(axis=0))
            his.append(item.vertices.max(axis=0))
        elif isinstance(item, tuple) and len(item) == 3:
            frustum, det, ray = item
            tris = frustum.vertices[frustum.faces]
            ax.add_collection3d(
                Poly3DCollection(tris, alpha=0.15, facecolor="steelblue")
            )
            det = np.asarray(det)
            if len(det):
                stride = max(1, len(det) // 2000)  # keep the plot light
                ax.scatter(*det[::stride].T, s=1, color="steelblue",
                           alpha=0.4)
            ax.plot(*ray.T, color="crimson", lw=1)
            pts = np.concatenate([frustum.vertices, np.atleast_2d(ray)])
            los.append(pts.min(axis=0))
            his.append(pts.max(axis=0))
    if los:
        # One autoscale over EVERY item: a camera-only scene would otherwise
        # keep matplotlib's default [0,1] limits and render blank.
        lo = np.min(los, axis=0)
        hi = np.max(his, axis=0)
        ax.auto_scale_xyz([lo[0], hi[0]], [lo[1], hi[1]], [lo[2], hi[2]])
    return ax


def add_image(drr, pose: RigidTransform, ax, calibration=None,
              texture: bool = True, cmap: str = "gray",
              max_quads: int = 64):
    """Add a camera (frustum + textured detector + principal ray) to an
    existing 3D scene axis — the incremental-add API.

    matplotlib analog of the reference's ``add_image(drr, pose, pl)``
    (visualization.py:420-426): when ``texture=True`` the DRR is rendered
    at ``pose`` and painted onto the detector plane (a ``plot_surface``
    with per-quad facecolors, downsampled to at most ``max_quads`` quads
    per side to keep the axis responsive); ``texture=False`` draws the
    plane as a sparse point cloud like :func:`visualize_scene`.

    Returns ``ax`` (pass it to further ``add_image``/``visualize_scene``
    calls to compose a scene).
    """
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    frustum, det, ray = img_to_mesh(drr, pose, calibration)
    ax.add_collection3d(
        Poly3DCollection(frustum.vertices[frustum.faces], alpha=0.15,
                         facecolor="steelblue")
    )
    H, W = drr.detector.height, drr.detector.width
    textured = texture and drr.detector.n_subsample is None
    if textured:
        with torch.no_grad():
            img = _host(drr(pose, calibration=calibration))[0, 0]
        pts = det.reshape(H, W, 3)
        sr = max(1, H // max_quads)
        sc = max(1, W // max_quads)
        pts = pts[::sr, ::sc]
        img = img[::sr, ::sc]
        lo, hi = float(img.min()), float(img.max())
        norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        colors = plt.get_cmap(cmap)(norm)
        ax.plot_surface(
            pts[..., 0], pts[..., 1], pts[..., 2],
            facecolors=colors, shade=False, rstride=1, cstride=1,
            linewidth=0, antialiased=False,
        )
    else:
        stride = max(1, len(det) // 2000)
        ax.scatter(*det[::stride].T, s=1, color="steelblue", alpha=0.4)
    ax.plot(*ray.T, color="lime", lw=2)

    # Expand (never shrink) the axis bounds to cover the new items.
    pts_all = np.concatenate([frustum.vertices, det, ray], axis=0)
    lo, hi = pts_all.min(axis=0), pts_all.max(axis=0)
    cur = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    if np.allclose(cur, [[0.0, 1.0]] * 3):  # pristine axis: take our bounds
        ax.auto_scale_xyz([lo[0], hi[0]], [lo[1], hi[1]], [lo[2], hi[2]])
    else:
        lo = np.minimum(lo, cur[:, 0])
        hi = np.maximum(hi, cur[:, 1])
        ax.auto_scale_xyz([lo[0], hi[0]], [lo[1], hi[1]], [lo[2], hi[2]])
    return ax
