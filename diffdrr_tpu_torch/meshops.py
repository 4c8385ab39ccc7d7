"""Mesh post-processing: clean / fill_holes / decimate / extract_largest.

Counterpart of ``diffdrr_tpu/meshops.py``, on the host in NumPy and SciPy
with the same operations in the same order, so both packages give the same
meshes. The reference's ``drr_to_mesh`` pipeline is extract_largest ->
smooth -> decimate_pro(0.25) -> fill_holes(100) -> clean
(diffdrr/visualization.py:246-279, via pyvista/vtk). Decimation is
quadric-error-metric edge collapse (Garland & Heckbert, SIGGRAPH '97) with
a C++ core (``native/decimate.cpp``, this package's own copy) and a
pure-Python route of the same algorithm; the rest is vectorized NumPy.

All functions take and return ``viz.Mesh`` and never mutate their input.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["clean", "fill_holes", "decimate", "extract_largest"]


def _mesh_cls():
    from .viz import Mesh

    return Mesh


# -----------------------------------------------------------------------------
# clean (reference: mesh.clean() — vtkCleanPolyData)
# -----------------------------------------------------------------------------


def clean(mesh, tol: float = 0.0):
    """Merge coincident vertices, drop degenerate faces and unused vertices.

    ``tol``: absolute merge tolerance; 0 merges exactly-equal coordinates
    (vtkCleanPolyData's default is point-exact merging too).
    """
    Mesh = _mesh_cls()
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int64)
    if len(verts) == 0:
        return Mesh(verts.reshape(0, 3), faces.reshape(0, 3))

    key = verts if tol == 0.0 else np.round(verts / tol)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    # Representative = the first occurrence (keeps exact float coords).
    verts_m = verts[first]
    faces_m = inv[faces] if len(faces) else faces

    if len(faces_m):
        a, b, c = faces_m[:, 0], faces_m[:, 1], faces_m[:, 2]
        keep = (a != b) & (b != c) & (a != c)
        faces_m = faces_m[keep]

    # Drop unused vertices, remap faces.
    used = np.zeros(len(verts_m), bool)
    if len(faces_m):
        used[faces_m] = True
    remap = np.cumsum(used) - 1
    return Mesh(verts_m[used].astype(np.float32),
                remap[faces_m].astype(np.int64) if len(faces_m)
                else faces_m.reshape(0, 3))


# -----------------------------------------------------------------------------
# connected components (reference: mesh.extract_largest() — vtkConnectivity)
# -----------------------------------------------------------------------------


def _vertex_components(n_verts: int, faces: np.ndarray) -> np.ndarray:
    """Component labels over vertices connected by faces.

    Sparse-graph connected components (scipy csgraph): the raw surfaces this
    feeds on (512^3 CT extractions) reach millions of faces, where the old
    pure-Python union-find loop took minutes before decimation even started.
    """
    from scipy import sparse
    from scipy.sparse.csgraph import connected_components

    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    g = sparse.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(n_verts, n_verts))
    _, labels = connected_components(g, directed=False)
    return labels


def extract_largest(mesh):
    """Keep only the largest connected component (by face count)."""
    Mesh = _mesh_cls()
    faces = np.asarray(mesh.faces, np.int64)
    if len(faces) == 0:
        return clean(mesh)
    labels = _vertex_components(len(mesh.vertices), faces)
    face_label = labels[faces[:, 0]]
    uniq, counts = np.unique(face_label, return_counts=True)
    best = uniq[np.argmax(counts)]
    out = Mesh(np.asarray(mesh.vertices, np.float32), faces[face_label == best])
    return clean(out)  # drop the other components' vertices


# -----------------------------------------------------------------------------
# fill_holes (reference: mesh.fill_holes(100) — vtkFillHolesFilter)
# -----------------------------------------------------------------------------


def _boundary_loops(faces: np.ndarray):
    """Ordered boundary loops. Boundary edge = used by exactly one face.

    Each directed boundary edge (a, b) appears in its face as a->b; walking
    successor edges b->c chains them into loops. Non-manifold junctions
    (a vertex with >1 outgoing boundary edge) are resolved greedily; broken
    chains are dropped (mirrors vtkFillHolesFilter, which also only fills
    closed loops).
    """
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    und = np.sort(edges, axis=1)
    _, inv, counts = np.unique(und, axis=0, return_inverse=True,
                               return_counts=True)
    boundary = edges[counts[inv] == 1]
    nxt = {}
    for a, b in boundary:
        nxt.setdefault(int(a), []).append(int(b))
    loops = []
    seen = set()
    for a0, _ in ((int(a), int(b)) for a, b in boundary):
        if a0 in seen:
            continue
        loop = [a0]
        seen.add(a0)
        cur = a0
        ok = False
        while True:
            outs = nxt.get(cur, [])
            step = next((v for v in outs if v not in seen), None)
            if step is None:
                ok = loop[0] in outs and len(loop) >= 3  # closes the loop
                break
            loop.append(step)
            seen.add(step)
            cur = step
        if ok:
            loops.append(loop)
    return loops


def fill_holes(mesh, hole_size: float = 100.0):
    """Triangulate boundary loops whose circumradius is <= ``hole_size``.

    ``hole_size`` is "the radius of the bounding circumsphere of the hole"
    (vtkFillHolesFilter's SetHoleSize semantics). Holes are closed with a
    centroid fan — one added vertex per hole — with winding opposite the
    boundary edges so orientation stays consistent with the surrounding
    surface. (vtk ear-clips instead; the fan is a deliberate simplification
    that is robust on the near-planar holes surface extraction leaves.)
    """
    Mesh = _mesh_cls()
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int64)
    if len(faces) == 0:
        return Mesh(verts.copy(), faces.copy())
    new_verts, new_faces = [], []
    for loop in _boundary_loops(faces):
        pts = verts[np.asarray(loop)]
        centroid = pts.mean(axis=0)
        radius = float(np.linalg.norm(pts - centroid, axis=1).max())
        if radius > hole_size:
            continue
        ci = len(verts) + len(new_verts)
        new_verts.append(centroid)
        # Boundary edges run a->b; cap triangles run b->a seen from the
        # new centroid, i.e. (b, a, centroid).
        for a, b in zip(loop, loop[1:] + loop[:1]):
            new_faces.append((b, a, ci))
    if not new_faces:
        return Mesh(verts.copy(), faces.copy())
    return Mesh(
        np.concatenate([verts, np.asarray(new_verts, np.float32)]),
        np.concatenate([faces, np.asarray(new_faces, np.int64)]),
    )


# -----------------------------------------------------------------------------
# decimate (reference: mesh.decimate_pro(0.25) — vtkDecimatePro)
# -----------------------------------------------------------------------------


def decimate(mesh, reduction: float = 0.25, use_native: bool | None = None):
    """Quadric edge-collapse decimation to ``(1 - reduction) * n_faces``.

    Garland-Heckbert quadrics with boundary-constraint planes and a
    normal-flip rejection test; collapses run through a lazy min-heap.
    ``use_native=None`` tries the C++ core first (the pure-Python path is
    ~100x slower on the million-face meshes a 512^3 CT produces).
    """
    if not 0.0 <= reduction < 1.0:
        raise ValueError(f"reduction must be in [0, 1), got {reduction}")
    Mesh = _mesh_cls()
    verts = np.ascontiguousarray(mesh.vertices, np.float32)
    faces = np.ascontiguousarray(mesh.faces, np.int64)
    target = int(round(len(faces) * (1.0 - reduction)))
    if len(faces) == 0 or target >= len(faces):
        return Mesh(verts.copy(), faces.copy())

    if use_native is not False:
        out = _decimate_native(verts, faces, target)
        if out is not None:
            return clean(Mesh(*out))
        if use_native is True:
            from .native import require

            require("decimate")  # raises with g++'s message
            raise RuntimeError("native decimate failed")
    v, f = _decimate_python(verts, faces, target)
    return clean(Mesh(v, f))


def _decimate_native(verts, faces, target):
    import ctypes

    from .native import build

    lib = build.load_library("decimate")
    if lib is None:
        return None
    build.count("qem_decimate")
    ov = ctypes.POINTER(ctypes.c_float)()
    of = ctypes.POINTER(ctypes.c_int64)()
    onv = ctypes.c_int64()
    onf = ctypes.c_int64()
    rc = lib.qem_decimate(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(faces),
        target, ctypes.byref(ov), ctypes.byref(onv), ctypes.byref(of),
        ctypes.byref(onf))
    if rc != 0:
        return None
    nv, nf = onv.value, onf.value
    v = (np.ctypeslib.as_array(ov, shape=(nv, 3)).copy()
         if nv else np.zeros((0, 3), np.float32))
    f = (np.ctypeslib.as_array(of, shape=(nf, 3)).copy()
         if nf else np.zeros((0, 3), np.int64))
    lib.qem_free(ov)
    lib.qem_free(of)
    return v, f


def _face_quadrics(verts, faces):
    """Per-face fundamental error quadric K_p = p p^T, p = (n, d), |n|=1."""
    p0, p1, p2 = (verts[faces[:, i]].astype(np.float64) for i in range(3))
    n = np.cross(p1 - p0, p2 - p0)
    area = np.linalg.norm(n, axis=1)
    n = n / np.maximum(area, 1e-30)[:, None]
    d = -np.einsum("fi,fi->f", n, p0)
    p = np.concatenate([n, d[:, None]], axis=1)  # (F, 4)
    K = p[:, :, None] * p[:, None, :]  # (F, 4, 4)
    # Area weighting stabilizes quality on irregular triangulations.
    return K * np.maximum(area, 1e-30)[:, None, None]


def _decimate_python(verts, faces, target):
    """Reference implementation of the native algorithm (same semantics)."""
    V = verts.astype(np.float64)
    F = [tuple(f) for f in faces]
    Q = np.zeros((len(V), 4, 4))
    K = _face_quadrics(verts, faces)
    for fi, (a, b, c) in enumerate(F):
        Q[a] += K[fi]
        Q[b] += K[fi]
        Q[c] += K[fi]

    # Boundary constraint planes (perpendicular to the face through the
    # boundary edge), heavily weighted — stops open borders from caving in.
    edge_faces = {}
    for fi, (a, b, c) in enumerate(F):
        for e in ((a, b), (b, c), (c, a)):
            edge_faces.setdefault(tuple(sorted(e)), []).append(fi)
    for (a, b), fl in edge_faces.items():
        if len(fl) != 1:
            continue
        fi = fl[0]
        fa, fb, fc = F[fi]
        fn = np.cross(V[fb] - V[fa], V[fc] - V[fa])
        fn /= max(np.linalg.norm(fn), 1e-30)
        e = V[b] - V[a]
        cn = np.cross(e, fn)
        nrm = np.linalg.norm(cn)
        if nrm < 1e-30:
            continue
        cn /= nrm
        d = -cn @ V[a]
        p = np.concatenate([cn, [d]])
        Kb = np.outer(p, p) * 1e3 * np.linalg.norm(e)
        Q[a] += Kb
        Q[b] += Kb

    vert_faces = [set() for _ in range(len(V))]
    for fi, (a, b, c) in enumerate(F):
        vert_faces[a].add(fi)
        vert_faces[b].add(fi)
        vert_faces[c].add(fi)
    alive_face = [True] * len(F)
    version = np.zeros(len(V), np.int64)

    def optimal_point(qsum, va, vb):
        A = qsum[:3, :3]
        bvec = -qsum[:3, 3]
        try:
            x = np.linalg.solve(A + 1e-9 * np.eye(3), bvec)
            if np.all(np.isfinite(x)):
                cands = [x]
            else:
                cands = []
        except np.linalg.LinAlgError:
            cands = []
        cands += [(V[va] + V[vb]) / 2, V[va], V[vb]]
        best, bc = None, np.inf
        for cnd in cands:
            h = np.concatenate([cnd, [1.0]])
            cost = h @ qsum @ h
            if cost < bc:
                best, bc = cnd, cost
        return best, bc

    def push(heap, a, b):
        if a == b:
            return
        a, b = (a, b) if a < b else (b, a)
        pt, cost = optimal_point(Q[a] + Q[b], a, b)
        heapq.heappush(heap, (cost, a, b, int(version[a]), int(version[b]),
                              tuple(pt)))

    heap = []
    for a, b in edge_faces:
        push(heap, a, b)

    n_faces = len(F)
    while n_faces > target and heap:
        cost, a, b, va_ver, vb_ver, pt = heapq.heappop(heap)
        if version[a] != va_ver or version[b] != vb_ver:
            continue
        shared = vert_faces[a] & vert_faces[b]
        if not any(alive_face[fi] for fi in shared):
            continue  # no longer an edge
        pt = np.asarray(pt)
        # Normal-flip rejection over surviving adjacent faces.
        flip = False
        for fi in (vert_faces[a] | vert_faces[b]) - shared:
            if not alive_face[fi]:
                continue
            tri = list(F[fi])
            p_old = [V[v] for v in tri]
            p_new = [pt if v in (a, b) else V[v] for v in tri]
            n_old = np.cross(p_old[1] - p_old[0], p_old[2] - p_old[0])
            n_new = np.cross(p_new[1] - p_new[0], p_new[2] - p_new[0])
            if n_old @ n_new <= 0:
                flip = True
                break
        if flip:
            continue
        # Collapse b -> a at pt.
        V[a] = pt
        Q[a] = Q[a] + Q[b]
        for fi in shared:
            if alive_face[fi]:
                alive_face[fi] = False
                n_faces -= 1
        for fi in vert_faces[b] - shared:
            if alive_face[fi]:
                F[fi] = tuple(a if v == b else v for v in F[fi])
                vert_faces[a].add(fi)
        vert_faces[a] |= vert_faces[b]
        vert_faces[b] = set()
        version[a] += 1
        version[b] += 1
        neigh = set()
        for fi in vert_faces[a]:
            if alive_face[fi]:
                neigh.update(F[fi])
        neigh.discard(a)
        for nb in neigh:
            push(heap, a, nb)

    out_faces = np.asarray([F[fi] for fi in range(len(F)) if alive_face[fi]],
                           np.int64).reshape(-1, 3)
    return V.astype(np.float32), out_faces
