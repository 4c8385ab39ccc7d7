"""Constructive generation of the marching-cubes triangle table.

The port's own copy of the JAX package's ``native/mc_tables.py`` (NumPy
only), so that the port imports nothing of it.

The reference delegates ``method="marching_cubes"`` mesh extraction to
vtk (reference: visualization.py:200-279). Here the 256-case triangle
table is *derived* at import time rather than transcribed from the
classic published listings:

For each of the 256 corner-sign configurations, the isosurface crosses
each cube face in line segments joining edge-crossing points. On a face
with two crossings the segment is unique; on an ambiguous face (diagonal
corners inside) we use the fixed rule "separate the inside corners",
which depends only on the face's own corner signs and is therefore
identical for the two cells sharing that face — making the global mesh
watertight by construction. Chaining segments across faces yields closed
loops (every crossing edge borders exactly two faces, contributing one
segment end each); each loop is fan-triangulated and oriented so
triangle normals point from the inside (> level) region outward.

Vertices land on cube edges with linear interpolation at mesh time —
the defining property of marching cubes versus Surface Nets (cell-center
vertices).
"""

from __future__ import annotations

import numpy as np

# Corner and edge numbering (shared with native/surface_nets.cpp).
CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float64,
)
EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]
# Each face as a cyclic quad of corner ids.
FACES = [
    (0, 1, 2, 3),  # z = 0
    (4, 5, 6, 7),  # z = 1
    (0, 1, 5, 4),  # y = 0
    (3, 2, 6, 7),  # y = 1
    (0, 3, 7, 4),  # x = 0
    (1, 2, 6, 5),  # x = 1
]

_EDGE_ID = {}
for _i, (_a, _b) in enumerate(EDGES):
    _EDGE_ID[(_a, _b)] = _i
    _EDGE_ID[(_b, _a)] = _i

# Midpoint of each edge — only used for table-time orientation checks.
_EDGE_MID = np.stack([(CORNERS[a] + CORNERS[b]) / 2 for a, b in EDGES])

# Max triangles per case with this construction (asserted below).
TABLE_STRIDE = 16


def _face_segments(inside, face):
    """Isosurface segments (pairs of edge ids) on one face."""
    crossings = []
    for i in range(4):
        a, b = face[i], face[(i + 1) % 4]
        if inside[a] != inside[b]:
            crossings.append(i)
    if not crossings:
        return []
    if len(crossings) == 2:
        i, j = crossings
        return [(_EDGE_ID[(face[i], face[(i + 1) % 4])],
                 _EDGE_ID[(face[j], face[(j + 1) % 4])])]
    # Ambiguous face (4 crossings, alternating signs): cut off each inside
    # corner separately. Depends only on this face's signs -> consistent
    # between the two adjacent cells.
    segs = []
    for i in range(4):
        if inside[face[i]]:
            e_prev = _EDGE_ID[(face[(i - 1) % 4], face[i])]
            e_next = _EDGE_ID[(face[i], face[(i + 1) % 4])]
            segs.append((e_prev, e_next))
    assert len(segs) == 2
    return segs


def _loops_from_segments(segments):
    """Chain segments (each crossing edge has degree exactly 2) into loops."""
    adj = {}
    for a, b in segments:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    for v, nbrs in adj.items():
        assert len(nbrs) == 2, (v, nbrs)
    loops, seen = [], set()
    for start in sorted(adj):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        prev, cur = None, start
        while True:
            nxt = [n for n in adj[cur] if n != prev]
            # Two equal neighbours (2-cycle) can't occur: a pair of edges
            # shares at most one face, hence at most one segment.
            nxt = nxt[0]
            if nxt == start:
                break
            loop.append(nxt)
            seen.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _orient(loop, inside):
    """Order the loop so fan triangles' normals point inside -> outside."""
    pts = _EDGE_MID[loop]
    normal = np.zeros(3)
    for i in range(len(pts)):
        normal += np.cross(pts[i], pts[(i + 1) % len(pts)])
    d = np.zeros(3)
    for e in loop:
        a, b = EDGES[e]
        if inside[a]:  # a inside, b outside
            d += CORNERS[b] - CORNERS[a]
        else:
            d += CORNERS[a] - CORNERS[b]
    if float(normal @ d) < 0:
        loop = loop[::-1]
    return loop


def build_tri_table() -> np.ndarray:
    """(256, TABLE_STRIDE) int8 of edge ids, -1 padded/terminated."""
    table = np.full((256, TABLE_STRIDE), -1, np.int8)
    for case in range(256):
        inside = [(case >> c) & 1 == 1 for c in range(8)]
        segments = []
        for face in FACES:
            segments.extend(_face_segments(inside, face))
        tris = []
        for loop in _loops_from_segments(segments):
            loop = _orient(loop, inside)
            for i in range(1, len(loop) - 1):
                tris.extend((loop[0], loop[i], loop[i + 1]))
        assert len(tris) <= TABLE_STRIDE, (case, len(tris))
        table[case, : len(tris)] = tris
    return table


_TRI_TABLE = None


def tri_table() -> np.ndarray:
    global _TRI_TABLE
    if _TRI_TABLE is None:
        _TRI_TABLE = build_tri_table()
    return _TRI_TABLE
