"""Marching-cubes case table, generated programmatically (the port's own
copy of ops/mc_table.py).

Instead of transcribing the classic 256x16 lookup, the table is DERIVED
here from first principles, so every entry is auditable:

  for each of the 256 corner-sign cases
    1. cut edges = cube edges whose endpoints straddle the iso level,
    2. on every cube face, pair up its cut edges; an ambiguous face
       (4 cut edges, diagonal corners inside) is resolved by a rule
       that depends ONLY on the face's corner signs — the contour wraps
       each OUTSIDE corner, keeping the inside regions connected across
       the face — which both cubes sharing the face evaluate
       identically, so the mesh is crack-free by construction (the
       reference's vendored libmcubes likewise fixes one sign-only
       convention; models/POCO/eval/src/utils/libmcubes),
    3. chain the face pairings into closed loops of cut edges,
    4. fan-triangulate each loop, oriented so normals point from the
       inside (field < 0) toward the outside.

Output triangles index the 12 CUBE EDGES (vertex = iso crossing on that
edge), at most 4 loops totalling <= 12 edges per cube.

Corner ids: c = x + 2y + 4z.
"""
from __future__ import annotations

import numpy as np

# corner coordinates, id c = x + 2y + 4z: x = c&1, y = (c>>1)&1,
# z = (c>>2)&1
CORNER_XYZ = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                       for c in range(8)], dtype=np.int32)

# the 12 cube edges as corner pairs (lo id < hi id)
EDGES = np.array([
    (0, 1), (2, 3), (4, 5), (6, 7),       # x-edges
    (0, 2), (1, 3), (4, 6), (5, 7),       # y-edges
    (0, 4), (1, 5), (2, 6), (3, 7),       # z-edges
], dtype=np.int32)

_EDGE_ID = {tuple(sorted(e)): i for i, e in enumerate(map(tuple, EDGES))}


def _outward_faces():
    """The 6 faces as 4 corner ids, cyclically ordered CCW as seen from
    OUTSIDE the cube (face normal via Newell points away from the cube
    center) — computed, not transcribed."""
    faces = []
    for axis in range(3):
        for v in (0, 1):
            cs = [c for c in range(8) if CORNER_XYZ[c][axis] == v]
            # order the 4 corners cyclically around the face center
            pts = np.asarray([CORNER_XYZ[c] for c in cs], np.float64)
            ctr = pts.mean(axis=0)
            o = [i for i in range(3) if i != axis]
            ang = np.arctan2(pts[:, o[1]] - ctr[o[1]],
                             pts[:, o[0]] - ctr[o[0]])
            cs = [cs[i] for i in np.argsort(ang)]
            pts = np.asarray([CORNER_XYZ[c] for c in cs], np.float64)
            n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
            outward = ctr - np.array([0.5, 0.5, 0.5])
            if np.dot(n, outward) < 0:
                cs = cs[::-1]
            faces.append(cs)
    return faces


FACES = _outward_faces()


def _directed_pairings(face, inside):
    """Directed contour segments of one face: walking the face boundary
    in outward-CCW order, a cut edge is an EXIT crossing when it leaves
    the inside region and an ENTER crossing when it returns; each exit
    pairs with the cyclically NEXT enter.  This single rule covers the
    2-cut case and resolves the ambiguous 4-cut case (the contour wraps
    the outside corners) from the face's signs alone — both cubes
    sharing a face walk it in OPPOSITE directions, so an exit on one
    side is an enter on the other and the directed segments chain
    head-to-tail across cubes: the resulting loops carry one globally
    consistent orientation by construction."""
    cs = face
    crossings = []                       # (walk position, edge id, kind)
    for k in range(4):
        a, b = cs[k], cs[(k + 1) % 4]
        if inside[a] != inside[b]:
            crossings.append((_EDGE_ID[tuple(sorted((a, b)))],
                              "exit" if inside[a] else "enter"))
    pairs = []
    n = len(crossings)
    for i, (e, kind) in enumerate(crossings):
        if kind == "exit":
            for j in range(1, n + 1):    # next enter, cyclically
                e2, kind2 = crossings[(i + j) % n]
                if kind2 == "enter":
                    pairs.append((e, e2))
                    break
    return pairs


def _loops_for_case(case):
    """Directed loops of cut edges (each edge has exactly one outgoing
    pairing — on the face where it is an exit — and one incoming)."""
    inside = [(case >> c) & 1 == 1 for c in range(8)]
    nxt = {}
    for face in FACES:
        for e1, e2 in _directed_pairings(face, inside):
            assert e1 not in nxt, case
            nxt[e1] = e2
    loops = []
    seen = set()
    for start in sorted(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = nxt[start]
        while cur != start:
            loop.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        loops.append(loop)
    return loops


def _winding_flip():
    """Fix the global fan winding so normals point inside -> outside:
    check the single-corner case (corner 0 inside) whose triangle
    normal must face away from corner 0."""
    loops = _loops_for_case(1)
    (loop,) = loops
    pts = np.asarray([(CORNER_XYZ[EDGES[e][0]] + CORNER_XYZ[EDGES[e][1]])
                      / 2.0 for e in loop], np.float64)
    n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    outward = pts.mean(axis=0) - CORNER_XYZ[0]
    return bool(np.dot(n, outward) < 0)


def _edges_share_face(e1, e2):
    """True if cube edges e1, e2 lie on a common cube face."""
    for face in FACES:
        fs = set(face)
        if set(EDGES[e1]) <= fs and set(EDGES[e2]) <= fs:
            return True
    return False


def _fan(loop):
    """Fan-triangulate one directed loop with an apex chosen so that no
    fan DIAGONAL connects two cut edges sharing a cube face: a
    face-coplanar diagonal can coincide (same two vertices) with the
    neighboring cube's contour segment on that face, producing a
    non-manifold 4-triangle edge.  A valid apex exists for every loop of
    every case (asserted at build time)."""
    k = len(loop)
    if k == 3:
        return [(loop[0], loop[1], loop[2])]
    for r in range(k):
        rot = loop[r:] + loop[:r]
        if all(not _edges_share_face(rot[0], rot[j])
               for j in range(2, k - 1)):
            return [(rot[0], rot[i], rot[i + 1]) for i in range(1, k - 1)]
    raise AssertionError(f"no face-clean fan apex for loop {loop}")


def build_mc_table():
    """Returns (tri_edges [256, MAX_TRIS, 3] int32 edge ids, -1 padded,
    and MAX_TRIS).  Triangles are fans over the directed loops."""
    flip = _winding_flip()
    all_tris = []
    max_tris = 0
    for case in range(256):
        tris = []
        if 0 < bin(case).count("1") < 8:
            for loop in _loops_for_case(case):
                if flip:
                    loop = loop[::-1]
                tris.extend(_fan(loop))
        all_tris.append(tris)
        max_tris = max(max_tris, len(tris))
    table = -np.ones((256, max_tris, 3), dtype=np.int32)
    for case, tris in enumerate(all_tris):
        for i, t in enumerate(tris):
            table[case, i] = t
    return table, max_tris


MC_TABLE, MC_MAX_TRIS = build_mc_table()
