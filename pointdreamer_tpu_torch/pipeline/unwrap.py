"""UV unwrapping + texture-atlas baking (twin of pipeline/unwrap.py).

host  : chart unwrap (axis-label charts, LSCM with a box-projection
        fallback, minimum-area rotation) and xatlas-style bitmap packing,
        ported from the JAX package nearly verbatim.  The packer's chart
        occupancy masks come from `_fill_triangles_cv2`, a numpy
        re-implementation of the cv2.fillPoly + cv2.polylines footprint the
        JAX package draws (fixed-point even-odd scanlines over all edges
        plus 8-connected Bresenham outlines), then a square binary
        dilation: the same bitmaps place the charts at the same spots.
device: atlas bake on the port's rasterizer (K1 on the card).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import raster as orast

# for axis bin a (0..5 = +x,-x,+y,-y,+z,-z): project along axis, keeping
# (u_axis, v_axis) with a sign making the projection orientation-preserving
_PROJ = {
    0: (1, 2, 1.0),   # +x -> (y, z)
    1: (1, 2, -1.0),  # -x -> (y, -z)
    2: (0, 2, -1.0),  # +y -> (x, -z)
    3: (0, 2, 1.0),   # -y -> (x, z)
    4: (0, 1, -1.0),  # +z -> (x, -y)
    5: (0, 1, 1.0),   # -z -> (x, y)
}


_DIRS6 = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                   [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=np.float64)


def _face_axis_labels(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fv = vertices[faces]
    n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    return np.argmax(n @ _DIRS6.T, axis=1)


def _smooth_labels(faces: np.ndarray, labels: np.ndarray,
                   unit_normals: np.ndarray, adj_pairs: np.ndarray,
                   iters: int = 8, min_dot: float = 0.1) -> np.ndarray:
    """Majority-vote label smoothing over the face-adjacency graph: noisy
    per-face argmax labels fragment charts into confetti; a few sweeps
    make them contiguous.  A face only adopts the neighborhood majority
    when its own normal still projects positively (> min_dot) onto that
    axis, so smoothing can never create box-projection fold-overs."""
    lab = labels.copy()
    nf = len(lab)
    compat = unit_normals @ _DIRS6.T > min_dot          # [F,6]
    for _ in range(iters):
        votes = np.zeros((nf, 6))
        np.add.at(votes, adj_pairs[:, 0], np.eye(6)[lab[adj_pairs[:, 1]]])
        np.add.at(votes, adj_pairs[:, 1], np.eye(6)[lab[adj_pairs[:, 0]]])
        votes[np.arange(nf), lab] += 1.5                # self weight
        votes = np.where(compat, votes, -1.0)
        new = votes.argmax(axis=1)
        has = votes[np.arange(nf), new] > 0
        new = np.where(has, new, lab)
        if (new == lab).all():
            break
        lab = new
    return lab


class _UnionFind:
    def __init__(self, n):
        self.p = np.arange(n)

    def find(self, x):
        root = x
        while self.p[root] != root:
            root = self.p[root]
        while self.p[x] != root:
            self.p[x], x = root, self.p[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


# ---------------------------------------------------------------------------
# chart flattening
# ---------------------------------------------------------------------------

def _is_disk(n_verts: int, faces_local: np.ndarray) -> bool:
    """Euler characteristic test: LSCM needs a topological disk (chi=1);
    annulus-like charts would fold onto themselves."""
    e = np.concatenate([faces_local[:, [0, 1]], faces_local[:, [1, 2]],
                       faces_local[:, [2, 0]]], axis=0)
    n_edges = len(np.unique(np.sort(e, axis=1), axis=0))
    return n_verts - n_edges + len(faces_local) == 1


def _lscm(pts3: np.ndarray, faces_local: np.ndarray) -> np.ndarray | None:
    """Least-squares conformal map of one chart (Levy et al. 2002).

    pts3 [n,3] chart vertices, faces_local [f,3] local indices.
    Returns [n,2] UV coordinates (unnormalized scale) or None on failure.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = len(pts3)
    f = len(faces_local)
    if n < 3 or f < 1:
        return None

    p0 = pts3[faces_local[:, 0]]
    e1 = pts3[faces_local[:, 1]] - p0
    e2 = pts3[faces_local[:, 2]] - p0
    x1 = np.linalg.norm(e1, axis=1)
    bad = x1 < 1e-12
    x1 = np.where(bad, 1.0, x1)
    u_hat = e1 / x1[:, None]
    nrm = np.cross(e1, e2)
    ny = np.linalg.norm(nrm, axis=1)
    x2 = np.einsum("ij,ij->i", e2, u_hat)
    y2 = ny / x1                                  # > 0 for non-degenerate
    area2 = x1 * y2                               # = 2*A
    w = 1.0 / np.sqrt(np.maximum(area2, 1e-12))
    # local complex coords z0=0, z1=x1, z2=x2+i*y2; LSCM coefficients
    # W_j = z_{j+2} - z_{j+1} (cyclic), rows scaled by 1/sqrt(2A)
    W0 = ((x2 - x1) + 1j * y2) * w
    W1 = (-x2 - 1j * y2) * w
    W2 = (x1 + 0j) * w

    # pin the two most distant vertices along the dominant extent
    ext = pts3.max(0) - pts3.min(0)
    ax = int(np.argmax(ext))
    pin = np.array([int(np.argmin(pts3[:, ax])), int(np.argmax(pts3[:, ax]))])
    if pin[0] == pin[1]:
        return None
    pin_uv = np.array([[0.0, 0.0],
                       [float(np.linalg.norm(pts3[pin[1]] - pts3[pin[0]])),
                        0.0]])

    free = np.setdiff1d(np.arange(n), pin)
    col_of = np.full(n, -1)
    col_of[free] = np.arange(len(free))

    rows = np.repeat(np.arange(f), 3)
    cols = faces_local.reshape(-1)
    vals = np.stack([W0, W1, W2], axis=1).reshape(-1)
    is_free = col_of[cols] >= 0
    Mf = sp.coo_matrix(
        (vals[is_free], (rows[is_free], col_of[cols[is_free]])),
        shape=(f, len(free))).tocsr()
    # rhs from pinned columns
    pin_index_of = np.full(n, -1)
    pin_index_of[pin] = np.arange(2)
    pin_col = pin_index_of[cols[~is_free]]
    up = pin_uv[:, 0] + 1j * pin_uv[:, 1]
    rhs = np.zeros(f, complex)
    np.add.at(rhs, rows[~is_free], -vals[~is_free] * up[pin_col])

    # real block least-squares via normal equations (charts are small)
    A = sp.bmat([[Mf.real, -Mf.imag], [Mf.imag, Mf.real]]).tocsr()
    b = np.concatenate([rhs.real, rhs.imag])
    AtA = (A.T @ A).tocsc()
    Atb = A.T @ b
    try:
        x = spla.spsolve(AtA + 1e-12 * sp.eye(AtA.shape[0]), Atb)
    except Exception:
        return None
    if not np.all(np.isfinite(x)):
        return None
    uv = np.zeros((n, 2))
    uv[free, 0] = x[: len(free)]
    uv[free, 1] = x[len(free):]
    uv[pin] = pin_uv
    return uv


def _signed_area2(uv: np.ndarray, faces_local: np.ndarray) -> np.ndarray:
    a = uv[faces_local[:, 0]]
    b = uv[faces_local[:, 1]]
    c = uv[faces_local[:, 2]]
    return 0.5 * np.cross(b - a, c - a)


def _min_bbox_rotate(uv: np.ndarray) -> np.ndarray:
    """Rotate a chart so its axis-aligned bounding box has minimum area
    (rotating calipers over convex-hull edge directions)."""
    if len(uv) < 3:
        return uv
    try:
        from scipy.spatial import ConvexHull

        hull = uv[ConvexHull(uv).vertices]
    except Exception:
        return uv
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    ang = np.arctan2(edges[:, 1], edges[:, 0])
    best, best_area = None, np.inf
    for t in np.unique(np.mod(ang, np.pi / 2)):
        c, s = np.cos(-t), np.sin(-t)
        R = np.array([[c, -s], [s, c]])
        r = hull @ R.T
        ext = r.max(0) - r.min(0)
        area = ext[0] * ext[1]
        if area < best_area:
            best_area, best = area, R
    return uv @ best.T if best is not None else uv


def _flatten_chart(pts3: np.ndarray, faces_local: np.ndarray,
                   label: int) -> np.ndarray:
    """LSCM with a box-projection fallback; output rotated to min bbox,
    scaled so 2D area matches 3D surface area (uniform texel density),
    and translated to start at the origin."""
    fv = pts3[faces_local]
    area3 = 0.5 * np.linalg.norm(
        np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]), axis=1).sum()

    uv = None
    if _is_disk(len(pts3), faces_local):
        uv = _lscm(pts3, faces_local)
    if uv is not None:
        sa = _signed_area2(uv, faces_local)
        tot = sa.sum()
        if tot < 0:                      # conformal map may mirror: unflip
            uv[:, 1] *= -1.0
            sa = -sa
            tot = -tot
        # reject fold-overs / collapse (fall back to projection)
        if tot < 1e-12 * max(area3, 1e-12) or \
                (np.abs(sa[sa < 0]).sum() > 0.02 * tot):
            uv = None
    if uv is None:
        ua, va, sgn = _PROJ[label]
        uv = np.stack([pts3[:, ua], sgn * pts3[:, va]], axis=1)

    uv = _min_bbox_rotate(uv)
    a2 = np.abs(_signed_area2(uv, faces_local).sum())
    if a2 > 1e-14 and area3 > 0:
        uv = uv * np.sqrt(area3 / a2)
    uv = uv - uv.min(axis=0, keepdims=True)
    return uv


def _label_components(faces: np.ndarray, fidx: np.ndarray,
                      labels: np.ndarray) -> List[np.ndarray]:
    """Connected components of the face subset `fidx`, where adjacency
    requires shared edge AND equal axis label.  Returns global-index
    arrays (the split-retry path of `unwrap`)."""
    sub = faces[fidx]
    m = len(fidx)
    edges = np.concatenate([sub[:, [0, 1]], sub[:, [1, 2]],
                            sub[:, [2, 0]]], axis=0)
    ek = np.sort(edges, axis=1)
    key = ek[:, 0] * (int(faces.max()) + 1) + ek[:, 1]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    fo = np.tile(np.arange(m), 3)[order]
    uf = _UnionFind(m)
    same = np.nonzero(sk[1:] == sk[:-1])[0]
    lab = labels[fidx]
    for i in same:
        a, b = fo[i], fo[i + 1]
        if lab[a] == lab[b]:
            uf.union(a, b)
    roots = np.array([uf.find(i) for i in range(m)])
    return [fidx[roots == r] for r in np.unique(roots)]


# ---------------------------------------------------------------------------
# bitmap packing (xatlas-style)
# ---------------------------------------------------------------------------

def _bresenham_pixels(p: np.ndarray, q: np.ndarray):
    """Pixels of 8-connected lines p -> q (int [E,2] x,y), as OpenCV's
    LineIterator walks them left to right: with major length M and minor
    length m, step k sits at minor offset ceil((2 k m - M) / (2 M))."""
    swap = q[:, 0] < p[:, 0]
    a = np.where(swap[:, None], q, p)
    b = np.where(swap[:, None], p, q)
    dx = b[:, 0] - a[:, 0]
    dy = b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    ady = np.abs(dy)
    vert = ady > dx
    major = np.where(vert, ady, dx)
    minor = np.where(vert, dx, ady)
    n = major + 1
    eid = np.repeat(np.arange(len(p)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    M, m = major[eid], minor[eid]
    num = 2 * k * m - M
    step = np.where(M > 0, -((-num) // np.maximum(2 * M, 1)), 0)
    x = np.where(vert[eid], a[eid, 0] + step, a[eid, 0] + k)
    y = np.where(vert[eid], a[eid, 1] + sy[eid] * k,
                 a[eid, 1] + sy[eid] * step)
    return x, y


def _fill_triangles_cv2(h: int, w: int, tris: np.ndarray) -> np.ndarray:
    """cv2.fillPoly(img, tris, 1) + cv2.polylines(img, tris, True, 1) for
    integer triangles [P,3,2] (x, y) inside an [h, w] image."""
    img = np.zeros((h, w), bool)
    if len(tris) == 0:
        return img
    p = tris.reshape(-1, 2).astype(np.int64)
    q = np.roll(tris, -1, axis=1).reshape(-1, 2).astype(np.int64)
    lx, ly = _bresenham_pixels(p, q)
    ok = (lx >= 0) & (lx < w) & (ly >= 0) & (ly < h)
    img[ly[ok], lx[ok]] = True

    # even-odd scanline fill over every non-horizontal edge at once, in
    # OpenCV's 16.16 fixed point
    keep = p[:, 1] != q[:, 1]
    p, q = p[keep], q[keep]
    if len(p) == 0:
        return img
    X0 = (p[:, 0] << 16) + (1 << 15)
    X1 = (q[:, 0] << 16) + (1 << 15)
    num, den = X1 - X0, q[:, 1] - p[:, 1]
    dxf = (np.abs(num) // np.abs(den)) * np.sign(num) * np.sign(den)
    up = p[:, 1] < q[:, 1]
    xs = np.where(up, X0, X1)
    y0 = np.minimum(p[:, 1], q[:, 1])
    n = np.abs(den)
    eid = np.repeat(np.arange(len(p)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    row = y0[eid] + k
    xv = xs[eid] + k * dxf[eid]
    order = np.lexsort((xv, row))
    row, xv = row[order], xv[order]
    first = np.searchsorted(row, row, side="left")
    rank = np.arange(len(row)) - first
    left = np.flatnonzero(rank % 2 == 0)
    if len(left) and left[-1] + 1 >= len(row):
        raise ValueError("odd scanline edge count")
    r = row[left]
    xa = xv[left] >> 16
    xb = (xv[left + 1] >> 16) - 1
    ok = (r >= 0) & (r < h) & (xa < w) & (xb >= 0) & (xb >= xa)
    r, xa, xb = r[ok], np.clip(xa[ok], 0, w - 1), np.clip(xb[ok], 0, w - 1)
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (r, xa), 1)
    np.add.at(diff, (r, xb + 1), -1)
    img |= np.cumsum(diff[:, :w], axis=1) > 0
    return img


def _raster_chart_mask(uv_px: np.ndarray, faces_local: np.ndarray,
                       w: int, h: int, pad: int):
    """Filled-triangle occupancy bitmap of one chart, dilated by `pad`:
    floor to integer pixels, fill + outline every triangle with the cv2
    footprint, then a square binary dilation (cv2.dilate's)."""
    q = np.floor(uv_px + pad).astype(np.int64)
    img = _fill_triangles_cv2(h + 2 * pad, w + 2 * pad, q[faces_local])
    if pad > 0:
        from scipy.ndimage import binary_dilation

        img = binary_dilation(img, np.ones((2 * pad + 1, 2 * pad + 1), bool))
    return img


def _pack_bitmap(chart_uvs: List[np.ndarray],
                 chart_faces: List[np.ndarray],
                 atlas_res: int, gutter_px: int
                 ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Pack charts into the unit square, xatlas-style: per-chart occupancy
    bitmaps on a coarse collision grid, first collision-free position by
    FFT cross-correlation against the running occupancy map (bottom-left
    order), descending ladder on the global scale until every chart fits,
    with a 90-degree rotation retry per chart.  Returns
    (scale px/world, offsets [C,2] px, rot90 [C] bool) in atlas_res px."""
    from scipy import fft as sfft                 # float32-preserving FFTs

    G = min(atlas_res, 256)
    up = atlas_res / float(G)
    # cap the gutter for small atlases (tests bake at 64) where per-chart
    # borders would otherwise consume the whole grid
    gutter_g = max(1, min(int(round(gutter_px / up)), G // 32))
    n = len(chart_uvs)
    ext = np.array([c.max(0) if len(c) else (1e-9, 1e-9)
                    for c in chart_uvs])
    ext = np.maximum(ext, 1e-9)
    areas = ext[:, 0] * ext[:, 1]
    order = np.argsort(-areas)
    S = 1
    while S < G:
        S *= 2            # FFT size: power of two >= G.  G (not 2G)
    # suffices: the correlation is only read on the valid region
    # [0..G-mh] x [0..G-mw], where y+dy <= G-1 < S — the circular
    # wraparound never reaches it, so the smaller transform is exact
    # (4x fewer FFT points than the former 2G padding).
    # footprint (incl. gutter) at or below this edge length places by its
    # bounding rect on an integral image instead of bitmap+FFT — the
    # sliver-chart swarm regime (topological-noise meshes produce
    # thousands of tiny charts; rect waste is bounded by TINY² texels,
    # the raster+FFT cost it avoids dominates packing time)
    TINY = 16

    def try_place(s, force=False):
        occ = np.zeros((G, G), np.float32)
        offsets = np.zeros((n, 2))
        rot90 = np.zeros(n, bool)
        shrink = np.ones(n)
        for c in order:
            placed = False
            occ_f = None                          # lazy: tiny charts skip it
            integ = None                          # lazy integral image
            # per-chart shrink fallback: a chart that cannot find a slot
            # shrinks alone instead of failing the whole layout (slightly
            # non-uniform texel density beats dropping the global scale)
            for sh in (1.0, 0.88, 0.76, 0.62, 0.48, 0.34, 0.2):
                sc = s * sh
                for rot in (False, True):
                    e = ext[c, ::-1] if rot else ext[c]
                    w = int(np.ceil(e[0] * sc)) + 1
                    h = int(np.ceil(e[1] * sc)) + 1
                    mh = h + 2 * gutter_g
                    mw = w + 2 * gutter_g
                    if mw > G or mh > G:
                        continue
                    if max(mh, mw) <= TINY:
                        # rect placement: free slot = zero box-sum of occ
                        if integ is None:
                            integ = np.zeros((G + 1, G + 1), np.float64)
                            np.cumsum(occ, axis=0,
                                      out=integ[1:, 1:])
                            np.cumsum(integ[1:, 1:], axis=1,
                                      out=integ[1:, 1:])
                        ii = integ
                        box = (ii[mh:, mw:] + ii[:G - mh + 1, :G - mw + 1]
                               - ii[mh:, :G - mw + 1] - ii[:G - mh + 1, mw:])
                        ok = box < 0.5
                        if not ok.any():
                            continue
                        flat = int(np.argmax(ok))
                        py, px = divmod(flat, ok.shape[1])
                        occ[py:py + mh, px:px + mw] = 1.0
                        offsets[c] = (px + gutter_g, py + gutter_g)
                        rot90[c] = rot
                        shrink[c] = sh
                        placed = True
                        break
                    if rot:  # rotate 90deg: (u,v) -> (v, max_u - u)
                        uv = np.stack([chart_uvs[c][:, 1],
                                       ext[c, 0] - chart_uvs[c][:, 0]],
                                      axis=1)
                    else:
                        uv = chart_uvs[c]
                    m = _raster_chart_mask(uv * sc, chart_faces[c], w, h,
                                           gutter_g).astype(np.float32)
                    if occ_f is None:             # hoisted: occ is fixed
                        occ_f = sfft.rfft2(occ, (S, S))
                    corr = sfft.irfft2(
                        occ_f * np.conj(sfft.rfft2(m, (S, S))), (S, S))
                    ok = corr[: G - mh + 1, : G - mw + 1] < 0.5
                    if not ok.any():
                        continue
                    flat = int(np.argmax(ok))           # first True:
                    py, px = divmod(flat, ok.shape[1])  # bottom-left
                    occ[py:py + mh, px:px + mw] = np.maximum(
                        occ[py:py + mh, px:px + mw], m)
                    offsets[c] = (px + gutter_g, py + gutter_g)
                    rot90[c] = rot
                    shrink[c] = sh
                    placed = True
                    break
                if placed:
                    break
            if not placed:
                if not force:
                    return None
                # forced mode (topological-noise meshes with thousands of
                # sliver charts): degenerate the chart to ~one texel at
                # the gutter corner rather than failing the whole atlas —
                # a zero-area slot loses only that sliver's texels
                offsets[c] = (gutter_g, gutter_g)
                shrink[c] = 1e-6
        return offsets, rot90, shrink

    # scale ladder down from the fit-by-TRUE-area upper estimate (atlas
    # coverage is true_area*s^2/G^2, so success at ladder factor f gives
    # coverage ~0.97*f^2 regardless of chart bbox waste)
    chart_area = np.array([
        float(np.abs(_signed_area2(chart_uvs[c], chart_faces[c])).sum())
        for c in range(n)])
    true_area = float(chart_area.sum())
    s_hi = np.sqrt(0.97 * G * G / max(true_area, 1e-12))
    s_hi = min(s_hi, (G - 2 * gutter_g - 2) / ext.max())
    def feasible(s):
        # cheap area bound: skip the FFT placement pass only when even the
        # per-chart shrink floor (0.2) could not fit the rectangular
        # footprints — conservative, so levels the shrink ladder could
        # rescue are still attempted (sliver-chart meshes would otherwise
        # burn thousands of correlations per hopeless level)
        w = np.ceil(ext[:, 0] * s * 0.2) + 1 + 2 * gutter_g
        h = np.ceil(ext[:, 1] * s * 0.2) + 1 + 2 * gutter_g
        return float((w * h).sum()) <= 1.02 * G * G

    def packed_area(f, r):
        # effective texel-weighted area of a layout: per-chart true area
        # scaled by its (global*per-chart) shrink — the quantity atlas
        # coverage (and thus texel density) is proportional to
        return float((chart_area * (f * r[2]) ** 2).sum())

    f = 1.0
    while f > 0.05:
        if not feasible(s_hi * f):
            f *= 0.9
            continue
        r = try_place(s_hi * f)
        if r is not None:
            best_f, best_r = f, r
            if f < 1.0:
                # bisect between the first fit and the last failure: the
                # x0.9 ladder leaves up to 10% linear scale (~+0.2 dB of
                # texel density) on the table.  A higher global scale can
                # force more per-chart shrinks, so keep a candidate only
                # if its effective packed area actually improves.
                lo, hi = f, f / 0.9
                for _ in range(3):
                    mid = 0.5 * (lo + hi)
                    rm = try_place(s_hi * mid)
                    if rm is None:
                        hi = mid
                    else:
                        if packed_area(mid, rm) > packed_area(best_f, best_r):
                            best_f, best_r = mid, rm
                        lo = mid
            offsets, rot90, shrink = best_r
            return s_hi * best_f * up, offsets * up, rot90, shrink
        f *= 0.9
    # forced final pass: degenerate whatever cannot fit (never fail —
    # xatlas semantics; hit only by pathological sliver-chart meshes)
    offsets, rot90, shrink = try_place(s_hi * 0.05, force=True)
    return s_hi * 0.05 * up, offsets * up, rot90, shrink


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def unwrap(vertices: np.ndarray, faces: np.ndarray,
           atlas_res: int = 1024, gutter_px: int = 4
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Compute per-chart UVs.

    Returns (uvs [Nuv,2] in [0,1], face_uv_idx [F,3] int64) — same contract
    as xatlas.parametrize in extract_texture_map.py:43-50.
    """
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    nf = len(faces)

    # edge -> faces map for connectivity
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], axis=0)
    ekey = np.sort(edges, axis=1)
    ekey = ekey[:, 0] * (faces.max() + 1) + ekey[:, 1]
    order = np.argsort(ekey, kind="stable")
    sk = ekey[order]
    fid_of_edge = np.tile(np.arange(nf), 3)[order]
    same = np.nonzero(sk[1:] == sk[:-1])[0]
    adj_pairs = np.stack([fid_of_edge[same], fid_of_edge[same + 1]], 1)

    fv = vertices[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    dirs = _DIRS6

    labels = _smooth_labels(faces, _face_axis_labels(vertices, faces),
                            fn, adj_pairs)
    labels_smoothed = labels.copy()      # merge phases mutate `labels`
    uf = _UnionFind(nf)
    for fa, fb in adj_pairs:
        if labels[fa] == labels[fb]:
            uf.union(fa, fb)
    roots = np.array([uf.find(i) for i in range(nf)])

    # merge tiny charts into an adjacent chart when every face still has
    # a positive projection onto the absorber's axis (fewer seams ->
    # fewer NBF-masked border texels and less gutter waste)
    for _ in range(4):
        ids, counts = np.unique(roots, return_counts=True)
        size_of = dict(zip(ids, counts))
        small = {i for i, c in zip(ids, counts) if c < 20}
        if not small:
            break
        changed = False
        for fa, fb in adj_pairs:
            if roots[fa] == roots[fb]:
                continue
            for s_f, big_f in ((fa, fb), (fb, fa)):
                rs, rb2 = roots[s_f], roots[big_f]
                if rs in small and size_of.get(rb2, 0) >= size_of.get(rs, 0):
                    members = roots == rs
                    axis = labels[big_f]
                    if (fn[members] @ dirs[axis]).min() > 0.05:
                        roots[members] = rb2
                        labels[members] = axis
                        changed = True
                        break
        if not changed:
            break

    # second merge phase: noisy meshes (hoppe normals) fragment into
    # hundreds of tiny charts, which makes packing quadratic-slow and
    # wastes gutters.  LSCM only needs disk topology, not near-axis
    # normals, so keep folding the smallest chart into its most-adjacent
    # neighbor until the chart set is reasonable.
    max_charts, min_faces = 64, 12
    frozen = set()                    # isolated charts with no neighbors
    for _ in range(nf):
        ids, counts = np.unique(roots, return_counts=True)
        cand_order = np.argsort(counts)
        smallest = None
        for ci in cand_order:
            if ids[ci] not in frozen:
                smallest = ids[ci]
                small_count = counts[ci]
                break
        n_live = len(ids)
        if smallest is None or n_live <= 1 or (
                n_live <= max_charts and small_count >= min_faces):
            break
        ra, rb = roots[adj_pairs[:, 0]], roots[adj_pairs[:, 1]]
        touch = (ra != rb) & ((ra == smallest) | (rb == smallest))
        if not touch.any():
            frozen.add(smallest)
            continue
        other = np.where(ra[touch] == smallest, rb[touch], ra[touch])
        absorber = np.bincount(other).argmax()   # most shared edges
        members = roots == smallest
        # keep a consistent projection axis for the box-projection fallback
        absorber_label = labels[roots == absorber][0]
        roots[members] = absorber
        labels[members] = absorber_label

    chart_ids, chart_of_face = np.unique(roots, return_inverse=True)
    n_charts = len(chart_ids)

    # flatten every chart (LSCM, box-projection fallback).  A chart whose
    # flattening folds over (>2% flipped faces — merged charts spanning
    # several orientations neither LSCM nor a single box projection can
    # flatten) is SPLIT back into per-axis-label connected components,
    # each box-projected along its own dominant axis, which cannot flip:
    # every member face has positive normal projection onto that axis.
    true_labels = labels_smoothed         # smoothed, merge-unpolluted
    face_uv_idx = np.zeros((nf, 3), np.int64)
    chart_uvs: List[np.ndarray] = []
    chart_faces: List[np.ndarray] = []
    chart_fmask: List[np.ndarray] = []

    def add_chart(fidx: np.ndarray, uv: np.ndarray, floc: np.ndarray):
        fmask = np.zeros(nf, bool)
        fmask[fidx] = True
        chart_uvs.append(uv)
        chart_faces.append(floc)
        chart_fmask.append(fmask)

    def flip_frac(uv, floc):
        return float((_signed_area2(uv, floc) <= 0).mean())

    for c in range(n_charts):
        fidx = np.nonzero(chart_of_face == c)[0]
        cfaces = faces[fidx]
        label = labels[fidx[0]]
        vids, local = np.unique(cfaces.reshape(-1), return_inverse=True)
        floc = local.reshape(-1, 3)
        uv = _flatten_chart(vertices[vids], floc, label)
        if flip_frac(uv, floc) <= 0.02:
            add_chart(fidx, uv, floc)
            continue
        # split-retry: per true-label connected components
        for sub in _label_components(faces, fidx, true_labels):
            sfaces = faces[sub]
            svids, slocal = np.unique(sfaces.reshape(-1),
                                      return_inverse=True)
            sfloc = slocal.reshape(-1, 3)
            ua, va, sgn = _PROJ[true_labels[sub[0]]]
            suv = np.stack([vertices[svids][:, ua],
                            sgn * vertices[svids][:, va]], axis=1)
            suv = _min_bbox_rotate(suv)
            fv = vertices[svids][sfloc]
            area3 = 0.5 * np.linalg.norm(
                np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]),
                axis=1).sum()
            a2 = np.abs(_signed_area2(suv, sfloc).sum())
            if a2 > 1e-14 and area3 > 0:
                suv = suv * np.sqrt(area3 / a2)
            suv = suv - suv.min(axis=0, keepdims=True)
            add_chart(sub, suv, sfloc)
    n_charts = len(chart_uvs)

    scale, offsets, rot90, shrink = _pack_bitmap(
        chart_uvs, chart_faces, atlas_res, gutter_px)

    uv_offset = 0
    uvs_list = []
    for c in range(n_charts):
        cuv = chart_uvs[c]
        if rot90[c]:
            cuv = np.stack([cuv[:, 1], cuv[:, 0].max() - cuv[:, 0]], axis=1)
        uv = (cuv * scale * shrink[c] + offsets[c][None, :]) / float(atlas_res)
        uvs_list.append(uv)
        face_uv_idx[chart_fmask[c]] = chart_faces[c] + uv_offset
        uv_offset += len(uv)
    uvs = np.clip(np.concatenate(uvs_list, axis=0), 0.0, 1.0)
    return uvs.astype(np.float32), face_uv_idx


def bake_atlas(vertices, faces, uvs, face_uv_idx, resolution: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Rasterize the UV layout into per-texel buffers (depth = 1, no
    culling): 'gb_pos' [R,R,3] world position per texel, 'mask' [R,R]
    coverage, 'per_atlas_pixel_face_id' [R,R] int32 (-1 empty).  Texel
    row r is v = (r+0.5)/R; the PNG is flipped at save time."""
    uvs_t = torch.as_tensor(np.asarray(uvs, np.float32), device=device)
    ndc = uvs_t * 2.0 - 1.0
    depth = torch.ones((uvs_t.shape[0],), dtype=torch.float32, device=device)
    fuv = torch.as_tensor(np.asarray(face_uv_idx), device=device).long()
    # the binned route (K1) whatever PD_USE_PALLAS_RASTER says: the JAX
    # package's bake calls its tiled rasterizer directly
    out = orast.rasterize_binned(ndc[None], depth[None], fuv, resolution)
    fid = out.face_id[0]
    mask = fid >= 0
    verts = torch.as_tensor(np.asarray(vertices, np.float32), device=device)
    faces_t = torch.as_tensor(np.asarray(faces), device=device).long()
    gb_pos = orast.interpolate(verts, faces_t, fid, out.bary[0])
    gb_pos = torch.where(mask[..., None], gb_pos, torch.zeros_like(gb_pos))
    return {"uvs": uvs_t, "mesh_tex_idx": fuv, "gb_pos": gb_pos,
            "mask": mask, "per_atlas_pixel_face_id": fid}
