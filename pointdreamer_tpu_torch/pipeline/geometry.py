"""Geometry stage: coloured point cloud -> triangle mesh (twin of
pipeline/geometry.py).

Backends:
  'SPR'/'poisson_fft' — screened Poisson indicator (ops.sdf.
                  poisson_indicator_grid) from PCA + MST normals
  'hoppe'       — the tangent-plane SDF (ops.sdf.hoppe_sdf), evaluated in
                  a band around the points, vertices refined by bisection
  'POCO'        — the occupancy network (models/occupancy) through
                  `poco_apply`, evaluated and refined as 'hoppe' is; with
                  no network it warns and runs 'SPR', as the JAX package
                  does.

The field lives on a dense grid over [-0.62, 0.62]^3, marching cubes
extracts the surface (ops/iso.py), the largest edge-connected component
is kept, and the port's C++ QEM (ops/qem.py) decimates it.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import iso as oiso
from ..ops import qem as oqem
from ..ops import sdf as osdf

GRID_LO, GRID_HI = -0.62, 0.62


def normalize_points(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Centre on the bbox midpoint and scale the longest side to 1
    (reference demo.py:377-380).  Returns (normalized, center, scale)."""
    vmin = xyz.min(axis=0)
    vmax = xyz.max(axis=0)
    center = (vmin + vmax) / 2.0
    scale = float((vmax - vmin).max())
    return ((xyz - center) / scale).astype(np.float32), center, scale


def taubin_smooth(vertices: np.ndarray, faces: np.ndarray,
                  iterations: int = 5, lam: float = 0.5,
                  mu: float = -0.53) -> np.ndarray:
    """Taubin lambda/mu smoothing (shrink-free, unlike plain Laplacian)."""
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], 0)
    edges = np.concatenate([edges, edges[:, ::-1]], 0)
    src = torch.as_tensor(edges[:, 0])
    dst = torch.as_tensor(edges[:, 1])
    nv = len(vertices)
    deg = torch.zeros(nv).index_add_(0, src, torch.ones(len(edges)))
    deg = deg.clamp(min=1.0)[:, None]
    v = torch.as_tensor(np.asarray(vertices, np.float32))

    def step(v, factor):
        nbr_mean = torch.zeros_like(v).index_add_(0, src, v[dst]) / deg
        return v + factor * (nbr_mean - v)

    for _ in range(iterations):
        v = step(v, lam)
        v = step(v, mu)
    return v.numpy()


def largest_component(vertices: np.ndarray, faces: np.ndarray):
    """Keep the largest edge-connected face component (drops floater
    shells the implicit field can produce)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    nf = len(faces)
    if nf == 0:
        return vertices, faces
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], axis=0)
    ekey = np.sort(edges, axis=1)
    ekey = ekey[:, 0] * (int(faces.max()) + 1) + ekey[:, 1]
    order = np.argsort(ekey, kind="stable")
    sk = ekey[order]
    fids = np.tile(np.arange(nf), 3)[order]
    same = np.nonzero(sk[1:] == sk[:-1])[0]
    rows, cols = fids[same], fids[same + 1]
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(nf, nf))
    n_comp, lab = connected_components(g, directed=False)
    if n_comp <= 1:
        return vertices, faces
    keep = lab == np.bincount(lab).argmax()
    faces = faces[keep]
    used, inv = np.unique(faces.reshape(-1), return_inverse=True)
    return vertices[used], inv.reshape(-1, 3)


def reconstruct_mesh(
    xyz_normalized: np.ndarray,
    geo_from: str = "hoppe",
    grid_res: int = 128,
    target_faces: int = 10000,
    noise_stddev: Optional[float] = None,
    poco_apply=None,
    smooth_mesh: bool = False,
    refine_iters: int = 10,
    iso_method: str = "mc",
    screen_weight: float = 2.0,
    device="cuda",
    timer=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud (normalized to [-0.5, 0.5]) -> (vertices, faces).

    `poco_apply` (models.occupancy.load_poco_field) maps the cloud to its
    occupancy field [M, 3] -> [M] (negative inside); geo_from='POCO' uses
    it.  `refine_iters` bisects the iso-vertices against the analytic
    field (POCO and hoppe: the Poisson field exists only on the grid,
    where linear interpolation along the edges is already exact).
    `timer` (a StageTimer) records the sub-stages as
    'geometry.<part>'."""
    def part(name):
        return (timer.stage(f"geometry.{name}") if timer is not None
                else contextlib.nullcontext())

    if iso_method != "mc":
        raise NotImplementedError(
            f"iso_method={iso_method!r}: a later port slice")
    dev = torch.device(device)
    pts = np.asarray(xyz_normalized, np.float32)
    if noise_stddev:
        rng = np.random.default_rng(0)
        pts = pts + rng.normal(0, noise_stddev, pts.shape).astype(np.float32)

    axis = np.linspace(GRID_LO, GRID_HI, grid_res, dtype=np.float32)

    if geo_from == "POCO" and poco_apply is None:
        warnings.warn("geo_from='POCO' but no checkpoint/network supplied; "
                      "falling back to the non-learned 'SPR' backend")
        geo_from = "SPR"

    field_fn = None          # analytic field for vertex refinement
    if geo_from == "POCO":
        with part("poco_encode"):
            field_fn = poco_apply(pts)
        with part("poco_field"):
            field = osdf.eval_sdf_on_grid_banded(field_fn, pts, grid_res,
                                                 GRID_LO, GRID_HI,
                                                 device=dev)
    elif geo_from in ("SPR", "poisson_fft"):
        with part("normals"):
            normals = osdf.estimate_oriented_normals(pts, device=dev)
        with part("poisson"):
            pts01 = (pts - GRID_LO) / (GRID_HI - GRID_LO)
            field = osdf.poisson_indicator_grid(
                torch.as_tensor(pts01, device=dev),
                torch.as_tensor(normals, device=dev), res=grid_res,
                screen_weight=screen_weight)
    elif geo_from == "hoppe":
        with part("normals"):
            normals = osdf.estimate_oriented_normals(pts, device=dev)
        with part("field"):
            pj = torch.as_tensor(pts, device=dev)
            nj = torch.as_tensor(normals, device=dev)
            field_fn = lambda q: osdf.hoppe_sdf(q, pj, nj)  # noqa: E731
            field = osdf.eval_sdf_on_grid_banded(field_fn, pts, grid_res,
                                                 GRID_LO, GRID_HI,
                                                 device=dev)
    else:
        raise ValueError(f"unknown geo_from={geo_from}")

    with part("marching_cubes"):
        verts, faces, edge_keys = oiso.marching_cubes(
            torch.as_tensor(field, device=dev), axis, return_edge_keys=True)
    if field_fn is not None and refine_iters > 0 and len(verts):
        with part("refine"):
            verts = oiso.refine_vertices_bisection(
                field_fn, verts, edge_keys, field, axis, refine_iters,
                device=dev)
    if len(faces) == 0:
        if geo_from != "hoppe":
            warnings.warn(f"{geo_from} produced an empty iso-surface; "
                          "retrying with 'hoppe'")
            return reconstruct_mesh(xyz_normalized, "hoppe", grid_res,
                                    target_faces, None, None, smooth_mesh,
                                    iso_method=iso_method, device=device,
                                    timer=timer)
        raise RuntimeError("iso-surface extraction produced no triangles")
    with part("qem"):
        verts, faces = largest_component(verts, faces)
        verts, faces = oqem.simplify(verts, faces, target_faces)
    if smooth_mesh:
        verts = taubin_smooth(verts, faces)
    return verts.astype(np.float32), faces.astype(np.int64)
