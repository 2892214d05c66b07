"""Synthetic inputs made inside the repo: a gridded unit cube mesh and a
coloured cloud sampled on its surface (the port's own copies of
eval/selfparity.py's analytic colour field and cube sampling)."""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from . import io as pio


def analytic_color(p: np.ndarray) -> np.ndarray:
    """Smooth low-frequency RGB field on [-0.5, 0.5]^3 -> [0,1]^3."""
    p = np.asarray(p, np.float64)
    r = 0.5 + 0.45 * np.sin(2.0 * np.pi * p[..., 0])
    g = np.clip(p[..., 1] + 0.5, 0.0, 1.0)
    b = 0.5 + 0.45 * np.cos(2.0 * np.pi * (p[..., 2] + p[..., 0]))
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def cube_cloud(n: int = 30000, seed: int = 0, color_fn=analytic_color):
    """Uniform samples on the unit-cube surface with analytic colours."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, 6, n)
    uv = rng.random((n, 2)).astype(np.float64) - 0.5
    axis = face % 3
    sign = np.where(face < 3, 0.5, -0.5)
    pts = np.zeros((n, 3), np.float64)
    rows = np.arange(n)
    other = np.array([[1, 2], [0, 2], [0, 1]])[axis]
    pts[rows, axis] = sign
    pts[rows, other[:, 0]] = uv[:, 0]
    pts[rows, other[:, 1]] = uv[:, 1]
    return pts.astype(np.float32), color_fn(pts).astype(np.float32)


def cube_mesh(n_div: int = 40) -> Tuple[np.ndarray, np.ndarray]:
    """Unit cube [-0.5, 0.5]^3, each side an n_div x n_div grid of quads
    split in two triangles (6 * 2 * n_div^2 faces), wound outward."""
    t = np.linspace(-0.5, 0.5, n_div + 1)
    verts, faces = [], []
    for axis in range(3):
        o1, o2 = [a for a in range(3) if a != axis]
        for sign in (0.5, -0.5):
            u, v = np.meshgrid(t, t, indexing="ij")
            p = np.zeros((n_div + 1, n_div + 1, 3))
            p[..., axis] = sign
            p[..., o1] = u
            p[..., o2] = v
            base = sum(len(x) for x in verts)
            verts.append(p.reshape(-1, 3))
            idx = base + np.arange((n_div + 1) ** 2).reshape(n_div + 1,
                                                              n_div + 1)
            a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
            c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
            tri = np.concatenate([np.stack([a, b, c], 1),
                                  np.stack([a, c, d], 1)])
            pv = p.reshape(-1, 3)
            n = np.cross(pv[tri[:, 1] - base] - pv[tri[:, 0] - base],
                         pv[tri[:, 2] - base] - pv[tri[:, 0] - base])
            if (n[:, axis] * sign).mean() < 0:
                tri = tri[:, ::-1]
            faces.append(tri)
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int64))


def write_cube_inputs(out_dir: str, n_div: int = 40, n_points: int = 30000,
                      seed: int = 0, with_mesh: bool = True) -> str:
    """Write <out_dir>/cube.ply and, with `with_mesh`, the cached mesh
    <out_dir>/cube_untextured_mesh.obj; returns the .ply path."""
    os.makedirs(out_dir, exist_ok=True)
    if with_mesh:
        v, f = cube_mesh(n_div)
        pio.save_obj(v, f, os.path.join(out_dir, "cube_untextured_mesh.obj"))
    pts, col = cube_cloud(n_points, seed)
    ply = os.path.join(out_dir, "cube.ply")
    pio.save_colored_pc_ply(pts, col, ply)
    return ply


def raster_edge_scene(n_views: int, res: int, n_small: int = 2000,
                      seed: int = 0):
    """A rasterizer scene of the cases a face binning has to get right, in
    NDC, every face on its own three vertices: (ndc [V,N,2] f32, depth
    [V,N] f32, faces [F,3] int32).  Per view: `n_small` random triangles
    of 4-20 pixels in both windings, a screen-filling quad (two faces,
    deepest, sharing a diagonal of exact z ties), 24 big triangles of
    32-200 pixels (around the binning's M tiles and far above it), a long
    zero-area sliver and a triangle with a NaN corner; the big faces and
    the quad face the camera (negative signed area, kept by culling).  The
    last view holds every face off screen."""
    rng = np.random.default_rng(seed)
    px = 2.0 / res                                 # one pixel in NDC

    def tris(n, lo, hi):
        c = rng.uniform(-0.9, 0.9, (n_views, n, 1, 2))
        size = rng.uniform(lo, hi, (n_views, n, 1, 1)) * px
        ang = rng.uniform(0, 2 * np.pi, (n_views, n, 1, 1)) + np.array(
            [0.0, 2.1, 4.2])[None, None, :, None]
        return c + np.concatenate([np.cos(ang), np.sin(ang)], -1) * size

    small = tris(n_small, 4, 20)
    small[:, 1::2] = small[:, 1::2, ::-1]             # both windings
    big = tris(24, 16, 100)
    quad = np.broadcast_to(np.array(
        [[[-1, -1], [-1, 1], [1, 1]], [[-1, -1], [1, 1], [1, -1]]],
        np.float64), (n_views, 2, 3, 2))
    sliver = np.broadcast_to(np.array(               # x == y: area 0
        [[[-0.8, -0.8], [0.8, 0.8], [0.1, 0.1]]]), (n_views, 1, 3, 2))
    nan = np.broadcast_to(np.array(
        [[[0.1, 0.1], [np.nan, 0.2], [0.2, 0.3]]]), (n_views, 1, 3, 2))
    tri = np.concatenate([small, big, quad, sliver, nan], 1)
    e1, e2 = tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :]
    back = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0] > 0
    back[:, :n_small] = False                         # keep both windings
    tri[back] = tri[back][:, ::-1]
    tri[-1] += 10.0                                   # an empty view
    F = tri.shape[1]
    depth = np.concatenate([rng.uniform(0.5, 3.0, (n_views, n_small)),
                            rng.uniform(1.0, 4.0, (n_views, 24)),
                            np.full((n_views, 2), 5.0),
                            np.full((n_views, 2), 2.0)], 1)
    depth = depth[..., None] + rng.uniform(-0.1, 0.1, (n_views, F, 3))
    depth[:, n_small + 24:n_small + 26] = 5.0         # the quad's one plane
    faces = np.arange(F * 3, dtype=np.int32).reshape(F, 3)
    return (tri.reshape(n_views, F * 3, 2).astype(np.float32),
            depth.reshape(n_views, F * 3).astype(np.float32), faces)
