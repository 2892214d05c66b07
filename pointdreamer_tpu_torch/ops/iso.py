"""Iso-surface extraction (twin of ops/iso.py): 256-case marching cubes
on the field's device, then the vertex weld.

  1. active cells: cubes whose 8 corners hold both signs (< 0 inside),
  2. stable compaction of the active cells in ascending flat order,
  3. emission from the generated table (ops/mc_table.py): up to 5
     triangles a cube, vertices on the 12 axis-aligned cube edges,
     winding inside -> outside baked into the table,
  4. weld by global edge key lo * R^3 + hi (lo < hi grid corner ids).

The output order is the JAX package's: vertices in ascending edge key
(what np.unique over the keys gives), faces in ascending active-cell
order and, within a cell, table order.  QEM's result depends on its input
order, so the order is part of the contract.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mc_table import CORNER_XYZ, EDGES, MC_TABLE


def active_cell_mask(values: torch.Tensor) -> torch.Tensor:
    """[R-1]^3 bool: the cube has both signs among its 8 corners."""
    r = values.shape[0] - 1
    vmin = vmax = values[:-1, :-1, :-1]
    for o in CORNER_XYZ[1:]:
        s = values[o[0]:r + o[0], o[1]:r + o[1], o[2]:r + o[2]]
        vmin = torch.minimum(vmin, s)
        vmax = torch.maximum(vmax, s)
    return (vmin < 0.0) & (vmax >= 0.0)


def _emit(values: torch.Tensor, axis: torch.Tensor, cells: torch.Tensor):
    """Triangles of the active cells [A] (flat ids over the (R-1)^3 cube
    grid): positions [A,T,3,3], corner edge ids lo/hi [A,T,3] int64 and
    validity [A,T]."""
    res = values.shape[0]
    dev = values.device
    rm1 = res - 1
    base = torch.stack([cells // (rm1 * rm1), (cells // rm1) % rm1,
                        cells % rm1], dim=-1)                   # [A,3]
    ijk = base[:, None, :] + torch.as_tensor(CORNER_XYZ, device=dev).long()
    gid = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]  # [A,8]
    val = values[ijk[..., 0], ijk[..., 1], ijk[..., 2]]          # [A,8]
    pos = axis[ijk]                                              # [A,8,3]

    weights = (1 << torch.arange(8, device=dev))
    case = ((val < 0.0).long() * weights).sum(-1)                # [A]
    tri_e = torch.as_tensor(MC_TABLE, device=dev).long()[case]   # [A,T,3]
    valid = tri_e[..., 0] >= 0
    ep = torch.as_tensor(EDGES, device=dev).long()[tri_e.clamp(min=0)]
    ca, cb = ep[..., 0], ep[..., 1]                              # [A,T,3]

    A = cells.shape[0]
    flat_a = ca.reshape(A, -1)
    flat_b = cb.reshape(A, -1)
    a_val = torch.gather(val, 1, flat_a).view(ca.shape)
    b_val = torch.gather(val, 1, flat_b).view(cb.shape)
    a_gid = torch.gather(gid, 1, flat_a).view(ca.shape)
    b_gid = torch.gather(gid, 1, flat_b).view(cb.shape)
    a_pos = torch.gather(pos, 1, flat_a[..., None].expand(-1, -1, 3)
                         ).view(ca.shape + (3,))
    b_pos = torch.gather(pos, 1, flat_b[..., None].expand(-1, -1, 3)
                         ).view(cb.shape + (3,))

    d = a_val - b_val
    t = a_val / torch.where(d.abs() > 1e-12, d, torch.ones_like(d))
    t = t.clamp(0.0, 1.0)[..., None]
    vpos = a_pos + t * (b_pos - a_pos)                           # [A,T,3,3]
    return vpos, torch.minimum(a_gid, b_gid), torch.maximum(a_gid, b_gid), \
        valid


def marching_cubes(values, axis, return_edge_keys: bool = False
                   ) -> Tuple[np.ndarray, ...]:
    """Zero level set of values [R,R,R] (tensor or array) sampled at axis
    coords [R].  Returns (vertices [V,3] float32, faces [F,3] int64) with
    welded vertices and inside -> outside winding; with
    `return_edge_keys` also the per-vertex edge key [V] int64
    (lo * R^3 + hi) that `refine_vertices_bisection` decodes."""
    vals = torch.as_tensor(values, dtype=torch.float32)
    dev = vals.device
    res = vals.shape[0]
    ax = torch.as_tensor(np.asarray(axis, np.float32), device=dev)
    cells = torch.nonzero(active_cell_mask(vals).reshape(-1))[:, 0]
    if cells.numel() == 0:
        empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
        return empty + (np.zeros((0,), np.int64),) if return_edge_keys \
            else empty
    vpos, lo, hi, valid = _emit(vals, ax, cells)
    tid = torch.nonzero(valid.reshape(-1))[:, 0]    # cell order, then table
    tri_pos = vpos.reshape(-1, 3, 3)[tid]
    keys = (lo.reshape(-1, 3)[tid] * (res ** 3)
            + hi.reshape(-1, 3)[tid]).reshape(-1)   # [3F] int64
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    # each vertex's position from its first occurrence in corner order
    # (every occurrence of an edge computes the same crossing)
    n = keys.shape[0]
    first = torch.full((uniq.shape[0],), n, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(n, device=dev), "amin")
    verts = tri_pos.reshape(-1, 3)[first].cpu().numpy()
    faces = inv.view(-1, 3).cpu().numpy().astype(np.int64)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    verts = np.ascontiguousarray(verts, np.float32)
    if return_edge_keys:
        return verts, faces[good], uniq.cpu().numpy()
    return verts, faces[good]


def refine_vertices_bisection(field_fn, verts: np.ndarray,
                              edge_keys: np.ndarray, values: np.ndarray,
                              axis: np.ndarray, iterations: int = 10,
                              chunk: int = 65536, device="cuda"
                              ) -> np.ndarray:
    """Binary-search every iso-vertex along its grid edge against the true
    field `field_fn` ([M,3] tensor -> [M], negative inside), all vertices
    of a chunk at once.  Returns refined positions [V,3]."""
    values = np.asarray(values)
    res = values.shape[0]
    r3 = np.int64(res) * res * res
    keys = np.asarray(edge_keys, np.int64)
    hi = keys % r3
    lo = keys // r3

    def decode(gid):
        z = gid % res
        y = (gid // res) % res
        x = gid // (res * res)
        return np.stack([axis[x], axis[y], axis[z]], axis=-1), (x, y, z)

    pa, (ax_, ay, az) = decode(lo)
    pb, (bx, by, bz) = decode(hi)
    va = values[ax_, ay, az]
    # orient so f(pa) < 0 <= f(pb)
    swap = va >= 0.0
    pa2 = np.where(swap[:, None], pb, pa)
    pb2 = np.where(swap[:, None], pa, pb)
    pa, pb = pa2.astype(np.float32), pb2.astype(np.float32)

    out = np.empty((len(pa), 3), np.float32)
    for i in range(0, len(pa), chunk):
        a = torch.as_tensor(pa[i:i + chunk], device=device)
        b = torch.as_tensor(pb[i:i + chunk], device=device)
        for _ in range(iterations):
            mid = (a + b) * 0.5
            inside = (field_fn(mid) < 0.0)[:, None]
            a = torch.where(inside, mid, a)
            b = torch.where(inside, b, mid)
        out[i:i + chunk] = ((a + b) * 0.5).cpu().numpy()
    return out
