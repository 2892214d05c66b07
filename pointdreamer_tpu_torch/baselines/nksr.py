"""Kernel-field surface reconstruction baseline, the NKSR model class (twin
of baselines/nksr.py; reference baselines/NKSR.py).

NKSR fits f(x) = sum_j alpha_j K(x, c_j) to on / off surface constraints
with a learned kernel; no learned kernel ships, so this is the same model
class with the analytic biharmonic kernel phi(r) = r plus a linear
polynomial tail (Carr et al. 2001):

- nodes: a voxel-stride subsample of the cloud (a uniform random
  supplement up to the budget), their +eps normal offsets, and a far ring
  pinned to its distance to the cloud (kNN through ops/knn.py);
- constraints: interpolation at the nodes, f = 0 on the surface, +eps at
  the offsets;
- solve: the dense saddle system [K P; P^T 0] in float64 by
  `torch.linalg.solve` on the field's device (LU).  Duplicate nodes (a
  cloud with repeated points) would make it singular, so nodes are
  deduplicated first, and `recon_one_shape_NKSR` deduplicates the cloud
  before anything else (the JAX package's np.linalg.solve raises
  "Singular matrix" there);
- evaluation: [chunk, N] kernel blocks streamed on the device, each one
  matmul plus rank-1 terms (|x - c|^2 = |x|^2 - 2 x.c + |c|^2) and a
  sqrt, in fp32;
- extraction: the field on a dense grid, marching cubes (ops/iso.py),
  `mise_iter` damped Newton steps of the vertices against the continuous
  field, the largest component, optionally the QEM (ops/qem.py), and kNN
  inverse-distance colours (the PCNN colour field's math).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["fit_kernel_field", "recon_one_shape_NKSR"]


def _phi_block(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """phi(|x - c|) = |x - c| for x [M,3], c [N,3] -> [M,N]: one matmul and
    rank-1 terms, then a sqrt."""
    d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * (x @ c.T)
          + (c * c).sum(-1)[None, :])
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _field(q: torch.Tensor, nodes: torch.Tensor, w: torch.Tensor,
           chunk: int) -> torch.Tensor:
    """f(q) = phi(q, nodes) @ alpha + b0 + q . b for q [M,3] (the design
    matrix [phi | 1 | x] times w), in [chunk, N] blocks."""
    n = nodes.shape[0]
    a, b = w[:n], w[n:]
    out = [_phi_block(qb, nodes) @ a + b[0] + qb @ b[1:]
           for qb in torch.split(q, chunk)]
    return torch.cat(out) if out else q.new_zeros((0,))


def _first_unique(rows: np.ndarray) -> np.ndarray:
    """Indices of each distinct row's first occurrence, in order."""
    _, first = np.unique(rows, axis=0, return_index=True)
    return np.sort(first)


def _subsample_centers(pts: np.ndarray, max_centers: int,
                       seed: int = 0) -> np.ndarray:
    """Voxel-stride subsample indices: one point per occupied voxel at the
    finest resolution with at most `max_centers` cells, plus a uniform
    random supplement up to the budget."""
    if len(pts) <= max_centers:
        return np.arange(len(pts))
    lo, hi = pts.min(0) - 1e-6, pts.max(0) + 1e-6
    best = None
    res = 16
    while res < 512:
        cell = np.floor((pts - lo) / (hi - lo) * res).astype(np.int64)
        key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, first = np.unique(key, return_index=True)
        if len(uniq) > max_centers:
            break
        best = first
        res *= 2
    rng = np.random.default_rng(seed)
    if best is None:                    # even 16^3 overflows
        return rng.choice(len(pts), max_centers, replace=False)
    if len(best) > max_centers:
        best = rng.choice(best, max_centers, replace=False)
    elif len(best) < max_centers:
        rest = np.setdiff1d(np.arange(len(pts)), best)
        extra = rng.choice(rest, min(max_centers - len(best), len(rest)),
                           replace=False)
        best = np.concatenate([best, extra])
    return best


def _parts(timer):
    def part(name):
        return (timer.stage(name) if timer is not None
                else contextlib.nullcontext())
    return part


class KernelField:
    """f(x) = sum_j alpha_j |x - c_j| + b0 + b.x on `nodes` (positive
    outside); call it with [M,3] (numpy or a tensor) for f [M] on the
    field's device, `chunk` rows a block (None: 4096 on the card, as the
    JAX package; 128 on the CPU, where a [128, N] block stays in cache:
    7x faster than 4096 rows on an 8-core x86 host).  The values do not
    depend on it."""

    def __init__(self, nodes: torch.Tensor, w: torch.Tensor,
                 chunk: Optional[int] = None):
        self.nodes, self.w = nodes, w
        self.chunk = chunk or (4096 if nodes.device.type == "cuda" else 128)

    def __call__(self, q) -> torch.Tensor:
        q = torch.as_tensor(q, dtype=torch.float32, device=self.nodes.device)
        return _field(q, self.nodes, self.w, self.chunk)


def fit_kernel_field(xyz: np.ndarray, normals: np.ndarray,
                     max_centers: int = 3072, eps: float = 0.005,
                     n_far: int = 128, smooth: float = 0.0,
                     chunk: Optional[int] = None, seed: int = 0,
                     device="cuda",
                     timer=None) -> Tuple[KernelField, np.ndarray]:
    """Fit the kernel field to the oriented cloud by interpolation at its
    nodes: f = 0 on the on-surface subsample, +eps at p + eps n, the
    distance to the subsample at the far ring, through the saddle system

        [ K + smooth I   P ] [alpha]   [b]
        [     P^T        0 ] [beta ] = [0],   P = [1 | x],

    solved in float64 on `device`.  Returns (the field, its nodes)."""
    from ..ops.knn import knn
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(device)
    part = _parts(timer)
    pts = np.asarray(xyz, np.float32)
    nrm = np.asarray(normals, np.float32)
    idx = _subsample_centers(pts, max_centers, seed)
    p, n = pts[idx], nrm[idx]

    # far-field ring: radius 1.4x the cloud's bounding radius
    rng = np.random.default_rng(seed + 1)
    center = pts.mean(0)
    rad = float(np.linalg.norm(pts - center, axis=1).max())
    d = rng.standard_normal((n_far, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = center + d * (1.4 * rad)
    fd2, _ = knn(torch.as_tensor(far, device=dev),
                 torch.as_tensor(p, device=dev), k=1)
    far_val = torch.sqrt(fd2[:, 0]).double()

    nodes_np = np.concatenate([p, p + eps * n, far]).astype(np.float32)
    b = torch.cat([torch.zeros(2 * len(p), dtype=torch.float64, device=dev),
                   far_val])
    b[len(p):2 * len(p)] = eps
    keep = _first_unique(nodes_np)
    nodes_np = nodes_np[keep]
    nodes = torch.as_tensor(nodes_np, device=dev)
    b = b[torch.as_tensor(keep, device=dev)]
    M = len(nodes_np)

    with part("nksr.solve"):
        K = _phi_block(nodes, nodes).double()
        if smooth:
            K += smooth * torch.eye(M, dtype=torch.float64, device=dev)
        P = torch.cat([torch.ones((M, 1), dtype=torch.float64, device=dev),
                       nodes.double()], 1)
        A = torch.zeros((M + 4, M + 4), dtype=torch.float64, device=dev)
        A[:M, :M] = K
        A[:M, M:] = P
        A[M:, :M] = P.T
        rhs = torch.cat([b, torch.zeros(4, dtype=torch.float64, device=dev)])
        sol = torch.linalg.solve(A, rhs)
    return KernelField(nodes, sol.float(), chunk), nodes_np


def _dedupe_cloud(pts: np.ndarray, rgb01: Optional[np.ndarray]):
    keep = _first_unique(pts)
    if len(keep) == len(pts):
        return pts, rgb01
    return pts[keep], (None if rgb01 is None else np.asarray(rgb01)[keep])


def recon_one_shape_NKSR(xyz: np.ndarray, rgb01: Optional[np.ndarray] = None,
                         grid_res: int = 128, simplify_face_num: int = 0,
                         mise_iter: int = 2, color_knn: int = 3,
                         max_centers: int = 4096, device="cuda", timer=None,
                         eps: float = 0.005, n_far: int = 128,
                         smooth: float = 0.0, chunk: Optional[int] = None,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                                 Optional[np.ndarray]]:
    """Coloured cloud (normalized to [-0.5, 0.5]) -> (verts, faces, vertex
    colours or None), the reference flow of NKSR.py:96-168: normals, the
    kernel field, extraction and refinement, colours.  `eps`, `n_far`,
    `smooth`, `chunk` and `seed` go to `fit_kernel_field`.  A cloud with
    repeated points is reconstructed as its deduplicated cloud (the first
    of each point and its colour).  `timer` (a StageTimer) records
    'nksr.<part>'."""
    from ..ops import iso as oiso
    from ..ops import qem as oqem
    from ..ops.knn import knn
    from ..ops.sdf import estimate_oriented_normals
    from ..pipeline.geometry import largest_component
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(device)
    part = _parts(timer)
    pts, rgb01 = _dedupe_cloud(np.asarray(xyz, np.float32), rgb01)
    with part("nksr.normals"):
        normals = estimate_oriented_normals(pts, device=dev)
    field, _ = fit_kernel_field(pts, normals, max_centers=max_centers,
                                eps=eps, n_far=n_far, smooth=smooth,
                                chunk=chunk, seed=seed, device=dev,
                                timer=timer)

    lo, hi = -0.6, 0.6
    axis = np.linspace(lo, hi, grid_res, dtype=np.float32)
    with part("nksr.grid"):
        ax = torch.as_tensor(axis, device=dev)
        g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                        -1).reshape(-1, 3)
        vals = field(g).reshape(grid_res, grid_res, grid_res)
        del g
    with part("nksr.marching_cubes"):
        verts, faces = oiso.marching_cubes(vals, axis)

    if mise_iter > 0 and len(verts):
        # the reference's extract_dual_mesh(mise_iter=2): damped Newton
        # steps of the vertices along the central-difference gradient of
        # the continuous field, each bounded by half a cell, then halved
        with part("nksr.refine"):
            h = (hi - lo) / (grid_res - 1)
            step = 0.5 * h
            offs = torch.eye(3, device=dev) * np.float32(0.5 * h)
            v = torch.as_tensor(verts, device=dev)
            for _ in range(mise_iter):
                f0 = field(v)
                grad = torch.stack([field(v + offs[i]) - field(v - offs[i])
                                    for i in range(3)], -1) / h
                gnorm = torch.linalg.vector_norm(grad, dim=-1)
                gn = grad / torch.clamp(gnorm, min=1e-9)[:, None]
                gmag = torch.clamp(gnorm, min=1e-9)
                v = v - gn * torch.clamp(f0 / gmag, -step, step)[:, None]
                step *= 0.5
            verts = v.cpu().numpy()

    if len(faces):
        # spurious zero-crossing shells in the loosely constrained band
        # between the far ring and the surface: keep the dominant component
        verts, faces = largest_component(verts, faces)
    if simplify_face_num and len(faces) > simplify_face_num:
        with part("nksr.qem"):
            verts, faces = oqem.simplify(verts, faces, simplify_face_num)

    colors = None
    if rgb01 is not None and len(verts):
        # PCNNField: the input colours at the vertices, kNN IDW
        with part("nksr.color"):
            d2, idx = knn(torch.as_tensor(verts, device=dev),
                          torch.as_tensor(pts, device=dev), k=color_knn)
            w = 1.0 / torch.clamp(d2, min=1e-12)
            w = w / w.sum(-1, keepdim=True)
            cols = torch.as_tensor(np.asarray(rgb01, np.float32),
                                   device=dev)[idx]
            colors = (w[..., None] * cols).sum(1).cpu().numpy()
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int64),
            colors)
