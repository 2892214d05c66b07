"""Point-cloud implicit surfaces (twin of ops/sdf.py): PCA normals with a
minimum-spanning-tree orientation, the Hoppe tangent-plane SDF and the
screened Poisson indicator grid, plus the dense/banded grid evaluators.

  - 'hoppe':  f(x) = inverse-distance-weighted mean of n_i . (x - p_i)
              over the k nearest samples (Hoppe et al. '92).
  - 'poisson_fft': splat the oriented normals into a grid and solve the
              screened Poisson system (-lap + lam w) chi = -div V
              (Kazhdan & Hoppe 2013): torch.fft for the smoothing and the
              inverse Laplacian, preconditioned CG for the screening term.

kNN and PCA run on the tensors' device; the MST orientation runs on the
host with scipy.  The trilinear splats accumulate in float64 and round to
float32 once, so the atomic adds of `index_add_` on the card leave the
grid the same from run to run (a float64 sum of ~1e2 terms is off by
~1e-14 relative, far below float32's rounding step).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .knn import knn


# --------------------------------------------------------------------------
# Normal estimation (device) + orientation (host MST)
# --------------------------------------------------------------------------

def _smallest_eigvec_3x3(cov: torch.Tensor) -> torch.Tensor:
    """Batched closed-form smallest eigenvector of symmetric 3x3 matrices
    (trigonometric eigenvalues + row-cross eigenvectors)."""
    a00, a01, a02 = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
    a11, a12, a22 = cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22
                    + 2 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0 + 1e-30)
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = (c00 * (c11 * c22 - c12 * c12)
                - c01 * (c01 * c22 - c12 * c02)
                + c02 * (c01 * c12 - c11 * c02)) * 0.5
    half_det = half_det.clamp(-1.0, 1.0)
    angle = torch.arccos(half_det) / 3.0
    lam = q + 2.0 * p * torch.cos(angle + 2.0 * math.pi / 3.0)

    r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
    c0 = torch.linalg.cross(r0, r1)
    c1 = torch.linalg.cross(r0, r2)
    c2 = torch.linalg.cross(r1, r2)
    n = torch.stack([(c * c).sum(-1) for c in (c0, c1, c2)], dim=-1)
    best = torch.argmax(n, dim=-1)[..., None]
    v = torch.where(best == 0, c0, torch.where(best == 1, c1, c2))
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-20)


def pca_normals_from_idx(points: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """PCA normals [N,3] from precomputed kNN indices [N,k]."""
    nbrs = points[idx]                                  # [N,k,3]
    cent = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", cent, cent) / idx.shape[1]
    return _smallest_eigvec_3x3(cov)


def estimate_normals_pca(points: torch.Tensor, k: int = 16) -> torch.Tensor:
    """Unoriented normals = smallest eigenvector of the local covariance."""
    _, idx = knn(points, points, k)
    return pca_normals_from_idx(points, idx)


def orient_normals_mst(points: np.ndarray, normals: np.ndarray,
                       k: int = 12,
                       knn_idx: np.ndarray = None) -> np.ndarray:
    """Flip normals to a globally consistent orientation (host, scipy).

    Signs propagate along a minimum spanning tree of the kNN graph weighted
    by 1 - |n_i . n_j|: s(node) is the product of edge signs on its tree
    path, an XOR prefix computed by pointer doubling.  The global sign is a
    majority vote over the 20 extreme points of each of the 6 axis
    directions.  `knn_idx` [N, >=k+1] (self first) skips the kNN pass."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import (breadth_first_order,
                                      minimum_spanning_tree)

    pts = np.asarray(points, np.float64)
    nrm = np.asarray(normals, np.float64)
    n = len(pts)
    if knn_idx is None:
        p = torch.as_tensor(pts, dtype=torch.float32)
        knn_idx = knn(p, p, k + 1)[1].numpy()
    idx = np.asarray(knn_idx)[:, 1:k + 1]
    rows = np.repeat(np.arange(n), idx.shape[1])
    cols = idx.reshape(-1)
    w = 1.0 - np.abs((nrm[rows] * nrm[cols]).sum(-1))
    g = coo_matrix((w + 1e-9, (rows, cols)), shape=(n, n))
    mst = minimum_spanning_tree(g)
    mst = mst + mst.T
    seed = int(np.argmax(pts[:, 1]))
    order, preds = breadth_first_order(mst, seed, directed=False)

    child = order[preds[order] >= 0]
    par_of_child = preds[child]
    parent = np.arange(n)              # root/unreached nodes point at self
    parent[child] = par_of_child
    bit = np.zeros(n, np.int8)
    bit[child] = (nrm[child] * nrm[par_of_child]).sum(-1) < 0
    while np.any(parent != parent[parent]):
        bit ^= bit[parent]
        parent = parent[parent]
    bit ^= bit[parent]                 # fold in the final parent's bit
    sign = np.where(bit, -1.0, 1.0)
    oriented = nrm * sign[:, None]
    m = min(20, n)
    vote = 0.0
    for axis in range(3):
        for d in (1.0, -1.0):
            ext = np.argpartition(d * pts[:, axis], -m)[-m:]
            vote += float(np.sum(np.sign(oriented[ext, axis] * d)))
    if vote < 0:
        sign = -sign
    return (nrm * sign[:, None]).astype(np.float32)


def estimate_oriented_normals(points: np.ndarray, k_pca: int = 16,
                              k_mst: int = 12, device="cuda") -> np.ndarray:
    """One shared kNN pass (on `device`) feeds both PCA and the host MST.
    The JAX package's opt-in visibility refinement is not ported."""
    p = torch.as_tensor(np.asarray(points, np.float32), device=device)
    _, idx = knn(p, p, max(k_pca, k_mst + 1))
    nrm = pca_normals_from_idx(p, idx[:, :k_pca]).cpu().numpy()
    return orient_normals_mst(points, nrm, k_mst,
                              knn_idx=idx[:, :k_mst + 1].cpu().numpy())


# --------------------------------------------------------------------------
# Hoppe signed distance
# --------------------------------------------------------------------------

def hoppe_sdf(query: torch.Tensor, points: torch.Tensor,
              normals: torch.Tensor, k: int = 8) -> torch.Tensor:
    """Signed distance [M]: inverse-distance-weighted mean of tangent-plane
    distances over the k nearest points.  Negative = inside."""
    d2, idx = knn(query, points, k)
    plane = ((query[:, None, :] - points[idx]) * normals[idx]).sum(-1)
    wgt = 1.0 / (d2 + 1e-6)
    return (plane * wgt).sum(-1) / wgt.sum(-1)


# --------------------------------------------------------------------------
# FFT Poisson indicator field
# --------------------------------------------------------------------------

def _trilinear_scatter(grid: torch.Tensor, pts01: torch.Tensor,
                       vals: torch.Tensor, res: int) -> torch.Tensor:
    """Scatter vals [N,C] at continuous grid coords pts01*(res-1) into
    grid [R,R,R,C] with trilinear weights.  Accumulates in float64 (see
    the module docstring) and returns the grid's dtype."""
    g = pts01 * (res - 1)
    g0f = torch.floor(g)
    g0 = g0f.long()
    frac = g - g0f
    acc = torch.zeros((res * res * res, grid.shape[-1]), dtype=torch.float64,
                      device=grid.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                ix = (g0[:, 0] + dx).clamp(0, res - 1)
                iy = (g0[:, 1] + dy).clamp(0, res - 1)
                iz = (g0[:, 2] + dz).clamp(0, res - 1)
                flat = (ix * res + iy) * res + iz
                acc.index_add_(0, flat, (w[:, None] * vals).double())
    return grid + acc.view(grid.shape).to(grid.dtype)


def poisson_indicator_grid(points01: torch.Tensor, normals: torch.Tensor,
                           res: int = 128, smooth_sigma: float = 1.5,
                           screen_weight: float = 0.0,
                           screen_iters: int = 48) -> torch.Tensor:
    """(Optionally screened) Poisson indicator chi [R,R,R] on the grid,
    negative inside, shifted so ~0 lies at the input samples.

    points01 [N,3] in [0,1] (grid frame), normals [N,3] outward.  The
    unscreened solve is spectral; with `screen_weight` > 0, `screen_iters`
    preconditioned-CG steps on (-lap + w) chi = -div V start from it, with
    the FFT inverse of (-lap + screen_weight) as the preconditioner and w
    the gaussian-smoothed sample density normalized to `screen_weight` on
    the occupied band.  Computes in the dtype of `points01` (float32 on
    the pipeline's path)."""
    dev, dt = points01.device, points01.dtype
    fftn, ifftn = torch.fft.fftn, torch.fft.ifftn
    vec = _trilinear_scatter(
        torch.zeros((res, res, res, 3), dtype=dt, device=dev),
        points01, -normals, res)

    f = torch.fft.fftfreq(res, device=dev, dtype=dt)
    kx, ky, kz = torch.meshgrid(f, f, f, indexing="ij")
    k2 = kx * kx + ky * ky + kz * kz
    gauss = torch.exp(-2.0 * (math.pi ** 2) * (smooth_sigma ** 2) * k2)

    Vx = fftn(vec[..., 0]) * gauss
    Vy = fftn(vec[..., 1]) * gauss
    Vz = fftn(vec[..., 2]) * gauss
    div = (2j * math.pi) * (kx * Vx + ky * Vy + kz * Vz)
    lap = 4.0 * (math.pi ** 2) * k2                  # -lap in fourier
    pos = k2 > 0
    inv_lap = torch.where(pos, 1.0 / torch.where(pos, lap, 1.0), 0.0)
    chi = ifftn(div * inv_lap).real                  # unscreened solution

    if screen_weight > 0.0 and screen_iters > 0:
        dens = _trilinear_scatter(
            torch.zeros((res, res, res, 1), dtype=dt, device=dev),
            points01, torch.ones((points01.shape[0], 1), dtype=dt,
                                 device=dev), res)[..., 0]
        dens = ifftn(fftn(dens) * gauss).real.clamp(min=0.0)
        band_mean = (dens * dens).sum() / dens.sum().clamp(min=1e-20)
        w = dens * (screen_weight / band_mean.clamp(min=1e-20))
        b = ifftn(div).real                          # -div V in real space

        def A(x):
            return ifftn(lap * fftn(x)).real + w * x

        def Minv(r):
            return ifftn(fftn(r) / (lap + screen_weight)).real

        r = b - A(chi)
        z = Minv(r)
        p = z
        rz = (r * z).sum()
        for _ in range(screen_iters):
            Ap = A(p)
            alpha = rz / (p * Ap).sum().clamp(min=1e-30)
            chi = chi + alpha * p
            r = r - alpha * Ap
            z = Minv(r)
            rz_new = (r * z).sum()
            p = z + (rz_new / rz.clamp(min=1e-30)) * p
            rz = rz_new

    # iso level = mean chi at the (rounded, half to even) sample positions
    gi = torch.round(points01 * (res - 1)).long().clamp(0, res - 1)
    level = chi[gi[:, 0], gi[:, 1], gi[:, 2]].mean()
    return chi - level


# --------------------------------------------------------------------------
# Grid evaluation helpers
# --------------------------------------------------------------------------

def make_grid_coords(res: int, lo: float = -0.6, hi: float = 0.6):
    """Dense [R^3, 3] grid covering the normalized unit cube with margin."""
    axis = np.linspace(lo, hi, res, dtype=np.float32)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1)
    return g.reshape(-1, 3), axis


def eval_sdf_on_grid(sdf_fn, res: int, lo=-0.6, hi=0.6,
                     chunk: int = 65536, device="cuda") -> np.ndarray:
    """An [M,3] -> [M] field function over the dense grid, in chunks."""
    coords, _ = make_grid_coords(res, lo, hi)
    out = np.empty((coords.shape[0],), np.float32)
    for i in range(0, coords.shape[0], chunk):
        c = torch.as_tensor(coords[i:i + chunk], device=device)
        out[i:i + chunk] = sdf_fn(c).cpu().numpy()
    return out.reshape(res, res, res)


def eval_sdf_on_grid_banded(sdf_fn, points: np.ndarray, res: int,
                            lo=-0.6, hi=0.6, band: int = 3,
                            chunk: int = 65536, device="cuda") -> np.ndarray:
    """The field in a `band`-voxel shell around the input points and
    wherever the trilinear-upsampled coarse (res//4) field comes near
    zero; elsewhere the upsampled coarse field."""
    from scipy.ndimage import binary_dilation

    coarse_res = max(res // 4, 16)
    coarse = eval_sdf_on_grid(sdf_fn, coarse_res, lo, hi, chunk, device)
    t = np.arange(res) * (coarse_res - 1) / (res - 1)
    i0 = np.clip(np.floor(t).astype(np.int64), 0, coarse_res - 2)
    fr = (t - i0).astype(np.float32)

    def lerp_axis(a, ax):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[ax] = i0
        sl1[ax] = i0 + 1
        shape = [1, 1, 1]
        shape[ax] = res
        f = fr.reshape(shape)
        return a[tuple(sl0)] * (1 - f) + a[tuple(sl1)] * f

    far = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)

    span = hi - lo
    cell = np.clip(((points - lo) / span * (res - 1)).astype(np.int64),
                   0, res - 1)
    mask = np.zeros((res, res, res), bool)
    mask[cell[:, 0], cell[:, 1], cell[:, 2]] = True
    mask = binary_dilation(mask, iterations=band)
    tau = 2.0 * span / res
    mask |= binary_dilation(np.abs(far) < tau, iterations=1)

    flat_ids = np.nonzero(mask.reshape(-1))[0]
    coords, _ = make_grid_coords(res, lo, hi)
    q = coords[flat_ids]
    vals = np.empty(len(q), np.float32)
    for i in range(0, len(q), chunk):
        vals[i:i + chunk] = sdf_fn(torch.as_tensor(q[i:i + chunk],
                                                   device=device)
                                   ).cpu().numpy()
    out = far.astype(np.float32).reshape(-1)
    out[flat_ids] = vals
    return out.reshape(res, res, res)
