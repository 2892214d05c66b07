"""Evaluation metrics (twin of eval/metrics.py): texture (PSNR, SSIM,
the Frechet distance of features) and geometry (chamfer, F-score, normal
consistency, Hausdorff, point-in-mesh, IoU).

Reference counterparts:
  PSNR/SSIM      utils/metric_utils/psnr_ssmi.py:44-76 (skimage-backed)
  FID            utils/metric_utils/fid.py:9-81 (the distance only: no
                 Inception weights exist offline)
  chamfer etc.   models/POCO/eval/src/eval.py:28-90 MeshEvaluator
  IoU            eval.py:84-85 check_mesh_contains (libmesh triangle_hash)

PSNR and SSIM run on their tensors' device; the geometry metrics take
numpy arrays and search neighbours / count ray crossings on `device`.
Point-in-mesh is an axis-ray parity test (chunked triangle-crossing
counts) in place of the vendored Cython triangle hash.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.knn import knn


# --------------------------------------------------------------------------
# texture metrics
# --------------------------------------------------------------------------

def psnr(img_a: torch.Tensor, img_b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """[..., H, W, C] pairs -> PSNR per leading batch index."""
    mse = torch.mean((img_a - img_b) ** 2,
                     dim=tuple(range(img_a.dim() - 3, img_a.dim())))
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp(min=1e-12))


def _gaussian_kernel(size=11, sigma=1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img_a: torch.Tensor, img_b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over channels, gaussian 11x11 window, valid positions only
    (the skimage definition psnr_ssmi.py:76 uses).  [H, W, C] -> scalar,
    [B, H, W, C] -> [B]."""
    k = _gaussian_kernel(device=img_a.device)[None, None]   # [1,1,11,11]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):
        b, h, w, c = x.shape
        xc = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
        y = F.conv2d(xc, k)
        return y.reshape(b, c, y.shape[2], y.shape[3]).permute(0, 2, 3, 1)

    squeeze = img_a.dim() == 3
    if squeeze:
        img_a, img_b = img_a[None], img_b[None]
    mu_a = filt(img_a)
    mu_b = filt(img_b)
    saa = filt(img_a * img_a) - mu_a * mu_a
    sbb = filt(img_b * img_b) - mu_b * mu_b
    sab = filt(img_a * img_b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2)))
    out = s.mean(dim=(1, 2, 3))
    return out[0] if squeeze else out


def fid_from_features(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """Frechet distance between gaussian fits of two feature sets
    (reference metric_utils/fid.py:9-81)."""
    import scipy.linalg

    mu1, mu2 = feat_a.mean(0), feat_b.mean(0)
    s1 = np.cov(feat_a, rowvar=False)
    s2 = np.cov(feat_b, rowvar=False)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1 + s2 - 2 * covmean))


# --------------------------------------------------------------------------
# geometry metrics
# --------------------------------------------------------------------------

def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray,
                        n: int, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface samples + their face normals (host)."""
    rng = np.random.default_rng(seed)
    fv = vertices[faces]
    cross = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    area = np.linalg.norm(cross, axis=1) / 2
    nrm = cross / np.maximum(np.linalg.norm(cross, axis=1, keepdims=True),
                             1e-12)
    fid = rng.choice(len(faces), n, p=area / area.sum())
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = (fv[fid, 0] * (1 - u - v) + fv[fid, 1] * u + fv[fid, 2] * v)
    return pts.astype(np.float32), nrm[fid].astype(np.float32)


def _nearest(a: np.ndarray, b: np.ndarray, device) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """For each point of a, (distance, index) of its nearest point of b."""
    d, i = knn(torch.as_tensor(np.asarray(a, np.float32), device=device),
               torch.as_tensor(np.asarray(b, np.float32), device=device), 1)
    return np.sqrt(d[:, 0].cpu().numpy()), i[:, 0].cpu().numpy()


def chamfer_and_fscore(pred_pts, pred_nrm, gt_pts, gt_nrm,
                       fscore_thresh: float = 0.01,
                       device="cuda") -> Dict[str, float]:
    """Symmetric chamfer-L1/L2, normal consistency, F-score
    (MeshEvaluator semantics, eval.py:28-90)."""
    d_pg, i_pg = _nearest(pred_pts, gt_pts, device)
    d_gp, i_gp = _nearest(gt_pts, pred_pts, device)

    nc_pred = np.abs((pred_nrm * gt_nrm[i_pg]).sum(-1)).mean()
    nc_gt = np.abs((gt_nrm * pred_nrm[i_gp]).sum(-1)).mean()
    precision = (d_pg < fscore_thresh).mean()
    recall = (d_gp < fscore_thresh).mean()
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {
        "chamfer_l1": float((d_pg.mean() + d_gp.mean()) / 2),
        "chamfer_l2": float(((d_pg ** 2).mean() + (d_gp ** 2).mean()) / 2),
        "accuracy": float(d_pg.mean()),
        "completeness": float(d_gp.mean()),
        "normal_consistency": float((nc_pred + nc_gt) / 2),
        "precision": float(precision),
        "recall": float(recall),
        "fscore": float(f),
    }


def hausdorff(pred_pts: np.ndarray, gt_pts: np.ndarray,
              device="cuda") -> Dict[str, float]:
    """Directed + symmetric Hausdorff distances (reference
    eval/eval_point2surf/evaluation.py:258-300 protocol)."""
    h_pg = float(_nearest(pred_pts, gt_pts, device)[0].max())
    h_gp = float(_nearest(gt_pts, pred_pts, device)[0].max())
    return {"hausdorff_pred_gt": h_pg, "hausdorff_gt_pred": h_gp,
            "hausdorff": max(h_pg, h_gp)}


def _ray_crossings(queries: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """queries [Q,3], tri [F,3,3] -> per-query +z ray crossing counts."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    q = queries[:, None, :]                      # [Q,1,3]
    # the 2D (x, y) barycentric test
    d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) \
        + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    safe = torch.where(d.abs() > 1e-12, d, torch.ones_like(d))
    w0 = ((b[:, 1] - c[:, 1]) * (q[..., 0] - c[:, 0])
          + (c[:, 0] - b[:, 0]) * (q[..., 1] - c[:, 1])) / safe
    w1 = ((c[:, 1] - a[:, 1]) * (q[..., 0] - c[:, 0])
          + (a[:, 0] - c[:, 0]) * (q[..., 1] - c[:, 1])) / safe
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (d.abs() > 1e-12)
    z = w0 * a[:, 2] + w1 * b[:, 2] + w2 * c[:, 2]
    hit = inside & (z > q[..., 2])
    return hit.sum(dim=1)


def points_in_mesh(queries: np.ndarray, vertices: np.ndarray,
                   faces: np.ndarray, chunk: int = 4096,
                   device="cuda") -> np.ndarray:
    """Ray-parity inside test (replaces libmesh triangle_hash
    check_mesh_contains, eval.py:84-85)."""
    tri = torch.as_tensor(np.asarray(vertices, np.float32)[faces],
                          device=device)
    out = np.zeros(len(queries), bool)
    # irrational xy tie-break offset: rays through shared triangle edges
    # would otherwise double-count crossings
    queries = np.asarray(queries, np.float32) + np.float32(
        [7.3e-5, 3.9e-5, 0.0])
    for i in range(0, len(queries), chunk):
        q = torch.as_tensor(queries[i:i + chunk], device=device)
        out[i:i + chunk] = (_ray_crossings(q, tri) % 2 == 1).cpu().numpy()
    return out


def mesh_iou(pred_v, pred_f, gt_v, gt_f, n_samples: int = 20000,
             seed: int = 0, device="cuda") -> float:
    """Volumetric IoU from uniform bbox samples (eval.py IoU protocol)."""
    rng = np.random.default_rng(seed)
    lo = np.minimum(pred_v.min(0), gt_v.min(0)) - 0.02
    hi = np.maximum(pred_v.max(0), gt_v.max(0)) + 0.02
    q = (rng.random((n_samples, 3)) * (hi - lo) + lo).astype(np.float32)
    in_p = points_in_mesh(q, pred_v, pred_f, device=device)
    in_g = points_in_mesh(q, gt_v, gt_f, device=device)
    union = (in_p | in_g).sum()
    return float((in_p & in_g).sum() / max(union, 1))
