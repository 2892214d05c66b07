"""Texture- and geometry-quality evaluation (twin of eval/run_evaluation.py).

Reference: data/run_evaluation.py (RenderedImageDataset pairs ground-truth
and predicted renders; Tester computes LPIPS/FID/PSNR/SSIM; results are
appended to *_eval_result.txt).  Here: paired PNG directories -> PSNR and
SSIM on `device`, FID through a caller's feature extractor and LPIPS
through a caller's distance (models/perception: load_inception_features,
load_lpips).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import io as pio
from ..pipeline.pipeline import resolve_device
from . import metrics as M


def evaluate_image_dirs(gt_dir: str, pred_dir: str,
                        feature_fn=None, lpips_fn=None,
                        out_file: Optional[str] = None,
                        device="cuda") -> Dict[str, float]:
    """PSNR and SSIM always; FID when `feature_fn` and LPIPS when
    `lpips_fn` are given (the protocol of data/run_evaluation.py:110-372).
    Each gets the paired images as one [N,H,W,3] tensor in [0,1] on
    `device`."""
    dev = resolve_device(device)
    names = sorted(f for f in os.listdir(gt_dir) if f.endswith(".png"))
    gt, pred = [], []
    for n in names:
        p = os.path.join(pred_dir, n)
        if not os.path.exists(p):
            continue
        gt.append(pio.load_rgb(os.path.join(gt_dir, n)))
        pred.append(pio.load_rgb(p))
    if not gt:
        raise FileNotFoundError("no paired PNGs between dirs")
    gt_t = torch.as_tensor(np.stack(gt), device=dev)
    pr_t = torch.as_tensor(np.stack(pred), device=dev)
    res = {
        "n_images": len(gt),
        "psnr": float(M.psnr(pr_t, gt_t).mean()),
        "ssim": float(M.ssim(pr_t, gt_t).mean()),
    }
    if feature_fn is not None:
        res["fid"] = M.fid_from_features(np.asarray(feature_fn(gt_t)),
                                         np.asarray(feature_fn(pr_t)))
    if lpips_fn is not None:
        res["lpips"] = float(np.asarray(lpips_fn(pr_t, gt_t)).mean())
    if out_file:
        with open(out_file, "a") as f:  # appended, as run_evaluation.py:361
            f.write(f"{pred_dir}: {res}\n")
    return res


def texture_self_psnr(obj_path: str, pc_file: str,
                      atlas_res: Optional[int] = None,
                      device="cuda") -> Dict[str, float]:
    """Self-consistency of an exported mesh: for every input point, the
    exported atlas colour at its nearest covered texel (through the baked
    texel -> 3D map) against the point's own colour.  `atlas_res` is
    unused: the atlas PNG sets the resolution, as in the JAX package."""
    from ..ops.knn import knn
    from ..pipeline.geometry import normalize_points
    from ..pipeline.unwrap import bake_atlas

    dev = resolve_device(device)
    m = pio.load_obj(obj_path)
    atlas = pio.load_rgb(obj_path.replace(".obj", ".png"))[::-1].copy()
    baked = bake_atlas(m["vertices"], m["faces"], m["uvs"],
                       m["face_uv_idx"], atlas.shape[0], device=dev)
    mask = baked["mask"].cpu().numpy()
    gb = baked["gb_pos"][baked["mask"]]
    tex_colors = atlas[mask]

    xyz, rgb = pio.read_ply_xyzrgb(pc_file)
    xyz_n, _, _ = normalize_points(xyz)
    rgb01 = rgb.astype(np.float32) / 255.0

    d, i = knn(torch.as_tensor(xyz_n, device=dev), gb, 1)
    d = np.sqrt(d[:, 0].cpu().numpy())
    near = d < 0.02  # points whose surface texel is identifiable
    got = tex_colors[i[:, 0].cpu().numpy()][near]
    want = rgb01[near]
    mse = float(np.mean((got - want) ** 2))
    return {
        "points_matched": float(near.mean()),
        "mae": float(np.abs(got - want).mean()),
        "psnr": float(10 * np.log10(1.0 / max(mse, 1e-12))),
    }


def evaluate_geometry(pred_obj: str, gt_obj: str,
                      n_samples: int = 100000,
                      device="cuda") -> Dict[str, float]:
    """MeshEvaluator protocol (models/POCO/eval/src/eval.py:28-90)."""
    dev = resolve_device(device)
    mp = pio.load_obj(pred_obj)
    mg = pio.load_obj(gt_obj)
    pp, pn = M.sample_mesh_surface(mp["vertices"], mp["faces"], n_samples)
    gp, gn = M.sample_mesh_surface(mg["vertices"], mg["faces"], n_samples)
    res = M.chamfer_and_fscore(pp, pn, gp, gn, device=dev)
    res["iou"] = M.mesh_iou(mp["vertices"], mp["faces"],
                            mg["vertices"], mg["faces"], device=dev)
    return res
