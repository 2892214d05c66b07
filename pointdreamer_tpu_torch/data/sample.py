"""Coloured point clouds sampled from textured meshes (twin of
data/sample.py; reference data/sample_colored_pc_from_mesh.py: kaolin's
area-weighted sample_points carrying face UVs, then a per-material
grid_sample of the texture with GL_REPEAT wrap and v-flip, :132-185,
:226).

Area-weighted barycentric sampling on the host with the JAX package's
numpy RNG sequence (so coordinates and normals are its own), then the
bilinear texture lookup (`ops.image.bilinear_sample`) on `device`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import io as pio
from ..ops.image import bilinear_sample


def sample_colored_pc_from_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    uvs: Optional[np.ndarray] = None,
    face_uv_idx: Optional[np.ndarray] = None,
    texture: Optional[np.ndarray] = None,   # [H,W,3] float, row 0 = v~0
    n_points: int = 30000,
    seed: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """dict(coords, colors, normals[, uvs]) as the reference's npy outputs
    (sample_colored_pc_from_mesh.py:226-290); grey 0.5 without a
    texture."""
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fv = vertices[faces]
    cross = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    area = np.linalg.norm(cross, axis=1) / 2.0
    nrm = cross / np.maximum(np.linalg.norm(cross, axis=1, keepdims=True),
                             1e-12)
    fid = rng.choice(len(faces), n_points, p=area / area.sum())
    u = rng.random((n_points, 1))
    v = rng.random((n_points, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    w = 1 - u - v
    pts = fv[fid, 0] * w + fv[fid, 1] * u + fv[fid, 2] * v
    out = {"coords": pts.astype(np.float32),
           "normals": nrm[fid].astype(np.float32)}
    if uvs is not None and texture is not None:
        fuv = uvs[face_uv_idx[fid]]                      # [N,3,2]
        uv = (fuv[:, 0] * w + fuv[:, 1] * u + fuv[:, 2] * v) % 1.0
        colors = bilinear_sample(
            torch.as_tensor(np.asarray(texture, np.float32), device=dev),
            torch.as_tensor(uv, dtype=torch.float32, device=dev))
        out["uvs"] = uv.astype(np.float32)
        out["colors"] = colors.clamp(0, 1).cpu().numpy().astype(np.float32)
    else:
        out["colors"] = np.full((n_points, 3), 0.5, np.float32)
    return out


def sample_from_obj(obj_path: str, n_points: int = 30000, seed: int = 0,
                    out_ply: Optional[str] = None,
                    device="cuda") -> Dict[str, np.ndarray]:
    """Sample a coloured cloud from an exported OBJ (and the PNG beside
    it, v-flipped back: the export writes it flipped); `out_ply` writes
    it as a coloured PLY."""
    m = pio.load_obj(obj_path)
    tex = None
    tex_path = obj_path.replace(".obj", ".png")
    if os.path.exists(tex_path):
        tex = pio.load_rgb(tex_path)[::-1].copy()
    out = sample_colored_pc_from_mesh(
        m["vertices"], m["faces"], m.get("uvs"), m.get("face_uv_idx"),
        tex, n_points, seed, device)
    if out_ply:
        pio.save_colored_pc_ply(out["coords"], out["colors"], out_ply)
    return out
