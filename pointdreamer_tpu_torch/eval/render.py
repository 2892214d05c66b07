"""Mesh rendering for evaluation (twin of eval/render.py).

Reference: utils/camera_utils.py render_textured_mesh (:379) and
render_textured_meshes_shapenet2 (:680), which render 20 views at 512^2
of ground-truth and predicted textured meshes for LPIPS/FID/PSNR/SSIM
(data/render_meshes.py, data/run_evaluation.py).

Each renderer is one pass over all the views: `ops/raster.py::
rasterize_views` (K1, or K4 under PD_USE_PALLAS_RASTER=1 when res % 128
== 0) rasterizes every view in one launch, then attributes are
interpolated and the atlas sampled for all views at once.  The background
is a constant colour (the reference composites its renders to white,
run_evaluation.py:23).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .. import io as pio
from ..camera import CameraRig, make_camera_rig
from ..ops import image as oimg
from ..ops import raster as orast
from ..pipeline.pipeline import resolve_device


def _raster(rig: CameraRig, vertices: torch.Tensor, faces: torch.Tensor,
            res: Optional[int]):
    ndc, depth = rig.transform(vertices)
    return orast.rasterize_views(ndc, depth, faces, res or rig.res)


def _composite(rast, img: torch.Tensor, background: float) -> torch.Tensor:
    fg = (rast.face_id >= 0)[..., None]
    return torch.where(fg, img, torch.full_like(img, background))


def render_textured_views(
    rig: CameraRig,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    uvs: torch.Tensor,
    face_uv_idx: torch.Tensor,
    atlas_img: torch.Tensor,          # [R,R,3], row 0 = v~0 (in memory)
    res: Optional[int] = None,
    background: float = 1.0,
    light_dir=None,
    ambient: float = 0.35,
) -> torch.Tensor:
    """Returns [V, res, res, 3] renders.  `light_dir` adds the reference's
    optional Lambertian shading (camera_utils.py:379):
    ambient + (1 - ambient) * |n . l|."""
    faces = faces.long()
    rast = _raster(rig, vertices, faces, res)
    uv_map = orast.interpolate(uvs, face_uv_idx.long(), rast.face_id,
                               rast.bary)
    img = oimg.bilinear_sample(atlas_img, uv_map)
    if light_dir is not None:
        lt = torch.as_tensor(light_dir, dtype=torch.float32,
                             device=vertices.device)
        lt = lt / lt.norm().clamp(min=1e-12)
        fn = orast.face_normals(vertices, faces)
        shade = (fn[rast.face_id.long().clamp(min=0)] @ lt).abs().clamp(
            0.0, 1.0)
        img = img * (ambient + (1.0 - ambient) * shade)[..., None]
    return _composite(rast, img.clamp(0.0, 1.0), background)


def render_vertex_color_views(
    rig: CameraRig,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    vertex_colors: torch.Tensor,      # [N,3] in [0,1]
    res: Optional[int] = None,
    background: float = 1.0,
) -> torch.Tensor:
    """Per-vertex-colour renderer (reference camera_utils.py:735)."""
    faces = faces.long()
    rast = _raster(rig, vertices, faces, res)
    img = orast.interpolate(vertex_colors, faces, rast.face_id, rast.bary)
    return _composite(rast, img.clamp(0.0, 1.0), background)


def render_normal_views(
    rig: CameraRig,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    res: Optional[int] = None,
    background: float = 1.0,
) -> torch.Tensor:
    """Face-normal map renderer, world-space normals encoded n*0.5+0.5
    (reference camera_utils.py:857)."""
    faces = faces.long()
    rast = _raster(rig, vertices, faces, res)
    fn = orast.face_normals(vertices, faces)
    img = fn[rast.face_id.long().clamp(min=0)] * 0.5 + 0.5
    return _composite(rast, img, background)


def render_mask_views(
    rig: CameraRig,
    vertices: torch.Tensor,
    faces: torch.Tensor,
    res: Optional[int] = None,
) -> torch.Tensor:
    """Foreground-mask renderer (reference camera_utils.py:556)."""
    return _raster(rig, vertices, faces.long(), res).face_id >= 0


def render_mesh_dir(obj_path: str, out_dir: str, num_views: int = 20,
                    res: int = 512, distribution: str = "blender",
                    device="cuda") -> List[str]:
    """Render an exported model_normalized.obj (+ .png) to view PNGs
    000.png, 001.png, ... (reference data/render_meshes.py:28-50)."""
    dev = resolve_device(device)
    m = pio.load_obj(obj_path)
    atlas = pio.load_rgb(obj_path.replace(".obj", ".png"))[::-1].copy()

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    rig = make_camera_rig(num_views, res=res, distribution=distribution,
                          device=dev)
    imgs = pio.to_uint8(render_textured_views(
        rig, t(m["vertices"]), t(m["faces"]), t(m["uvs"]),
        t(m["face_uv_idx"]), t(atlas), res))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, img in enumerate(imgs):
        p = os.path.join(out_dir, f"{i:03d}.png")
        pio.save_rgb(img, p)
        paths.append(p)
    return paths
