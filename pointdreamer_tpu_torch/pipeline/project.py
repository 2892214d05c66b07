"""Stage: project the mesh + coloured points into the views and build the
sparse images for inpainting (twin of pipeline/project.py)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..camera import CameraRig
from ..ops import image as oimg
from ..ops import knn as oknn
from ..ops import raster as orast
from ..ops import splat as osplat


class ProjectionData(NamedTuple):
    hard_masks: torch.Tensor       # [V, cam_res, cam_res] bool
    face_idxs: torch.Tensor        # [V, cam_res, cam_res] int32
    mesh_depths: torch.Tensor      # [V, cam_res, cam_res] (inf = bg)
    uv_centers: torch.Tensor       # [V, 1, 2]
    uv_scales: torch.Tensor        # [V, 1, 1]
    padding: float
    point_uvs: torch.Tensor        # [V, N, 2] in [0,1] (cropped frame)
    point_depths: torch.Tensor     # [V, N]
    point_validation: torch.Tensor  # [V, N] bool


def project_views(rig: CameraRig, vertices: torch.Tensor,
                  faces: torch.Tensor, points: torch.Tensor,
                  crop: bool = True, padding: float = 0.05,
                  depth_offset: float = 1e-2,
                  cull_backface: bool = True) -> ProjectionData:
    """Rasterize the mesh and depth-test point visibility in all views."""
    cam_res = rig.res
    all_pts = torch.cat([vertices, points], dim=0)
    ndc, depth = rig.transform(all_pts)
    nV = vertices.shape[0]
    vert_ndc, point_ndc = ndc[:, :nV], ndc[:, nV:]
    vert_depth, point_depth = depth[:, :nV], depth[:, nV:]
    V = rig.num_views
    if crop:
        lo = vert_ndc.amin(dim=1, keepdim=True)
        hi = vert_ndc.amax(dim=1, keepdim=True)
        uv_centers = (lo + hi) / 2.0
        uv_scales = (hi - lo).amax(dim=2, keepdim=True)
        k = (1.0 - 2.0 * padding)
        vert_ndc = (vert_ndc - uv_centers) / uv_scales * k * 2.0
        point_uvs = (point_ndc - uv_centers) / uv_scales * k + 0.5
    else:
        uv_centers = torch.zeros((V, 1, 2), device=ndc.device)
        uv_scales = torch.full((V, 1, 1), 2.0, device=ndc.device)
        padding = 0.0
        point_uvs = point_ndc * 0.5 + 0.5
    rast = orast.rasterize_views(vert_ndc, vert_depth, faces, cam_res,
                                 cull_backface=cull_backface)
    vis = osplat.point_visibility_by_depth(point_uvs * 2.0 - 1.0, point_depth,
                                           rast.zbuf, offset=depth_offset)
    return ProjectionData(
        hard_masks=rast.face_id >= 0, face_idxs=rast.face_id,
        mesh_depths=rast.zbuf, uv_centers=uv_centers, uv_scales=uv_scales,
        padding=float(padding), point_uvs=point_uvs,
        point_depths=point_depth, point_validation=vis)


def add_hpr_visibility(proj: ProjectionData, points_np: np.ndarray,
                       rig: CameraRig, radius: float = 100.0,
                       n_total: int = None, depth_guard: float = 0.03,
                       precomputed: np.ndarray = None) -> ProjectionData:
    """OR-in hidden-point-removal visibility; rescues more than
    `depth_guard` behind the rasterized depth are rejected."""
    hpr = (precomputed if precomputed is not None
           else osplat.hidden_point_removal_visibility(
               points_np, rig.eyes.cpu().numpy(), radius))
    if n_total is not None and n_total > hpr.shape[1]:
        pad = np.zeros((hpr.shape[0], n_total - hpr.shape[1]), bool)
        hpr = np.concatenate([hpr, pad], axis=1)
    hpr_t = torch.as_tensor(hpr, device=proj.point_validation.device)
    if depth_guard and depth_guard > 0:
        cam_res = proj.mesh_depths.shape[-1]
        pix = (proj.point_uvs * cam_res).to(torch.int32).clamp(0, cam_res - 1)
        flat = (pix[..., 1] * cam_res + pix[..., 0]).long()
        md = torch.gather(proj.mesh_depths.reshape(len(flat), -1), 1, flat)
        not_behind = (~torch.isfinite(md)) | (
            proj.point_depths <= md + depth_guard)
        hpr_t = hpr_t & not_behind
    return proj._replace(point_validation=proj.point_validation | hpr_t)


def refine_point_validation(proj: ProjectionData, refine_res: int = 512,
                            window: int = 5,
                            depth_slack: float = 0.03) -> ProjectionData:
    """Drop the points whose depth lies abnormally far behind their
    neighbourhood (twin of the JAX `refine_point_validation`; the
    reference's refine_point_validation_by_remove_abnormal_depth, off by
    default): per view, the valid points' depths min-splatted at
    `refine_res`, a `window` x `window` local minimum (empty pixels at
    1e6), and a point stays valid where depth <= local min + slack."""
    V, N, _ = proj.point_uvs.shape
    R = refine_res
    pix = (proj.point_uvs * R).clamp(0, R - 1).to(torch.int32).long()
    flat = pix[..., 1] * R + pix[..., 0]                       # [V, N]
    d = torch.where(proj.point_validation, proj.point_depths,
                    torch.full_like(proj.point_depths, float("inf")))
    img = torch.full((V, R * R), float("inf"), device=d.device)
    img.scatter_reduce_(1, flat, d, "amin")
    img = torch.where(torch.isfinite(img), img, torch.full_like(img, 1e6))
    local_min = -oimg.dilate(-img.reshape(V, R, R), window)
    ref = torch.gather(local_min.reshape(V, R * R), 1, flat)
    return proj._replace(point_validation=proj.point_validation
                         & (proj.point_depths <= ref + depth_slack))


class SparseImages(NamedTuple):
    sparse_imgs: torch.Tensor    # [V, res, res, 3]
    hard_mask0: torch.Tensor     # [V, res, res] foreground mask (shrunk)
    hard_mask2: torch.Tensor     # [V, res, res] known-pixel mask
    scale_factors: torch.Tensor  # [V]
    mask_ratios: torch.Tensor    # [V]


def make_sparse_images(proj: ProjectionData, colors: torch.Tensor,
                       res: int = 256, point_size: int = 1,
                       edge_point_size: int = 1,
                       mask_ratio_thresh: float = 0.82,
                       edge_budget: int = 8192) -> SparseImages:
    """Splat visible points per view, shrink-to-fit when too sparse, and
    paint foreground inner-edge pixels with their nearest valid point's
    colour (reference get_sparse_images, ours_utils.py:848-882)."""
    cam_res = proj.hard_masks.shape[-1]
    V = proj.hard_masks.shape[0]
    dev = colors.device
    if cam_res != res:
        fg_all = oimg.resize_linear(proj.hard_masks.float(), (res, res)) > 0.5
    else:
        fg_all = proj.hard_masks
    point_pix = proj.point_uvs * res
    outs = []
    for v in range(V):
        fg_mask, pix, valid = fg_all[v], point_pix[v], proj.point_validation[v]
        fg_num = fg_mask.sum().float()
        valid_num = valid.sum().float()
        mask_ratio = 1.0 - valid_num / fg_num.clamp(min=1.0)
        wanted_fg = valid_num / (1.0 - mask_ratio_thresh)
        scale = torch.where(mask_ratio > mask_ratio_thresh,
                            wanted_fg / fg_num.clamp(min=1.0),
                            torch.ones((), device=dev))
        pix_s = (pix - res / 2.0) * scale + res / 2.0
        rc = pix_s.clamp(0, res - 1).to(torch.int32)
        rowcol = torch.stack([rc[:, 1], rc[:, 0]], dim=-1)
        fg_s = oimg.rescale_about_center(fg_mask.float(), scale) > 0.5

        sparse = torch.zeros((res, res, 3), device=dev)
        sparse = osplat.paint_pixels(sparse, rowcol, colors, point_size, valid)
        mask2 = (~fg_s).float()
        mask2 = osplat.paint_mask(mask2, rowcol, 1.0, point_size, valid)

        edge = oimg.inner_edge_mask(fg_s)
        nz = torch.nonzero(edge)[:edge_budget].to(torch.int32)
        epix = torch.full((edge_budget, 2), -1, dtype=torch.int32,
                          device=dev)
        epix[:len(nz)] = nz
        e_ok = epix[:, 0] >= 0
        _, idx = oknn.knn_2d_pixels(epix.float(), rowcol.float(), 1,
                                    ref_valid=valid)
        ecol = colors[idx[:, 0]]
        sparse = osplat.paint_pixels(sparse, epix, ecol, edge_point_size,
                                     e_ok)
        mask2 = osplat.paint_mask(mask2, epix, 1.0, edge_point_size, e_ok)

        mask0 = fg_s.float()
        sparse = sparse * mask0[..., None]
        occupied = ((mask2 > 0.5) & fg_s).sum().float()
        final_ratio = 1.0 - occupied / fg_s.sum().float().clamp(min=1.0)
        outs.append((sparse, mask0, mask2, scale, final_ratio))
    sparse, m0, m2, scales, ratios = (torch.stack(x) for x in zip(*outs))
    return SparseImages(sparse, m0, m2, scales, ratios)
