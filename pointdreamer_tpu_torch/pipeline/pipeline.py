"""End-to-end orchestration: coloured point cloud -> textured mesh (twin
of pipeline/pipeline.py; reference demo.py:38-497).

Geometry, in the JAX package's order: a cached external mesh
`<name>_untextured_mesh.obj` beside `<name>.ply` (original, un-normalized
coordinates; back faces are then not culled, its winding being unknown),
else the shape's own `geo/untextured.obj` from an earlier run, else
`pipeline/geometry.py::reconstruct_mesh` from the cloud (the POCO
network of `poco_checkpoint`; SPR when none is configured), saved on the
io thread.  Stage caches: the mesh,
its unwrap (`geo/unwrap_<R>.npz`) and the inpainted views
(`others/<i>_inpainted.png`).  The unwrap and the HPR hulls run on a host
thread while the device works; the unwrap thread's own wall and CPU
seconds are its span `unwrap.thread` and `unwrap.thread_cpu`, the wait
for it `unwrap.wait` (log.py's spans, named for the shape).  With
`unproject_by: face` no unwrap runs: each face takes one inpainted view
(pipeline/face_assign.py) and the mesh is written with one material a
view.

Under an initialised torch.distributed group of world size n > 1 every
rank runs every stage on the same input; with `ddnm_data_parallel` and
`view_num % n == 0` the DDNM views split over the n ranks (JAX's
sharded views, `parallel/mesh.py`).  The ranks agree on which stage
caches exist before any of them writes, and only rank 0 writes files.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import io as pio
from ..camera import CameraRig, make_camera_rig
from ..config import PipelineConfig
from ..log import StageTimer, get_logger
from ..parallel import mesh as pmesh
from ..ops import image as oimg
from ..ops import raster as orast
from . import complete as pcomplete
from . import export as pexport
from . import geometry as pgeo
from . import inpaint as pinpaint
from . import optimize as popt
from . import project as pproject
from . import unproject as punproject
from . import unwrap as punwrap


def _bucket(n: int, step: int = 4096) -> int:
    return -(-n // step) * step


def _pad_mesh(verts: np.ndarray, faces: np.ndarray, step: int = 4096):
    """Pad to bucketed sizes as the JAX package does (padding faces are
    degenerate (0,0,0) and never rasterize)."""
    nv, nf = len(verts), len(faces)
    pv, pf = _bucket(max(nv, 4), step), _bucket(max(nf, 4), step)
    verts_p = np.concatenate(
        [verts, np.repeat(verts[-1:], pv - nv, axis=0)]).astype(np.float32)
    faces_p = np.concatenate([faces, np.zeros((pf - nf, 3), faces.dtype)])
    return verts_p, faces_p, nv, nf


def _pad_points(xyz: np.ndarray, colors: np.ndarray, step: int = 4096):
    n = len(xyz)
    p = _bucket(n, step)
    xyz_p = np.concatenate(
        [xyz, np.repeat(xyz[-1:], p - n, axis=0)]).astype(np.float32)
    col_p = np.concatenate([colors, np.repeat(colors[-1:], p - n, axis=0)])
    mask = np.zeros(p, bool)
    mask[:n] = True
    return xyz_p, col_p, mask


def load_gt_views(path: str, n_views: int, res: int,
                  device) -> torch.Tensor:
    """`<path>/<i>_inpainted.png`, else `<path>/<i>.png`, for each view, as
    [V, res, res, 3] in [0, 1]; resized with jax.image.resize's 'linear'
    weights when their size is another."""
    imgs = []
    for i in range(n_views):
        p = os.path.join(path, f"{i}_inpainted.png")
        if not os.path.exists(p):
            p = os.path.join(path, f"{i}.png")
        imgs.append(pio.load_rgb(p))
    views = torch.as_tensor(np.stack(imgs), device=device)
    if views.shape[1] != res:
        views = oimg.resize_linear_hwc(views, (res, res))
    return views


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked
    for (there is no silent continuation on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' explicitly to run "
                           "the plain versions on the CPU")
    return dev


@dataclass
class Pipeline:
    """Per-process state: config, device, cameras, models, logger."""

    cfg: PipelineConfig
    device: torch.device
    rig: CameraRig
    inpainter: object = None
    poco_apply: object = None    # occupancy field factory or None
    logger: object = None
    writes: bool = True          # False on ranks other than 0

    @classmethod
    def create(cls, cfg: PipelineConfig, device="cuda",
               log_file: Optional[str] = None,
               allow_random_diffusion: bool = False, unet_kwargs=None):
        """`allow_random_diffusion` runs DDNM with a seeded random UNet when
        no checkpoint is configured (the JAX package's
        PD_ALLOW_RANDOM_DIFFUSION=1); otherwise such a config degrades to
        'nearest' with a warning, as the JAX package does.  `unet_kwargs`
        builds another UNetModel than the 552.8M flagship (the CPU tests'
        tiny one).  The UNet computes in bf16 on the card and in fp32 on
        the CPU; POCO (geo_from 'POCO' with a `poco_checkpoint`) in fp32.
        `ddnm_quant_int8` builds the w8a8 UNet (`ddnm_quant_static`: static
        per-step activation scales, calibrated on the first shape).
        Under a process group of n > 1 ranks, `ddnm_data_parallel` splits
        the DDNM views over them when n divides `view_num`."""
        dev = resolve_device(device)
        logger = get_logger(log_file)
        rig = make_camera_rig(cfg.view_num, cfg.cam_distance, cfg.cam_res,
                              cfg.cam_fov_deg, cfg.camera_distribution,
                              device=dev)
        inpainter = None
        if cfg.texture_gen_method == "DDNM_inpaint":
            if cfg.diffusion_checkpoint or allow_random_diffusion:
                from ..models.diffusion import load_inpainter

                dtype = (torch.bfloat16 if dev.type == "cuda"
                         else torch.float32)
                mesh, n = None, _world()
                if cfg.ddnm_data_parallel and n > 1 \
                        and cfg.view_num % n == 0:
                    mesh = pmesh.make_mesh(n, tp=1)
                    logger.info(f"DDNM views sharded over {n} devices")
                inpainter = load_inpainter(cfg.diffusion_checkpoint, logger,
                                           device=dev, mesh=mesh,
                                           model_kwargs=unet_kwargs,
                                           dtype=dtype,
                                           quant_int8=cfg.ddnm_quant_int8,
                                           quant_static=cfg.ddnm_quant_static)
            else:
                logger.warning(
                    "texture_gen_method=DDNM_inpaint but no "
                    "diffusion_checkpoint configured: falling back to "
                    "'nearest' (allow_random_diffusion / the demo's "
                    "--allow_random_diffusion runs the sampler with random "
                    "weights anyway)")
                cfg.texture_gen_method = "nearest"
        poco_apply = None
        if cfg.geo_from == "POCO" and cfg.poco_checkpoint:
            from ..models.occupancy import load_poco_field

            poco_apply = load_poco_field(cfg.poco_checkpoint, logger,
                                         decoder=cfg.network_decoder,
                                         device=dev)
        return cls(cfg=cfg, device=dev, rig=rig, inpainter=inpainter,
                   poco_apply=poco_apply, logger=logger,
                   writes=not dist.is_initialized() or dist.get_rank() == 0)

    def _agree(self, flags):
        """Each flag true on every rank (one all_reduce(MIN) when there
        are several ranks): the ranks take the same cached or computed
        path even if one of them lacks a cache file."""
        if _world() == 1:
            return list(flags)
        t = torch.tensor([int(f) for f in flags], device=self.device)
        pmesh.all_reduce(t, pmesh.world_axis(), dist.ReduceOp.MIN)
        return [bool(v) for v in t.tolist()]

    def recon_one_textured_mesh(self, pc_file: str,
                                name: Optional[str] = None,
                                timer: Optional[StageTimer] = None) -> str:
        cfg, log, dev = self.cfg, self.logger, self.device
        timer = timer or StageTimer(log)
        name = name or os.path.splitext(os.path.basename(pc_file))[0]
        timer.shape = name
        out_root = os.path.join(cfg.output_path, name)
        geo_dir = os.path.join(out_root, "geo")
        others_dir = os.path.join(out_root, "others")
        writes = self.writes
        if writes:
            os.makedirs(geo_dir, exist_ok=True)
            os.makedirs(others_dir, exist_ok=True)
        R = cfg.xatlas_texture_res
        own_geo = os.path.join(geo_dir, "untextured.obj")
        unwrap_cache = os.path.join(geo_dir, f"unwrap_{R}.npz")
        cached = [os.path.join(others_dir, f"{i}_inpainted.png")
                  for i in range(self.rig.num_views)]
        have_geo, have_unwrap, have_views = self._agree(
            [os.path.exists(own_geo), os.path.exists(unwrap_cache),
             all(os.path.exists(p) for p in cached)])

        # ---- input ----------------------------------------------------
        xyz, rgb = pio.read_ply_xyzrgb(pc_file)
        if len(xyz) > cfg.max_points:
            raise ValueError(f"Point number > {cfg.max_points}! ({len(xyz)} "
                             f"points in {pc_file}); subsample first")
        xyz_n, center, scale = pgeo.normalize_points(xyz)
        hpr_future = None
        if cfg.point_validation_by_o3d:
            from ..ops import splat as osplat

            hpr_future = pio.async_executor().submit(
                osplat.hidden_point_removal_visibility, xyz_n,
                self.rig.eyes.cpu().numpy(), cfg.hidden_point_removal_radius)
        if cfg.save_input_pc and writes:
            pio.save_colored_pc_ply(xyz_n, rgb.astype(np.float32) / 255.0,
                                    os.path.join(out_root, "input_pc.ply"))

        # ---- geometry (cached) ----------------------------------------
        with timer.stage("geometry"):
            cached_geo = pc_file.replace(".ply", "_untextured_mesh.obj")
            external_mesh = os.path.exists(cached_geo)
            if external_mesh:
                m = pio.load_obj(cached_geo)
                verts = (m["vertices"] - center) / scale
                faces = m["faces"]
            elif have_geo:
                m = pio.load_obj(own_geo)
                verts, faces = m["vertices"], m["faces"]
            else:
                verts, faces = pgeo.reconstruct_mesh(
                    xyz_n, cfg.geo_from, cfg.grid_res, cfg.target_face_num,
                    cfg.noise_stddev if not cfg.input_already_noisy else None,
                    poco_apply=self.poco_apply, smooth_mesh=cfg.smooth_mesh,
                    refine_iters=cfg.refine_vertex_iters,
                    iso_method=cfg.iso_method,
                    screen_weight=cfg.spr_screen_weight, device=dev,
                    timer=timer)
                # read only by later runs: written on the io thread
                # (flush_async_io at export guards reuse)
                if writes:
                    pio.submit_async_io(
                        lambda v=verts, f=faces: pio.save_obj(v, f, own_geo))

        verts_p, faces_p, _, n_faces = _pad_mesh(verts, faces)
        xyz_p, colors_p, point_mask = _pad_points(
            xyz_n, rgb.astype(np.float32) / 255.0)
        colors = torch.as_tensor(colors_p, device=dev)
        verts_t = torch.as_tensor(verts_p, device=dev)
        faces_t = torch.as_tensor(faces_p, device=dev).long()
        f_normals = orast.face_normals(verts_t, faces_t)

        # ---- unwrap (host LSCM/packing) on the io thread ---------------
        def _unwrap_host():
            if have_unwrap:
                z = np.load(unwrap_cache)
                return z["uvs"], z["face_uv_idx"]
            # the thread's own wall and CPU time: it shares the host with
            # the device stages that run meanwhile
            with timer.span("unwrap.thread", cpu=True):
                uv, fuv = punwrap.unwrap(verts, faces, atlas_res=R)
            if writes:
                np.savez(unwrap_cache, uvs=uv, face_uv_idx=fuv)
            return uv, fuv

        face_mode = cfg.unproject_by == "face"
        if not face_mode:   # the face path needs no UV atlas
            unwrap_future = pio.async_executor().submit(_unwrap_host)

        # ---- project + sparse images ----------------------------------
        with timer.stage("project"):
            proj = pproject.project_views(
                self.rig, verts_t, faces_t, torch.as_tensor(xyz_p, device=dev),
                crop=cfg.crop_img, padding=cfg.crop_padding,
                depth_offset=cfg.depth_offset,
                # an external mesh's winding is unknown: only the port's
                # own reconstructions are culled, as in the JAX package
                cull_backface=not external_mesh)
            proj = proj._replace(
                point_validation=proj.point_validation
                & torch.as_tensor(point_mask, device=dev)[None, :])
            if cfg.point_validation_by_o3d:
                proj = pproject.add_hpr_visibility(
                    proj, xyz_n, self.rig, cfg.hidden_point_removal_radius,
                    n_total=len(xyz_p), depth_guard=cfg.hpr_depth_guard,
                    precomputed=hpr_future.result())
            if cfg.refine_point_validation_by_remove_abnormal_depth:
                proj = pproject.refine_point_validation(proj, cfg.refine_res)
            sparse = pproject.make_sparse_images(
                proj, colors, cfg.res, cfg.point_size, cfg.edge_point_size,
                cfg.mask_ratio_thresh)
            if writes:
                pio.save_rgb_stack_async(
                    sparse.sparse_imgs,
                    [os.path.join(others_dir, f"{i}_sparse.png")
                     for i in range(self.rig.num_views)])

        # ---- inpaint (cached) -----------------------------------------
        scale_factors = sparse.scale_factors
        with timer.stage("inpaint"):
            if cfg.gt_views_path:
                # dense views rendered beforehand stand in for the
                # inpainted ones (reference use_GT_multi_view_img)
                if cfg.crop_img and log:
                    log.warning("gt_views_path with crop_img=True: the "
                                "pre-rendered views must match the crop "
                                "frame exactly; use crop_img: false")
                inpainted = load_gt_views(cfg.gt_views_path,
                                          self.rig.num_views, cfg.res, dev)
                # dense renders carry no shrink-to-fit rescale
                scale_factors = torch.ones_like(scale_factors)
            elif have_views:
                inpainted = torch.as_tensor(
                    np.stack([pio.load_rgb(p) for p in cached]), device=dev)
            else:
                inpainted = pinpaint.get_inpainted_images(
                    sparse.sparse_imgs, sparse.hard_mask0, sparse.hard_mask2,
                    cfg.texture_gen_method, self.inpainter)
                if writes:
                    pio.save_rgb_stack_async(inpainted, cached)

        # ---- face-mode unprojection (unproject_by='face') --------------
        if face_mode:
            from . import face_assign as pface

            with timer.stage("unproject"):
                neighbors = pface.face_adjacency_neighbors(faces)
                counts = pface.face_view_pixel_counts(
                    proj.face_idxs, len(faces_p))[:n_faces].cpu().numpy()
                sim = (f_normals[:n_faces] @ self.rig.base_dirs.T
                       ).cpu().numpy()
                if cfg.naive_face_view:
                    fv_ids = sim.argmax(axis=1).astype(np.int64)
                else:
                    fv_ids = pface.assign_face_views(neighbors, counts, sim)
                f_uvs = pface.face_corner_uvs(
                    self.rig, verts_p, faces, proj.uv_centers,
                    proj.uv_scales, proj.padding, scale_factors, fv_ids)
            with timer.stage("export"):
                models_dir = os.path.join(out_root, "models")
                obj_path = (pexport.save_multi_material_obj(
                    verts, faces, fv_ids, f_uvs, inpainted, models_dir)
                    if writes else
                    os.path.join(models_dir, "model_normalized.obj"))
                pio.flush_async_io()
            if log:
                log.info("stage timings:\n" + timer.report())
            return obj_path

        # ---- unwrap result + atlas bake -------------------------------
        with timer.stage("unwrap"):
            with timer.span("unwrap.wait"):
                uvs, face_uv_idx = unwrap_future.result()
            atlas = punwrap.bake_atlas(verts, faces, uvs,
                                       face_uv_idx, R, device=dev)

        # ---- unproject (NBF) ------------------------------------------
        with timer.stage("unproject"):
            up = punproject.unproject(
                inpainted, self.rig, f_normals, atlas["gb_pos"],
                atlas["mask"], atlas["per_atlas_pixel_face_id"],
                proj.mesh_depths, proj.uv_centers, proj.uv_scales,
                proj.padding, scale_factors,
                # the reference's `edge_dilate_kernels*(res//256)` is list
                # REPETITION: the border width stays 21 at every resolution
                kernel_sizes=tuple(
                    ((k * max(R // 256, 1)) | 1
                     if cfg.scale_nbf_kernels_with_res else k) if k else 0
                    for k in cfg.edge_dilate_kernels),
                view_res=cfg.res, depth_offset=cfg.depth_offset,
                complete_by_projection=(cfg.complete_unseen_by == "unproject"))

        # ---- complete unseen ------------------------------------------
        with timer.stage("complete"):
            if cfg.complete_unseen_by == "neighbor":
                atlas_img = pcomplete.complete_by_neighbors(
                    verts, faces, uvs, face_uv_idx, up.atlas_img,
                    up.atlas_painted, atlas["mask"],
                    atlas["per_atlas_pixel_face_id"])
            elif cfg.complete_unseen_by == "optimize":
                from ..models.texture_field import fit_and_paint

                gen = torch.Generator(device=dev)
                gen.manual_seed(0)
                # the padded pair: the duplicated points weight the MSE,
                # as in the JAX package
                atlas_img = fit_and_paint(
                    up.atlas_img, up.atlas_painted, atlas["gb_pos"],
                    atlas["mask"], torch.as_tensor(xyz_p, device=dev),
                    colors, generator=gen)
                atlas_img = pcomplete.dilate_atlas(atlas_img,
                                                   up.atlas_painted)
            else:  # 'unproject'
                atlas_img = pcomplete.dilate_atlas(up.atlas_img,
                                                   up.atlas_painted)

        # ---- optimize -------------------------------------------------
        if cfg.optimize_from and cfg.optimize_from != "None":
            with timer.stage("optimize"):
                init = None if cfg.optimize_from == "scratch" else atlas_img
                svis = (up.shrunk_visibility
                        if cfg.optimize_from == "ours" else None)
                atlas_img, _ = popt.optimize_color(
                    init, inpainted, self.rig, verts_t, faces_t,
                    torch.as_tensor(uvs, device=dev),
                    torch.as_tensor(face_uv_idx, device=dev).long(),
                    proj.uv_centers, proj.uv_scales, proj.padding,
                    scale_factors, svis,
                    render_res=cfg.optimize_render_res,
                    lr=cfg.optimize_lr, iterations=cfg.optimize_iters)

        # ---- export ---------------------------------------------------
        with timer.stage("export"):
            obj_path = (pexport.save_textured_mesh(
                verts, uvs, faces, face_uv_idx, atlas_img, atlas["mask"],
                out_root) if writes else os.path.join(
                    out_root, "models", "model_normalized.obj"))
            pio.flush_async_io()
        if log:
            log.info("stage timings:\n" + timer.report())
        return obj_path
