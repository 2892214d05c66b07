"""w8a8 fidelity of the flagship UNet (twin of cli/w8a8_fidelity.py).

The 552.8M guided-diffusion UNet (models/DDNM/guided_diffusion/
unet.py:396), with seeded random weights, inpaints the pipeline's real
sparse views of a cloud, in bf16 and through its w8a8 twin (K7 + K8) with
dynamic and with static activation scales, on the same draws; the script
records the PSNR and correlation of each int8 result against the bf16
one.  The static scales are calibrated on the views of another cloud
(`--calib_pc`), as a later shape reuses the first shape's scales.

No checkpoint ships, so the weights are random: quantization error
depends on the weights' distribution, not on what they learned.  The
random init zero-initializes the final conv and every block's out
projection, which would make eps 0 and every sampler equal; each matrix
gets the JAX tool's deterministic +-0.02 wave (in the port's own layout).

    python -m pointdreamer_tpu_torch.cli.w8a8_fidelity --device cuda \\
        [--pc_file a.ply --calib_pc b.ply] [--t_sampling 100] \\
        [--out build/w8a8_fidelity/fidelity.json]

Without `--pc_file` / `--calib_pc` the clouds are the port's synthetic
cube and sphere (30,000 points each).  The sparse views are cached under
`--cache_dir`, keyed on the cloud's bytes and on every setting that
shapes them (geometry, cameras, splats).
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import time
from dataclasses import asdict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO, "build", "w8a8_fidelity")

# the settings the sparse views depend on, beside the cloud itself
VIEW_KEYS = ("geo_from", "grid_res", "target_face_num", "iso_method",
             "spr_screen_weight", "view_num", "cam_distance", "cam_res",
             "cam_fov_deg", "camera_distribution", "res", "crop_img",
             "crop_padding", "depth_offset", "point_validation_by_o3d",
             "hidden_point_removal_radius", "hpr_depth_guard", "point_size",
             "edge_point_size", "mask_ratio_thresh")


def view_cache_key(cfg, pc_file: str) -> str:
    """A hash of the cloud's bytes and of the view settings of `cfg`."""
    h = hashlib.sha256()
    with open(pc_file, "rb") as f:
        h.update(f.read())
    conf = {k: v for k, v in asdict(cfg).items() if k in VIEW_KEYS}
    h.update(json.dumps(conf, sort_keys=True).encode())
    return h.hexdigest()[:20]


def sparse_views(cfg, pc_file: str, device, cache_dir: str):
    """The pipeline up to the sparse images (geometry, project, splat):
    (sparse_imgs [V, res, res, 3], hard_mask0 [V, res, res]) on
    `device`, from the cache when the cloud and its settings are the
    same."""
    from .. import io as pio
    from ..camera import make_camera_rig
    from ..pipeline import geometry as pgeo
    from ..pipeline import project as pproject
    from ..pipeline.pipeline import _pad_mesh, _pad_points

    cache = os.path.join(cache_dir,
                         f"views_{view_cache_key(cfg, pc_file)}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return (torch.as_tensor(z["imgs"], device=device),
                torch.as_tensor(z["masks"], device=device))
    rig = make_camera_rig(cfg.view_num, cfg.cam_distance, cfg.cam_res,
                          cfg.cam_fov_deg, cfg.camera_distribution,
                          device=device)
    xyz, rgb = pio.read_ply_xyzrgb(pc_file)
    xyz_n, _, _ = pgeo.normalize_points(xyz)
    verts, faces = pgeo.reconstruct_mesh(
        xyz_n, cfg.geo_from, cfg.grid_res, cfg.target_face_num, None,
        iso_method=cfg.iso_method, screen_weight=cfg.spr_screen_weight,
        device=device)
    verts_p, faces_p, _, _ = _pad_mesh(verts, faces)
    xyz_p, colors_p, point_mask = _pad_points(
        xyz_n, rgb.astype(np.float32) / 255.0)
    proj = pproject.project_views(
        rig, torch.as_tensor(verts_p, device=device),
        torch.as_tensor(faces_p, device=device).long(),
        torch.as_tensor(xyz_p, device=device), crop=cfg.crop_img,
        padding=cfg.crop_padding, depth_offset=cfg.depth_offset)
    proj = proj._replace(point_validation=proj.point_validation
                         & torch.as_tensor(point_mask, device=device)[None])
    if cfg.point_validation_by_o3d:
        proj = pproject.add_hpr_visibility(
            proj, xyz_n, rig, cfg.hidden_point_removal_radius,
            n_total=len(xyz_p), depth_guard=cfg.hpr_depth_guard)
    sparse = pproject.make_sparse_images(
        proj, torch.as_tensor(colors_p, device=device), cfg.res,
        cfg.point_size, cfg.edge_point_size, cfg.mask_ratio_thresh)
    imgs, masks = sparse.sparse_imgs, sparse.hard_mask0.float()
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache, imgs=imgs.cpu().numpy(), masks=masks.cpu().numpy())
    return imgs, masks


@torch.no_grad()
def perturb_(model) -> None:
    """w += 0.02 sign(sin(arange(w.numel())) + 0.1) on every weight of two
    or more dims, in fp32, row-major over the port's layout."""
    for p in model.parameters():
        if p.dim() >= 2 and p.is_floating_point():
            i = torch.arange(p.numel(), dtype=torch.float32,
                             device=p.device).reshape(p.shape)
            p.add_(0.02 * torch.sign(torch.sin(i) + 0.1))


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def corr(a, b) -> float:
    return float(np.corrcoef(a.double().cpu().numpy().ravel(),
                             b.double().cpu().numpy().ravel())[0, 1])


def _default_clouds(cache_dir: str):
    from .. import io as pio
    from .. import synthetic
    from ..eval.selfparity import sphere_cloud

    cube = synthetic.write_cube_inputs(os.path.join(cache_dir, "cube"),
                                       n_points=30000, seed=0,
                                       with_mesh=False)
    sphere = os.path.join(cache_dir, "sphere", "sphere.ply")
    if not os.path.exists(sphere):
        os.makedirs(os.path.dirname(sphere), exist_ok=True)
        pio.save_colored_pc_ply(*sphere_cloud(30000), sphere)
    return cube, sphere


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pc_file", default=None,
                    help="the shape to inpaint (default: the synthetic "
                         "cube)")
    ap.add_argument("--calib_pc", default=None,
                    help="the shape the static scales are calibrated on "
                         "(default: the synthetic sphere)")
    ap.add_argument("--out", default=os.path.join(DEFAULT_DIR,
                                                  "fidelity.json"))
    ap.add_argument("--cache_dir", default=DEFAULT_DIR)
    ap.add_argument("--t_sampling", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--fp32_floor", action="store_true",
                    help="also run the fp32 sampler and record the bf16 "
                         "sampler's own distance from it")
    ap.add_argument("--calib_margin", type=float, default=None,
                    help="override DDNMInpainter's static-scale margin")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import PipelineConfig
    from ..models.diffusion import build_unet
    from ..models.diffusion.ddnm import DDNMInpainter, ddnm_inpaint_batch
    from ..models.diffusion.unet import quantize_unet_
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)
    cfg = PipelineConfig(geo_from="SPR")
    t0 = time.time()
    if args.pc_file is None or args.calib_pc is None:
        cube, sphere = _default_clouds(args.cache_dir)
        args.pc_file = args.pc_file or cube
        args.calib_pc = args.calib_pc or sphere
    imgs, masks = sparse_views(cfg, args.pc_file, dev, args.cache_dir)
    calib_imgs, calib_masks = sparse_views(cfg, args.calib_pc, dev,
                                           args.cache_dir)
    print(f"sparse views ready ({time.time() - t0:.1f}s)", flush=True)

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    fp32 = build_unet(dev, torch.float32)
    perturb_(fp32)
    model_fp = copy.deepcopy(fp32).set_compute_dtype(dtype)
    qmodel = quantize_unet_(copy.deepcopy(fp32)).set_compute_dtype(dtype)
    if not args.fp32_floor:
        del fp32

    def gen():
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed)
        return g

    def sample(model, **kw):
        out = ddnm_inpaint_batch(model, imgs, masks, gen(),
                                 t_sampling=args.t_sampling, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    t1 = time.time()
    out_fp = sample(model_fp)
    t_fp = time.time() - t1
    print(f"bf16 sampler done ({time.time() - t0:.1f}s)", flush=True)
    floor = None
    if args.fp32_floor:
        out_32 = sample(fp32)
        floor = {"bf16_psnr_vs_fp32": round(psnr(out_fp, out_32), 2),
                 "bf16_corr_vs_fp32": round(corr(out_fp, out_32), 5),
                 "per_view_psnr": [round(psnr(out_fp[i], out_32[i]), 2)
                                   for i in range(len(imgs))]}
        del fp32
    t1 = time.time()
    out_dyn = sample(qmodel)
    t_dyn = time.time() - t1
    print(f"int8-dynamic sampler done ({time.time() - t0:.1f}s)",
          flush=True)
    stat = DDNMInpainter(qmodel, t_sampling=args.t_sampling, seed=args.seed,
                         static_calib=True)
    if args.calib_margin is not None:
        stat.calib_margin = args.calib_margin
    stat.inpaint(calib_imgs, calib_masks)     # calibrates on the other shape
    t1 = time.time()
    out_stat = stat.inpaint(imgs, masks)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_stat = time.time() - t1
    print(f"int8-static sampler done ({time.time() - t0:.1f}s)", flush=True)

    known = (masks[..., None] > 0).expand_as(out_fp)

    def leg(out):
        return {"psnr_vs_bf16": round(psnr(out, out_fp), 2),
                "psnr_known_region": round(psnr(out[known], out_fp[known]),
                                           2),
                "corr": round(corr(out, out_fp), 5),
                "per_view_psnr": [round(psnr(out[i], out_fp[i]), 2)
                                  for i in range(len(imgs))],
                "finite": bool(torch.isfinite(out).all())}

    n_params = sum(p.numel() for p in model_fp.parameters())
    res = {
        "model": (f"guided-diffusion UNet, {n_params / 1e6:.1f}M params, "
                  "seeded random weights (no checkpoint ships)"),
        "shape": os.path.basename(args.pc_file),
        "calib_shape": os.path.basename(args.calib_pc),
        "t_sampling": args.t_sampling,
        "views": int(imgs.shape[0]),
        "res": int(imgs.shape[1]),
        "int8_dynamic": leg(out_dyn),
        "int8_static": dict(leg(out_stat),
                            psnr_vs_dynamic=round(psnr(out_stat, out_dyn),
                                                  2)),
        "fp32_floor": floor,
        "calib_margin": stat.calib_margin,
        "sampler_seconds": {"bf16": round(t_fp, 3),
                            "int8_dynamic": round(t_dyn, 3),
                            "int8_static": round(t_stat, 3)},
        "gates": {"full_image_min_db": 28.0, "corr_min": 0.99},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "wall_sec": round(time.time() - t0, 1),
    }
    if res["int8_dynamic"]["psnr_vs_bf16"] >= 119.0:
        raise RuntimeError("the int8 and bf16 samplers are bit-identical: "
                           "the comparison is vacuous")
    res["gates_pass"] = bool(res["int8_static"]["psnr_vs_bf16"] >= 28.0
                             and res["int8_static"]["corr"] >= 0.99)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print("wrote", args.out, "gates_pass:", res["gates_pass"])
    return res


if __name__ == "__main__":
    main()
