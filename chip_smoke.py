"""Smoke run of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build    : compile the port's CUDA kernels (csrc/*.cu, one nvcc per
                source in parallel) and the host hull and QEM libraries;
                print the build seconds and the card's name and power
                limit.
  2. input    : a gridded unit cube (6 x 40 x 40 x 2 = 19,200 triangles)
                as build/smoke/in/cube_untextured_mesh.obj and 30,000
                surface samples with the analytic colour field (seed 0) as
                build/smoke/in/cube.ply; the same cloud alone, with no
                cached mesh, as build/smoke/in_ply/cube.ply.
  3. kernels  : every kernel of the main paths against its plain torch
                version on the card, at the main paths' shapes: K1 raster
                (8 views x 512^2, and the 1024^2 atlas bake), K4 legacy
                raster (8 x 512^2 with and without back-face culling, and
                the optimizer's 8 x 256^2), K2 attention (bf16, T/heads =
                1024/8, 256/16, 64/16, batch 8), K3 segment sum (R = 1024
                with the optimizer's real tables).  CUDA-event medians of
                the kernel, the plain version and (where one exists) a
                single PyTorch library call of the same function, beside
                the bound the card's peak rates give.
  4. e2e      : Pipeline.create(configs/default.yaml, device="cuda") with a
                seeded random 552.8M-parameter bf16 UNet; one warm-up and
                one timed recon_one_textured_mesh (fresh output dirs, so
                DDNM runs both times).  Launch counts of the timed run must
                be K2 = 1600, K3 = 100, K1 >= 3; the OBJ/MTL/PNG must exist,
                > 50% of the atlas texels inside the mask non-black, and
                DDNM must return every known (painted) pixel of the sparse
                views unchanged.
  5. geometry : PD_USE_PALLAS_RASTER=1 and one timed recon_one_textured_mesh
                of the cloud alone on phase 4's Pipeline: SPR geometry
                (normals, Poisson + PCG, marching cubes, QEM, each timed)
                at grid 128 and 10,000 faces, then the texture path with K4
                at project and optimize.  Launches must be K4 = 2, K1 = 1
                (the bake), K2 = 1600, K3 = 100; the mesh must hold 8,000 to
                10,000 faces, its vertices lie within 0.01 of the cube on
                average, >= 99% of its faces face outward, and it must lie
                within 1e-3 (symmetric vertex-to-surface chamfer) of the
                port's own CPU reconstruction of the same cloud; the
                outputs pass phase 4's checks.  Two more reconstructions on
                the card report the run-to-run difference.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_raster(orast, cof, bbox, res: int, what: str) -> float:
    """K1 against its plain version on the same coefficients.  Both take
    the lexicographic minimum of (z, face id), so the face ids must be
    equal everywhere, exact z ties included; zbuf and barycentrics within
    1e-5.  Returns the max abs error."""
    import torch

    got = orast.rasterize_coefficients(cof, bbox, res)
    want = orast.rasterize_coefficients_plain(cof, bbox, res)
    torch.cuda.synchronize()
    n_diff = int((got.face_id != want.face_id).sum())
    if n_diff:
        fail(f"K1 ({what}) face ids differ at {n_diff} pixels")
    hit = got.face_id >= 0
    err = max(float((got.zbuf[hit] - want.zbuf[hit]).abs().max()),
              float((got.bary[hit] - want.bary[hit]).abs().max()))
    if not err <= 1e-5:
        fail(f"K1 ({what}) zbuf/bary differ by {err}")
    print(f"[K1 raster_binned] {what}: V={cof.shape[0]} res={res} "
          f"F={cof.shape[1]} covered={int(hit.sum())} "
          f"face_id_mismatches={n_diff} max_abs_err={err:.3g}")
    return err


def check_legacy(orast, tri, res: int, what: str) -> float:
    """K4 against its plain version on the same faces: face ids equal at
    every pixel (ties included), zbuf and barycentrics within 1e-5 where
    covered.  Returns the max abs error."""
    import torch

    got = orast.rasterize_legacy(tri, res)
    want = orast.rasterize_legacy_plain(tri, res)
    torch.cuda.synchronize()
    n_diff = int((got.face_id != want.face_id).sum())
    if n_diff:
        fail(f"K4 ({what}) face ids differ at {n_diff} pixels")
    hit = got.face_id >= 0
    if not bool(hit.any()):
        fail(f"K4 ({what}) covered no pixel")
    err = max(float((got.zbuf[hit] - want.zbuf[hit]).abs().max()),
              float((got.bary[hit] - want.bary[hit]).abs().max()))
    if not err <= 1e-5:
        fail(f"K4 ({what}) zbuf/bary differ by {err}")
    print(f"[K4 raster_legacy] {what}: V={tri.shape[0]} res={res} "
          f"F={tri.shape[1]} covered={int(hit.sum())} "
          f"face_id_mismatches={n_diff} max_abs_err={err:.3g}")
    return err


def to_surface(p, v, f, chunk: int = 512):
    """Distance from each point p [P,3] to the triangle mesh (v [V,3],
    f [F,3]), all torch tensors on one device: the nearest of the in-plane
    projection (when it falls inside a face) and the three edge
    segments."""
    import torch

    a, b, c = (v[f[:, i]].double() for i in range(3))
    n = torch.linalg.cross(b - a, c - a)
    n = n / n.norm(dim=1, keepdim=True).clamp(min=1e-20)
    out = []
    for q in torch.split(p.double(), chunk):
        q = q[:, None, :]
        h = ((q - a) * n).sum(-1)
        x = q - h[..., None] * n
        inside = torch.ones_like(h, dtype=torch.bool)
        for u, w in ((a, b), (b, c), (c, a)):
            inside &= (torch.linalg.cross((w - u).expand_as(x), x - u)
                       * n).sum(-1) >= 0
        d = torch.where(inside, h.abs(), torch.full_like(h, float("inf")))
        for u, w in ((a, b), (b, c), (c, a)):
            e = w - u
            t = (((q - u) * e).sum(-1) / (e * e).sum(-1).clamp(min=1e-30)
                 ).clamp(0.0, 1.0)
            d = torch.minimum(d, (q - u - t[..., None] * e).norm(dim=-1))
        out.append(d.min(1).values)
    return torch.cat(out)


def check_outputs(obj: str, cfg, what: str) -> None:
    """The exported OBJ/MTL/PNG exist, > 50% of the masked atlas texels are
    non-black, and DDNM kept every known (painted) pixel of the sparse
    views."""
    import numpy as np

    from pointdreamer_tpu_torch import io as pio

    base_path = obj[:-4]
    for ext in (".obj", ".mtl", ".png"):
        if not os.path.exists(base_path + ext):
            fail(f"missing {base_path + ext}")
    atlas = pio.load_png(base_path + ".png")
    others = os.path.join(os.path.dirname(os.path.dirname(obj)), "others")
    rgba = pio.load_png(os.path.join(others, "atlas_wo_background.png"))
    R = cfg.xatlas_texture_res
    if atlas.shape != (R, R, 3):
        fail(f"atlas shape {atlas.shape}")
    inside = rgba[..., 3] > 0
    nonblack = float((atlas[inside].max(-1) > 0).mean())
    print(f"[{what}] {obj}: atlas {atlas.shape}, mask "
          f"{float(inside.mean()):.3f} of texels, non-black inside mask "
          f"{nonblack:.4f}")
    if not nonblack > 0.5:
        fail(f"only {nonblack:.3f} of the masked atlas texels are non-black")

    # DDNM's data consistency: the last step has sigma = 0 and replaces
    # the known pixels by the sparse image, so every painted pixel of a
    # sparse view comes back unchanged (up to the 8-bit PNG rounding)
    n_known, worst = 0, 0.0
    for i in range(cfg.view_num):
        sp = pio.load_rgb(os.path.join(others, f"{i}_sparse.png"))
        inp = pio.load_rgb(os.path.join(others, f"{i}_inpainted.png"))
        known = sp.max(-1) > 0
        n_known += int(known.sum())
        worst = max(worst, float(np.abs(inp[known] - sp[known]).max()))
    print(f"[{what}] DDNM kept {n_known} known pixels of {cfg.view_num} "
          f"views within {worst:.4g} (bound 1/255)")
    if n_known == 0 or not worst <= 1.0 / 255 + 1e-6:
        fail(f"DDNM changed known pixels by {worst}")


def pixel_box_tests(ndc, faces, bbox, res: int) -> int:
    """The (pixel, face) tests a rasterizer needs at the least: for each
    face that can show, the pixels whose centres lie in its own xy box."""
    import torch

    tri = ((ndc * 0.5 + 0.5) * res)[:, faces.long()]        # [V,F,3,2]
    lo = torch.ceil(tri.amin(2) - 0.5).clamp(0, res - 1)
    hi = torch.floor(tri.amax(2) - 0.5).clamp(0, res - 1)
    n = (hi - lo + 1).clamp(min=0).prod(-1)
    return int(n[bbox[..., 0] <= bbox[..., 2]].sum())


def bound(bytes_moved: float, ops: float, ops_rate: float):
    from pointdreamer_tpu_torch.kernels import HBM_BYTES_PER_S

    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pointdreamer_tpu_torch import kernels, synthetic
    from pointdreamer_tpu_torch.kernels import (BF16_OPS_PER_S,
                                                FP32_OPS_PER_S)
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.log import StageTimer
    from pointdreamer_tpu_torch.models.diffusion.attention import (
        attention_qkv, attention_qkv_plain)
    from pointdreamer_tpu_torch.ops import hull as nhull
    from pointdreamer_tpu_torch.ops import qem as nqem
    from pointdreamer_tpu_torch.ops import raster as orast
    from pointdreamer_tpu_torch.pipeline import optimize as popt
    from pointdreamer_tpu_torch.pipeline import project as pproject
    from pointdreamer_tpu_torch.pipeline import unwrap as punwrap
    from pointdreamer_tpu_torch.pipeline.geometry import (normalize_points,
                                                          reconstruct_mesh)
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline
    from pointdreamer_tpu_torch import io as pio

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. build ---------------------------------------------------
    t0 = time.perf_counter()
    kernels.lib()
    nhull.build()
    nqem.build()
    print(f"[build] kernels + hull + qem built in "
          f"{time.perf_counter() - t0:.2f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. input ---------------------------------------------------
    work = os.path.join(REPO, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    ply = synthetic.write_cube_inputs(os.path.join(work, "in"), n_div=40,
                                      n_points=30000, seed=0)
    mesh = pio.load_obj(ply.replace(".ply", "_untextured_mesh.obj"))
    print(f"[input] {len(mesh['faces'])} triangles, 30000 points -> {ply}")
    ply_alone = synthetic.write_cube_inputs(
        os.path.join(work, "in_ply"), n_points=30000, seed=0,
        with_mesh=False)
    print(f"[input] the same 30000 points, no cached mesh -> {ply_alone}")

    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    table = []

    # ---- 3. kernels vs plain ----------------------------------------
    xyz, _ = pio.read_ply_xyzrgb(ply)
    xyz_n, center, scale = normalize_points(xyz)
    verts = ((mesh["vertices"] - center) / scale).astype("float32")
    faces = mesh["faces"]
    from pointdreamer_tpu_torch.camera import make_camera_rig

    rig = make_camera_rig(cfg.view_num, cfg.cam_distance, cfg.cam_res,
                          cfg.cam_fov_deg, cfg.camera_distribution, device=dev)
    verts_t = torch.as_tensor(verts, device=dev)
    faces_t = torch.as_tensor(faces, device=dev)

    # K1 at the project stage's shape: 8 views x 512^2, no culling
    ndc, depth = rig.transform(verts_t)
    lo, hi = ndc.amin(1, keepdim=True), ndc.amax(1, keepdim=True)
    ndc = (ndc - (lo + hi) / 2) / (hi - lo).amax(2, keepdim=True) \
        * (1 - 2 * cfg.crop_padding) * 2.0
    res = cfg.cam_res
    cof, bbox = orast.prepare_views(ndc, depth, faces_t, res, False)
    k1_err = check_raster(orast, cof, bbox, res, "project")
    # and at the atlas bake's shape: one 1024^2 view of the uv layout,
    # depth 1 everywhere, so every overlap is an exact z tie
    R = cfg.xatlas_texture_res
    uvs, fuv = punwrap.unwrap(verts, faces, atlas_res=R)
    uv_t = torch.as_tensor(uvs, device=dev)
    cof_b, bbox_b = orast.prepare_views(
        (uv_t * 2.0 - 1.0)[None], torch.ones((1, len(uvs)), device=dev),
        torch.as_tensor(fuv, device=dev), R, False)
    k1_err = max(k1_err, check_raster(orast, cof_b, bbox_b, R, "bake"))
    pairs = orast.tile_face_pairs(bbox)
    tests = pixel_box_tests(ndc, faces_t, bbox, res)
    V, F = cof.shape[:2]
    k1_ms = cuda_ms(lambda: orast.rasterize_coefficients(cof, bbox, res))
    k1_plain = cuda_ms(lambda: orast.rasterize_coefficients_plain(
        cof, bbox, res), reps=3, warmup=1)
    # 16 operations per (pixel, face) test: three edge functions and z
    k1_bound, k1_by = bound(V * F * 16 * 4 + V * res * res * 20,
                            16.0 * tests, FP32_OPS_PER_S)
    print(f"[K1 raster_binned] V={V} res={res} F={F} pixel_box_tests={tests} "
          f"kernel_tile_pairs={pairs} max_abs_err={k1_err:.3g} "
          f"ms={k1_ms:.4f} plain_ms={k1_plain:.3f} "
          f"bound_ms={k1_bound:.4f} ({k1_by})")
    table.append(dict(name="raster_binned", route="cuda",
                      source="pointdreamer_tpu_torch/csrc/raster.cu",
                      replaces="pointdreamer_tpu/kernels/raster_pallas.py:143",
                      max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
                      bound_ms=k1_bound, bound_by=k1_by, library_ms=None))

    # K2 at the UNet's three attention shapes (per forward: 5 + 5 + 6)
    import torch.nn.functional as F_

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
              err=0.0)
    for T, heads, per_fwd in ((1024, 8, 5), (256, 16, 5), (64, 16, 6)):
        B, C = 8, heads * 64
        qkv = torch.randn((B, T, 3 * C), generator=gen, device=dev,
                          dtype=torch.float32).to(torch.bfloat16)
        out = attention_qkv(qkv, heads)
        ref = attention_qkv_plain(qkv, heads)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if not (err <= 2e-2):
            fail(f"K2 T={T} heads={heads}: max abs err {err}")
        q, k, v = qkv.reshape(B, T, heads, 3, 64).permute(3, 0, 2, 1, 4)
        ms = cuda_ms(lambda: attention_qkv(qkv, heads))
        pms = cuda_ms(lambda: attention_qkv_plain(qkv, heads))
        lms = cuda_ms(lambda: F_.scaled_dot_product_attention(q, k, v))
        by = B * T * 3 * C * 2 + B * T * C * 2
        ops = 4.0 * B * heads * T * T * 64
        b_ms, b_by = bound(by, ops, BF16_OPS_PER_S)
        print(f"[K2 attention_qkv] B={B} T={T} heads={heads} "
              f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={pms:.4f} "
              f"sdpa_ms={lms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"x{per_fwd} per UNet forward")
        k2["ms"] += per_fwd * ms
        k2["plain_ms"] += per_fwd * pms
        k2["library_ms"] += per_fwd * lms
        k2["bytes"] += per_fwd * by
        k2["ops"] += per_fwd * ops
        k2["err"] = max(k2["err"], err)
    k2_bound, k2_by = bound(k2["bytes"], k2["ops"], BF16_OPS_PER_S)
    print(f"[K2 attention_qkv] per UNet forward (16 launches): "
          f"ms={k2['ms']:.4f} plain_ms={k2['plain_ms']:.4f} "
          f"sdpa_ms={k2['library_ms']:.4f} bound_ms={k2_bound:.4f}")
    table.append(dict(name="attention_qkv", route="cuda",
                      source="pointdreamer_tpu_torch/csrc/attention.cu",
                      replaces=("pointdreamer_tpu/kernels/"
                                "attention_pallas.py:97"),
                      max_abs_err=k2["err"], ms=k2["ms"],
                      plain_ms=k2["plain_ms"], bound_ms=k2_bound,
                      bound_by=k2_by, library_ms=k2["library_ms"]))

    # K3 at R = 1024 with the optimizer's real pixel tables
    proj = pproject.project_views(rig, verts_t, faces_t,
                                  torch.as_tensor(xyz_n, device=dev),
                                  padding=cfg.crop_padding,
                                  cull_backface=False)
    ones = torch.ones(cfg.view_num, device=dev)
    uv_map, fg = popt.precompute_view_uv_maps(
        rig, verts_t, faces_t, torch.as_tensor(uvs, device=dev),
        torch.as_tensor(fuv, device=dev), proj.uv_centers, proj.uv_scales,
        proj.padding, ones, cfg.optimize_render_res)
    tgt_s, msk_s, base, w4, cum_bounds, denom = popt.active_pixel_tables(
        torch.zeros(fg.shape + (3,), device=dev), uv_map, fg.float(), R)
    K = base.shape[0]
    g_pix = torch.randn((K, 3), generator=gen, device=dev) * msk_s / denom
    contrib = (w4.T[:, None, :] * g_pix.T[None]).reshape(12, K).contiguous()
    got3 = popt.segment_sum(contrib, cum_bounds)
    want3 = popt.segment_sum_plain(contrib, cum_bounds)
    torch.cuda.synchronize()
    k3_err = float((got3 - want3).abs().max())
    scale3 = float(want3.abs().max())
    if not (k3_err <= 1e-5 * scale3):
        fail(f"K3 relative error {k3_err / scale3}")
    k3_ms = cuda_ms(lambda: popt.segment_sum(contrib, cum_bounds))
    k3_plain = cuda_ms(lambda: popt.segment_sum_plain(contrib, cum_bounds))
    k3_lib = cuda_ms(lambda: torch.zeros((12, R * R), device=dev)
                     .index_add_(1, base, contrib))
    k3_bound, k3_by = bound(12 * K * 4 + R * R * 4 + 12 * R * R * 4,
                            12.0 * K, FP32_OPS_PER_S)
    print(f"[K3 segment_sum] K={K} R={R} active={int(fg.sum())} "
          f"max_abs_err={k3_err:.3g} (rel {k3_err / scale3:.3g}) "
          f"ms={k3_ms:.4f} plain_ms={k3_plain:.4f} "
          f"index_add_ms={k3_lib:.4f} bound_ms={k3_bound:.4f} ({k3_by})")
    table.append(dict(name="segment_sum", route="cuda",
                      source="pointdreamer_tpu_torch/csrc/segsum.cu",
                      replaces="pointdreamer_tpu/kernels/segsum_pallas.py:67",
                      max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
                      bound_ms=k3_bound, bound_by=k3_by, library_ms=k3_lib))

    # K4 at project's 8 x 512^2, with and without back-face culling (the
    # timed row culls, as project does on the port's own reconstruction),
    # and at the optimizer's 8 x 256^2 view maps (culled)
    tri_k4 = orast.prepare_legacy(ndc, depth, faces_t, res, False)
    k4_err = check_legacy(orast, tri_k4, res, "project, no culling")
    tri_k4 = orast.prepare_legacy(ndc, depth, faces_t, res, True)
    k4_err = max(k4_err, check_legacy(orast, tri_k4, res, "project, culled"))
    rr = cfg.optimize_render_res
    ndc_o, depth_o = rig.transform(verts_t)
    ndc_o = ((ndc_o - proj.uv_centers) / proj.uv_scales
             * (1.0 - 2.0 * proj.padding) + 0.5).clamp(0.0, 1.0) * 2.0 - 1.0
    tri_o = orast.prepare_legacy(ndc_o, depth_o, faces_t, rr, True)
    k4_err = max(k4_err, check_legacy(orast, tri_o, rr, "optimize"))
    _, bbox_c = orast.prepare_views(ndc, depth, faces_t, res, True)
    tests4 = pixel_box_tests(ndc, faces_t, bbox_c, res)
    k4_ms = cuda_ms(lambda: orast.rasterize_legacy(tri_k4, res))
    k4_plain = cuda_ms(lambda: orast.rasterize_legacy_plain(tri_k4, res),
                       reps=3, warmup=1)
    k4_opt_ms = cuda_ms(lambda: orast.rasterize_legacy(tri_o, rr))
    # bytes: the 13 floats of each face and view in, 20 B a pixel out;
    # operations: 16 per (pixel, face) test of each face's own xy box
    k4_bound, k4_by = bound(tri_k4.numel() * 4 + V * res * res * 20,
                            16.0 * tests4, FP32_OPS_PER_S)
    print(f"[K4 raster_legacy] V={V} res={res} F={F} culled "
          f"pixel_box_tests={tests4} max_abs_err={k4_err:.3g} "
          f"ms={k4_ms:.4f} plain_ms={k4_plain:.3f} "
          f"bound_ms={k4_bound:.4f} ({k4_by}); optimize {rr}^2 "
          f"ms={k4_opt_ms:.4f}")
    table.append(dict(name="raster_legacy", route="cuda",
                      source="pointdreamer_tpu_torch/csrc/raster_legacy.cu",
                      replaces="pointdreamer_tpu/kernels/raster_pallas.py:310",
                      max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
                      bound_ms=k4_bound, bound_by=k4_by, library_ms=None))
    del proj, uv_map, fg, contrib, tri_k4, tri_o

    # ---- 4. end to end ----------------------------------------------
    os.environ.pop("PD_USE_PALLAS_RASTER", None)
    cfg.output_path = os.path.join(work, "out_warmup")
    t0 = time.perf_counter()
    pipe = Pipeline.create(cfg, device="cuda", allow_random_diffusion=True)
    unet = pipe.inpainter.model
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"[e2e] UNet {n_params} parameters ({n_params / 1e6:.1f}M) "
          f"built in {time.perf_counter() - t0:.2f} s")
    if n_params != 552_814_086:
        fail(f"UNet has {n_params} parameters, not 552,814,086")
    t0 = time.perf_counter()
    pipe.recon_one_textured_mesh(ply)
    torch.cuda.synchronize()
    print(f"[e2e] warm-up run {time.perf_counter() - t0:.2f} s")

    cfg.output_path = os.path.join(work, "out_timed")
    timer = StageTimer(None, sync=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    obj = pipe.recon_one_textured_mesh(ply, timer=timer)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stages = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"[e2e] timed run {total:.3f} s stages {json.dumps(stages)}")
    print(f"[e2e] launches {json.dumps(launches)}")
    if launches["attention_qkv"] != 1600:
        fail(f"K2 launched {launches['attention_qkv']} times, not 1600")
    if launches["segment_sum"] != 100:
        fail(f"K3 launched {launches['segment_sum']} times, not 100")
    if launches["raster_binned"] < 3:
        fail(f"K1 launched {launches['raster_binned']} times, not >= 3")
    for t, key in zip(table, ("raster_binned", "attention_qkv",
                              "segment_sum")):
        t["launches"] = launches[key]
    check_outputs(obj, cfg, "e2e")

    # ---- 5. geometry from the cloud, K4 on ---------------------------
    os.environ["PD_USE_PALLAS_RASTER"] = "1"
    cfg.output_path = os.path.join(work, "out_ply")
    timer = StageTimer(None, sync=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    obj = pipe.recon_one_textured_mesh(ply_alone, timer=timer)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    os.environ.pop("PD_USE_PALLAS_RASTER")
    stages = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"[geometry] timed run {total:.3f} s stages {json.dumps(stages)}")
    print(f"[geometry] launches {json.dumps(launches)}")
    want_launches = {"raster_legacy": 2, "raster_binned": 1,
                     "attention_qkv": 1600, "segment_sum": 100}
    if launches != want_launches:
        fail(f"launches {launches}, not {want_launches}")
    table[-1]["launches"] = launches["raster_legacy"]
    check_outputs(obj, cfg, "geometry")

    # the reconstructed mesh (normalized frame), against the cube
    geo = pio.load_obj(os.path.join(os.path.dirname(os.path.dirname(obj)),
                                    "geo", "untextured.obj"))
    v_np, f_np = geo["vertices"].astype(np.float32), geo["faces"]
    nf = len(f_np)
    xyz_a, _ = pio.read_ply_xyzrgb(ply_alone)
    xyz_n, _, _ = normalize_points(xyz_a)
    lo, hi = xyz_n.min(0), xyz_n.max(0)
    d_out = np.maximum(np.maximum(lo - v_np, v_np - hi), 0.0)
    d_in = np.minimum(v_np - lo, hi - v_np).min(1)
    dist = np.where(d_out.max(1) > 0, np.linalg.norm(d_out, axis=1), d_in)
    tri = v_np[f_np]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outward = float(((nrm * (tri.mean(1) - (lo + hi) / 2)).sum(1) > 0)
                    .mean())
    print(f"[geometry] mesh {len(v_np)} vertices {nf} faces; distance to "
          f"the cube mean {dist.mean():.5f} p95 "
          f"{np.percentile(dist, 95):.5f}; outward faces {outward:.5f}")
    if not 0.8 * cfg.target_face_num <= nf <= cfg.target_face_num:
        fail(f"{nf} faces, not within 0.8-1.0 x {cfg.target_face_num}")
    if not dist.mean() < 0.01:
        fail(f"mean vertex distance to the cube {dist.mean()}")
    if not outward >= 0.99:
        fail(f"only {outward} of the faces face outward")

    # against the port's own CPU run on the same cloud, and a second run
    # on the card (run to run)
    args = (xyz_n, cfg.geo_from, cfg.grid_res, cfg.target_face_num)
    kw = dict(refine_iters=cfg.refine_vertex_iters,
              screen_weight=cfg.spr_screen_weight)
    t0 = time.perf_counter()
    v_cpu, f_cpu = reconstruct_mesh(*args, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    v_1, f_1 = reconstruct_mesh(*args, device=dev, **kw)
    v_2, f_2 = reconstruct_mesh(*args, device=dev, **kw)

    def same(f_a, f_b):
        return f_a.shape == f_b.shape and bool((f_a == f_b).all())

    tv, tf = torch.as_tensor(v_np, device=dev), torch.as_tensor(f_np,
                                                                device=dev)
    cv = torch.as_tensor(v_cpu, device=dev)
    cf = torch.as_tensor(f_cpu, device=dev)
    chamfer = 0.5 * float(to_surface(tv, cv, cf).mean()
                          + to_surface(cv, tv, tf).mean())
    dv_2 = float(np.abs(v_2 - v_1).max()) if same(f_1, f_2) \
        else float("nan")
    print(f"[geometry] card vs CPU ({t_cpu:.2f} s on the host): chamfer "
          f"{chamfer:.3g}, {len(f_cpu)} CPU faces, same faces "
          f"{same(f_cpu, f_np)}; two more card runs: the pipeline's faces "
          f"{same(f_1, f_np)}, same faces as each other {same(f_1, f_2)}, "
          f"max vertex diff {dv_2}")
    if not chamfer < 1e-3:
        fail(f"card mesh {chamfer} from the CPU mesh (bound 1e-3)")

    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
