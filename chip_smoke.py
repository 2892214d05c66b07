"""Smoke run of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build    : compile the port's CUDA kernels (csrc/*.cu, one nvcc per
                source in parallel, -Xptxas -v kept beside the library) and
                the host hull and QEM libraries; count the tensor-core
                instructions (HMMA/HGMMA, `cuobjdump -sass`) of K2's
                six bf16 instantiations and of K6 and fail if any has
                none;
                print their registers, the build seconds and the card's
                name and power limit.
  2. input    : a gridded unit cube (6 x 40 x 40 x 2 = 19,200 triangles)
                as build/smoke/in/cube_untextured_mesh.obj and 30,000
                surface samples with the analytic colour field (seed 0) as
                build/smoke/in/cube.ply; the same cloud alone, with no
                cached mesh, as build/smoke/in_ply/cube.ply.
  3. kernels  : every kernel of the main paths against its plain torch
                version on the card, at the main paths' shapes: K1 raster
                (8 views x 512^2, the optimizer's 8 x 256^2 and the
                1024^2 atlas bake, each timed beside its bound), K4 legacy
                raster (8 x 512^2 with and without back-face culling, and
                the optimizer's 8 x 256^2), K2 attention (bf16, T/heads =
                1024/8, 256/16, 64/16, batch 8; then the training shapes:
                fp32 hd 16 at T = 64, ragged T, and its gradient, kernel
                forward + reference backward, against autograd through
                the plain version), K3 segment sum (R = 1024 with the
                optimizer's real tables), K5 GroupNorm at the UNet's
                shapes (bf16, B = 8), K6 Winograd 3x3 at two ragged
                shapes (checked only), [8,256,256,256] -> 256 and
                [8,16,16,1024] -> 1024 (the function, weight transform
                included, and the kernel alone on a precomputed U).
                CUDA-event medians of the kernel, the plain version and
                (where one exists) a single PyTorch library call of the
                same function, beside the bound the card's peak rates
                give; for K2, K3 and K5 also the device time of each
                launch and of the library call's from CUDA-graph replays
                (no host time).
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
  6. training : the DDPM trainer (models/diffusion/train.py).  (a) The
                training CLI's fp32 UNet (32 channels, res 32, batch 64):
                one loss + backward on the card and on the CPU from the
                same weights and draws; the losses agree and every
                parameter's gradient is present, finite and near the
                CPU's (the gate a cut autograd graph fails).  (b)
                fit_ddpm on the card, 2 epochs x 100 steps: epoch 2's mean
                loss below epoch 1's, K2 launched 4 times per step.  (c)
                The 552.8M UNet with fp32 parameters and bf16 compute at
                256^2, batch 4: 3 steps with finite losses and gradients,
                every parameter moved, K2 launched 16 times per step; ms
                per step and peak memory.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
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


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median device milliseconds of one fn() call: n calls captured in a
    CUDA graph and replayed, so the Python wrapper's host time drops out
    (the launches a caller queues behind a busy card see this time)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    times.sort()
    return times[len(times) // 2]


def check_tensor_cores(path: str) -> None:
    """K2's bf16 instantiations and K6 must hold tensor-core instructions
    (HMMA / HGMMA in `cuobjdump -sass` of the built library); print each
    count and the registers `-Xptxas -v` gave them."""
    import re

    from pointdreamer_tpu_torch import kernels

    counts = kernels.sass_mma_counts(path)
    want = {f"K2 bf16 hd {hd}{' masked' if m else ''}":
            f"attn_mma_kernelILi{hd}ELb{m}E"
            for hd in (16, 32, 64) for m in (0, 1)}
    want["K6"] = "wino_mma_kernel"
    with open(path + ".ptxas.txt") as f:
        ptxas = f.read()
    for what, key in want.items():
        found = [c for name, c in counts.items() if key in name]
        regs = re.search(re.escape(key) + r".*?Used (\d+) registers",
                         ptxas, re.S)
        spills = re.search(re.escape(key) + r".*?(\d+) bytes spill stores",
                           ptxas, re.S)
        print(f"[build] {what}: {found[0] if found else 0} tensor-core "
              f"instructions (HMMA/HGMMA), "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{spills.group(1) if spills else '?'} bytes spilled")
        if len(found) != 1 or found[0] == 0:
            fail(f"{what}: no tensor-core instructions in its SASS "
                 f"({found})")
    fp32 = [c for name, c in counts.items() if "attn_fma_kernel" in name]
    print(f"[build] K2 fp32 (CUDA-core FMAs): {len(fp32)} instantiations, "
          f"{sum(fp32)} tensor-core instructions")


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


def bf16_ulp(v):
    """One bf16 ulp at |v|, taken at no less than 2^-8: below that a
    normalized output is the difference of O(1) fp32 terms, whose rounding
    exceeds the bf16 ulp."""
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -8)))
                      - 7)


def check_groupnorm(dev, gen) -> dict:
    """K5 against its plain version at the 552.8M UNet's GroupNorm shapes
    (bf16 in and out, B = 8): within one bf16 ulp of the output.  Prints,
    for each shape, the wrapper's ms and its device ms (CUDA-graph
    replays), F.group_norm's two, and the bound.  Returns the kernel
    table row (times and bounds summed over the shapes)."""
    import torch
    import torch.nn.functional as F_

    from pointdreamer_tpu_torch.kernels import FP32_OPS_PER_S
    from pointdreamer_tpu_torch.kernels.groupnorm import (
        _resident, fused_groupnorm, fused_groupnorm_plain, launch_plan)

    dev = torch.device("cuda", torch.cuda.current_device())
    row = dict(name="groupnorm", route="cuda",
               source="pointdreamer_tpu_torch/csrc/groupnorm.cu",
               replaces="pointdreamer_tpu/kernels/groupnorm_pallas.py:113",
               max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0)
    print(f"[K5 groupnorm] resident clusters (blocks, clusters): "
          f"{_resident(dev, True, True)}")
    by = ops = 0.0
    for (B, S, C), with_ss, silu, what in (
            ((8, 65536, 256), True, True, "256^2 ResBlock out_norm"),
            ((8, 65536, 512), False, True, "256^2 first output block"),
            ((8, 256, 1024), False, False, "16^2 attention norm"),
            ((8, 64, 2048), False, False, "8^2 output-block concat")):
        x = (torch.randn((B, S, C), generator=gen, device=dev) * 2.0
             + 0.3).to(torch.bfloat16)
        g = torch.randn(C, generator=gen, device=dev) * 0.5 + 1.0
        b = torch.randn(C, generator=gen, device=dev) * 0.2
        ss = (torch.randn((B, 2 * C), generator=gen, device=dev) * 0.3
              if with_ss else None)
        got = fused_groupnorm(x, g, b, ss, silu=silu)
        want = fused_groupnorm_plain(x, g, b, ss, silu=silu).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        ulps = float((err / bf16_ulp(want)).max())
        if not ulps <= 1.0:
            fail(f"K5 {(B, S, C)}: {ulps} bf16 ulps from its plain version")
        # 30 calls for the wrapper times: at the small shapes they are the
        # host's, which varies from call to call
        ms = cuda_ms(lambda: fused_groupnorm(x, g, b, ss, silu=silu),
                     reps=30)
        gms = graph_ms(lambda: fused_groupnorm(x, g, b, ss, silu=silu))
        pms = cuda_ms(lambda: fused_groupnorm_plain(x, g, b, ss, silu=silu),
                      reps=3, warmup=1)
        xc = x.transpose(1, 2).contiguous()
        gb, bb = g.bfloat16(), b.bfloat16()
        lms = cuda_ms(lambda: F_.group_norm(xc, 32, gb, bb, 1e-5), reps=30)
        glms = graph_ms(lambda: F_.group_norm(xc, 32, gb, bb, 1e-5))
        # one read of x and one write of y (bf16), gamma/beta/ss once;
        # per element: sum, square, sum of squares, scale, bias, and 3
        # for the scale-shift, 4 for the SiLU
        n = B * S * C
        b_x = n * 4 + C * 8 + (B * 2 * C * 4 if with_ss else 0)
        o_x = n * (5 + 3 * with_ss + 4 * silu)
        b_ms, b_by = bound(b_x, o_x, FP32_OPS_PER_S)
        plan = launch_plan(B, S, C, 2, 2, _resident(dev, True, True))
        print(f"[K5 groupnorm] {what} {[B, S, C]} ss={with_ss} silu={silu} "
              f"{plan} max_abs_err={float(err.max()):.3g} ({ulps:.3g} bf16 ulp) "
              f"ms={ms:.4f} device_ms={gms:.4f} plain_ms={pms:.4f} "
              f"group_norm_ms={lms:.4f} group_norm_device_ms={glms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}; device time "
              f"{b_ms / gms:.0%} of it)")
        row["max_abs_err"] = max(row["max_abs_err"], float(err.max()))
        row["ms"] += ms
        row["plain_ms"] += pms
        row["library_ms"] += lms
        by += b_x
        ops += o_x
        del x, got, want, err, xc
    row["bound_ms"], row["bound_by"] = bound(by, ops, FP32_OPS_PER_S)
    print(f"[K5 groupnorm] 4 shapes: ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"group_norm_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f}")
    return row


def check_segsum(popt, contrib, cum_bounds, base, R: int, what: str) -> dict:
    """K3 against its plain version (within 1e-5 of the largest output) on
    the optimizer's tables; prints the wrapper's and the device ms (CUDA
    graph) of K3 and of index_add_ beside the bound.  Returns the table
    row."""
    import torch

    from pointdreamer_tpu_torch.kernels import FP32_OPS_PER_S

    K = contrib.shape[1]
    got = popt.segment_sum(contrib, cum_bounds)
    want = popt.segment_sum_plain(contrib, cum_bounds)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-5 * scale:
        fail(f"K3 ({what}) relative error {err / scale}")
    ms = cuda_ms(lambda: popt.segment_sum(contrib, cum_bounds))
    gms = graph_ms(lambda: popt.segment_sum(contrib, cum_bounds))
    plain = cuda_ms(lambda: popt.segment_sum_plain(contrib, cum_bounds))

    def library():
        return torch.zeros((12, R * R), device=contrib.device).index_add_(
            1, base, contrib)

    lib_ms = cuda_ms(library)
    lib_gms = graph_ms(library)
    b_ms, b_by = bound(12 * K * 4 + R * R * 4 + 12 * R * R * 4, 12.0 * K,
                       FP32_OPS_PER_S)
    print(f"[K3 segment_sum] {what}: K={K} R={R} max_abs_err={err:.3g} "
          f"(rel {err / scale:.3g}) ms={ms:.4f} device_ms={gms:.4f} "
          f"plain_ms={plain:.4f} index_add_ms={lib_ms:.4f} "
          f"index_add_device_ms={lib_gms:.4f} bound_ms={b_ms:.4f} ({b_by}; "
          f"device time {b_ms / gms:.0%} of it)")
    return dict(name="segment_sum", route="cuda",
                source="pointdreamer_tpu_torch/csrc/segsum.cu",
                replaces="pointdreamer_tpu/kernels/segsum_pallas.py:67",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_winograd(dev, gen) -> dict:
    """K6 against its plain version (relative max |d| <= 1e-2 of max |y|)
    at two ragged shapes, then also against F.conv2d in bf16,
    channels-last (<= 2e-2), at the UNet's dominant 3x3 conv and at the
    16^2 x 1024 one.  Returns the table row (summed over the two timed
    shapes)."""
    import torch
    import torch.nn.functional as F_

    from pointdreamer_tpu_torch.kernels import BF16_OPS_PER_S
    from pointdreamer_tpu_torch.kernels.winograd import (
        transform_weights, winograd_conv3x3, winograd_conv3x3_plain,
        winograd_conv3x3_pretransformed)

    row = dict(name="winograd_conv3x3", route="cuda",
               source="pointdreamer_tpu_torch/csrc/winograd.cu",
               replaces="pointdreamer_tpu/kernels/winograd_pallas.py:145",
               max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0)
    # ragged: tile rows and columns that are no multiple of the kernel's
    # 8 x 8 tile block; the second also Cin and Cout no multiple of 64
    for B, H, W, Cin, Cout in ((1, 24, 20, 128, 128), (2, 22, 38, 48, 96)):
        x = torch.randn((B, H, W, Cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, Cin, Cout), generator=gen,
                        device=dev) / math.sqrt(9 * Cin)
        got = winograd_conv3x3(x, w).float()
        want = winograd_conv3x3_plain(x, w).float()
        torch.cuda.synchronize()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        print(f"[K6 winograd] {[B, H, W, Cin]} -> {Cout}: relative error "
              f"{rel:.3g} against the plain version")
        if not rel <= 1e-2:
            fail(f"K6 {[B, H, W, Cin, Cout]}: relative error {rel}")
    by = ops = 0.0
    for B, H, W, Cin, Cout in ((8, 256, 256, 256, 256),
                               (8, 16, 16, 1024, 1024)):
        x = torch.randn((B, H, W, Cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, Cin, Cout), generator=gen,
                        device=dev) / math.sqrt(9 * Cin)
        got = winograd_conv3x3(x, w)
        want = winograd_conv3x3_plain(x, w)
        wl = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        xl = x.permute(0, 3, 1, 2)              # NHWC memory: channels-last
        lib = F_.conv2d(xl, wl, padding=1).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        err_lib = float((got.float() - lib.float()).abs().max())
        rel, rel_lib = err / scale, err_lib / float(lib.float().abs().max())
        if not (rel <= 1e-2 and rel_lib <= 2e-2):
            fail(f"K6 {[B, H, W, Cin, Cout]}: relative error {rel} against "
                 f"the plain version, {rel_lib} against F.conv2d")
        u = transform_weights(w)
        ms = cuda_ms(lambda: winograd_conv3x3(x, w))
        tms = cuda_ms(lambda: transform_weights(w))
        kms = cuda_ms(lambda: winograd_conv3x3_pretransformed(x, u))
        pms = cuda_ms(lambda: winograd_conv3x3_plain(x, w), reps=3,
                      warmup=1)
        lms = cuda_ms(lambda: F_.conv2d(xl, wl, padding=1))
        # the Winograd's own operations (16 multiplies per 4 outputs), as
        # the Pallas cost estimate counts them, at the bf16 peak; bytes:
        # x, U and y once
        o_x = 2.0 * B * H * W * Cin * Cout * 4
        b_x = B * H * W * (Cin + Cout) * 2 + 16 * Cin * Cout * 2
        b_ms, b_by = bound(b_x, o_x, BF16_OPS_PER_S)
        direct_ms = 2.0 * B * H * W * Cin * Cout * 9 / BF16_OPS_PER_S * 1e3
        print(f"[K6 winograd] {[B, H, W, Cin]} -> {Cout}: max_abs_err="
              f"{err:.3g} (rel {rel:.3g}; vs conv2d rel {rel_lib:.3g}) "
              f"ms={ms:.4f} plain_ms={pms:.4f} conv2d_ms={lms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}; direct conv {direct_ms:.4f}); "
              f"kernel alone on a precomputed U {kms:.4f}, weight transform "
              f"{tms:.4f}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += pms
        row["library_ms"] += lms
        by += b_x
        ops += o_x
        del x, got, want, lib, u
    row["bound_ms"], row["bound_by"] = bound(by, ops, BF16_OPS_PER_S)
    print(f"[K6 winograd] 2 shapes: ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} conv2d_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f}")
    return row


def check_attention_training(dev, gen) -> None:
    """K2 at the shapes the JAX kernel takes beyond the inference path: the
    training CLI's fp32 hd 16 at T = 64 (4 heads, batch 64), fp32 hd 64
    and bf16 hd 32 at ragged T; then the gradient (kernel forward,
    reference backward) against autograd through the plain version, at
    the CLI's shape and the 552.8M UNet's T = 1024.  fp32 within 1e-5
    (forward) and 1e-4 of max |grad|; bf16 within 2e-2, the forward also
    within 2e-2 of max |out|."""
    import torch

    from pointdreamer_tpu_torch.models.diffusion.attention import (
        attention_qkv, attention_qkv_plain)

    f32, bf16 = torch.float32, torch.bfloat16
    for B, T, heads, hd, dt in ((64, 64, 4, 16, f32), (8, 72, 2, 64, f32),
                                (8, 136, 4, 32, bf16)):
        qkv = torch.randn((B, T, 3 * heads * hd), generator=gen,
                          device=dev).to(dt)
        out = attention_qkv(qkv, heads)
        ref = attention_qkv_plain(qkv, heads)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        tol = 1e-5 if dt == f32 else 2e-2
        if not (err <= tol and (dt == f32 or rel <= 2e-2)):
            fail(f"K2 {dt} hd={hd} T={T}: max abs err {err}, relative to "
                 f"max |out| {rel}")
        ms = cuda_ms(lambda: attention_qkv(qkv, heads))
        print(f"[K2 attention_qkv] {str(dt)[6:]} B={B} T={T} heads={heads} "
              f"hd={hd} max_abs_err={err:.3g} (rel {rel:.3g}) ms={ms:.4f}")
    for B, T, heads, hd, dt in ((64, 64, 4, 16, f32), (4, 1024, 8, 64, bf16)):
        qkv = torch.randn((B, T, 3 * heads * hd), generator=gen,
                          device=dev).to(dt)
        g = torch.randn((B, T, heads * hd), generator=gen, device=dev).to(dt)
        x = qkv.clone().requires_grad_(True)
        attention_qkv(x, heads).backward(g)
        y = qkv.clone().requires_grad_(True)
        attention_qkv_plain(y, heads).backward(g)
        torch.cuda.synchronize()
        if x.grad is None:
            fail(f"K2 {dt} hd={hd} T={T}: no gradient reached qkv")
        rel = float((x.grad.float() - y.grad.float()).abs().max()
                    / y.grad.float().abs().max())
        tol = 1e-4 if dt == f32 else 2e-2
        if not rel <= tol:
            fail(f"K2 gradient {dt} hd={hd} T={T}: relative error {rel}")
        print(f"[K2 attention_qkv] gradient {str(dt)[6:]} B={B} T={T} "
              f"heads={heads} hd={hd}: kernel forward + reference backward "
              f"vs autograd through the plain version, max |d| / max |g| "
              f"{rel:.3g}")


def train_cli_model(dev) -> None:
    """Phase 6 (a) and (b) on the training CLI's fp32 UNet."""
    import torch

    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.cli.train_ddnm_synthetic import build_model
    from pointdreamer_tpu_torch.models.diffusion import train as dtrain
    from pointdreamer_tpu_torch.models.diffusion.synthetic_images import \
        sample_images

    # (a) one loss + backward from the same weights and draws on the CPU
    # and on the card (TF32 off).  The seeded init zeroes the layers the
    # reference zero-initializes, which would leave most gradients 0: a
    # seeded perturbation of every weight makes each gradient informative
    cpu = build_model(32, "cpu", seed=0)
    g0 = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=g0) * 0.02)
    card = build_model(32, dev, seed=0)
    card.load_state_dict(cpu.state_dict())
    gd = torch.Generator().manual_seed(2)
    x0 = sample_images(gd, 64, 32) * 2.0 - 1.0
    t = torch.randint(0, 1000, (64,), generator=gd)
    eps = torch.randn(x0.shape, generator=gd)
    losses, grads = {}, {}
    for name, m, d in (("cpu", cpu, torch.device("cpu")), ("card", card,
                                                            dev)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = dtrain.ddpm_loss(m, x0.to(d), t.to(d), eps.to(d),
                                dtrain.alphas_cumprod(device=d))
        loss.backward()
        losses[name] = loss.item()
        print(f"[train] CLI model, batch 64 at 32^2, one loss + backward on "
              f"the {name}: loss {losses[name]:.7f} in "
              f"{time.perf_counter() - t0:.3f} s (first call)")
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    if kernels.LAUNCHES["attention_qkv"] != 4:
        fail(f"K2 launched {kernels.LAUNCHES['attention_qkv']} times in one "
             f"step of the CLI model, not 4")
    if not abs(losses["card"] - losses["cpu"]) <= 1e-5 * losses["cpu"]:
        fail(f"losses differ: card {losses['card']} cpu {losses['cpu']}")
    top = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst, worst_name = 0.0, ""
    for n, gc in grads["cpu"].items():
        gk = grads["card"][n]
        if gk is None or not bool(torch.isfinite(gk).all()):
            fail(f"card gradient of {n} is {'None' if gk is None else 'not finite'}")
        err = float((gk.cpu() - gc).abs().max())
        lim = 1e-3 * float(gc.abs().max()) + 1e-5 * top
        if not err <= lim:
            fail(f"card gradient of {n} differs from the CPU's by {err} "
                 f"(bound {lim})")
        rel = err / max(float(gc.abs().max()), 1e-30)
        if float(gc.abs().max()) > 1e-3 * top and rel > worst:
            worst, worst_name = rel, n
    print(f"[train] card vs CPU: loss rel diff "
          f"{abs(losses['card'] - losses['cpu']) / losses['cpu']:.3g}; "
          f"{len(grads['cpu'])} gradients all present and finite; worst "
          f"max |d| / max |g| {worst:.3g} ({worst_name}); K2 launches 4")
    del cpu, card, grads

    # (b) fit_ddpm on the card, 2 epochs x 100 steps
    model = build_model(32, dev, seed=0)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = dtrain.fit_ddpm(model, epochs=2, steps_per_epoch=100,
                              batch=64, res=32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_k2 = kernels.LAUNCHES["attention_qkv"]
    print(f"[train] fit_ddpm 2 x 100 steps, batch 64 at 32^2: losses "
          f"{[round(h['loss'], 5) for h in hist]}, {dt:.3f} s, "
          f"{200 / dt:.2f} steps/s (first steps included); K2 launches "
          f"{n_k2}")
    if not hist[1]["loss"] < hist[0]["loss"]:
        fail(f"epoch 2's loss {hist[1]['loss']} is not below epoch 1's "
             f"{hist[0]['loss']}")
    if n_k2 != 4 * 200:
        fail(f"K2 launched {n_k2} times in 200 steps, not 4 per step")


def train_full_width(dev) -> None:
    """Phase 6 (c): the 552.8M UNet, fp32 parameters, bf16 compute, 256^2,
    batch 4, three steps."""
    import torch

    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.models.diffusion import train as dtrain
    from pointdreamer_tpu_torch.models.diffusion.unet import (
        imagenet256_unet, init_random_)

    with torch.device("meta"):
        model = imagenet256_unet()
    model = init_random_(model.to_empty(device=dev), seed=0)
    model.set_compute_dtype(torch.bfloat16, keep_fp32_params=True).train()
    params = list(model.parameters())
    if sum(p.numel() for p in params) != 552_814_086 or \
            any(p.dtype != torch.float32 for p in params):
        fail("the full-width UNet is not 552,814,086 fp32 parameters")
    before = [p.detach().clone() for p in params]
    opt = dtrain.AdamCosine(params, 2e-4, 3, alpha=0.1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms, step_loss = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_loss.append(dtrain.train_epoch(model, opt, gen, 1, 4, 256))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    n_k2 = kernels.LAUNCHES["attention_qkv"]
    print(f"[train] 552.8M UNet, fp32 parameters, bf16 compute, batch 4 at "
          f"256^2: losses {[round(v, 5) for v in step_loss]}, ms per step "
          f"{[round(v, 1) for v in step_ms]}, peak memory "
          f"{peak / 2**30:.2f} GiB, K2 launches {n_k2}")
    if not all(math.isfinite(v) for v in step_loss):
        fail(f"full-width losses {step_loss}")
    if n_k2 != 16 * 3:
        fail(f"K2 launched {n_k2} times in 3 steps, not 16 per step")
    for (name, p), b in zip(model.named_parameters(), before):
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            fail(f"full-width gradient of {name} missing or not finite")
        if bool((p.detach() == b).all()):
            fail(f"full-width parameter {name} did not move")
    print(f"[train] all {len(params)} parameter tensors have finite "
          f"gradients and moved")


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
    check_tensor_cores(kernels.build())
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
              err=0.0, device_ms=0.0, sdpa_device_ms=0.0)
    for T, heads, per_fwd in ((1024, 8, 5), (256, 16, 5), (64, 16, 6)):
        B, C = 8, heads * 64
        qkv = torch.randn((B, T, 3 * C), generator=gen, device=dev,
                          dtype=torch.float32).to(torch.bfloat16)
        out = attention_qkv(qkv, heads)
        ref = attention_qkv_plain(qkv, heads)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        # the 2e-2 gate, and beside it one relative to the shape's outputs
        # (a few bf16 ulps of max |out|: |out| falls as T grows)
        rel = err / float(ref.float().abs().max())
        if not (err <= 2e-2 and rel <= 2e-2):
            fail(f"K2 T={T} heads={heads}: max abs err {err}, relative to "
                 f"max |out| {rel}")
        q, k, v = qkv.reshape(B, T, heads, 3, 64).permute(3, 0, 2, 1, 4)
        ms = cuda_ms(lambda: attention_qkv(qkv, heads))
        pms = cuda_ms(lambda: attention_qkv_plain(qkv, heads))
        lms = cuda_ms(lambda: F_.scaled_dot_product_attention(q, k, v))
        gms = graph_ms(lambda: attention_qkv(qkv, heads))
        glms = graph_ms(lambda: F_.scaled_dot_product_attention(q, k, v))
        by = B * T * 3 * C * 2 + B * T * C * 2
        ops = 4.0 * B * heads * T * T * 64
        b_ms, b_by = bound(by, ops, BF16_OPS_PER_S)
        print(f"[K2 attention_qkv] B={B} T={T} heads={heads} "
              f"max_abs_err={err:.3g} (rel {rel:.3g}) ms={ms:.4f} "
              f"plain_ms={pms:.4f} sdpa_ms={lms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}) "
              f"x{per_fwd} per UNet forward; device time (CUDA graph) "
              f"{gms:.4f}, sdpa {glms:.4f}")
        k2["device_ms"] += per_fwd * gms
        k2["sdpa_device_ms"] += per_fwd * glms
        k2["ms"] += per_fwd * ms
        k2["plain_ms"] += per_fwd * pms
        k2["library_ms"] += per_fwd * lms
        k2["bytes"] += per_fwd * by
        k2["ops"] += per_fwd * ops
        k2["err"] = max(k2["err"], err)
    k2_bound, k2_by = bound(k2["bytes"], k2["ops"], BF16_OPS_PER_S)
    print(f"[K2 attention_qkv] per UNet forward (16 launches): "
          f"ms={k2['ms']:.4f} plain_ms={k2['plain_ms']:.4f} "
          f"sdpa_ms={k2['library_ms']:.4f} bound_ms={k2_bound:.4f}; "
          f"device time (CUDA graph) {k2['device_ms']:.4f}, sdpa "
          f"{k2['sdpa_device_ms']:.4f}")
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
    print(f"[K3 segment_sum] the optimizer's tables: {int(fg.sum())} "
          f"active pixels")
    table.append(check_segsum(popt, contrib, cum_bounds, base, R,
                              "optimize tables"))

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
    cof_o, bbox_o = orast.prepare_views(ndc_o, depth_o, faces_t, rr, True)
    tests_o = pixel_box_tests(ndc_o, faces_t, bbox_o, rr)
    k4_opt_bound, k4_opt_by = bound(tri_o.numel() * 4 + V * rr * rr * 20,
                                    16.0 * tests_o, FP32_OPS_PER_S)
    print(f"[K4 raster_legacy] V={V} res={res} F={F} culled "
          f"pixel_box_tests={tests4} max_abs_err={k4_err:.3g} "
          f"ms={k4_ms:.4f} plain_ms={k4_plain:.3f} "
          f"bound_ms={k4_bound:.4f} ({k4_by}); optimize {rr}^2 "
          f"pixel_box_tests={tests_o} ms={k4_opt_ms:.4f} "
          f"bound_ms={k4_opt_bound:.4f} ({k4_opt_by})")
    # K1 at its other launch shapes: the optimizer's view maps (8 x 256^2,
    # culled; K1 there when the switch is off) and the atlas bake (1 x
    # 1024^2, every run)
    k1_err = max(k1_err, check_raster(orast, cof_o, bbox_o, rr, "optimize"))
    for what, (c_, b_, nd_, fa_, r_) in (
            ("optimize", (cof_o, bbox_o, ndc_o, faces_t, rr)),
            ("bake", (cof_b, bbox_b, (uv_t * 2.0 - 1.0)[None],
                      torch.as_tensor(fuv, device=dev), R))):
        t_ = pixel_box_tests(nd_, fa_, b_, r_)
        ms_ = cuda_ms(lambda: orast.rasterize_coefficients(c_, b_, r_))
        b_ms, b_by = bound(c_.shape[0] * c_.shape[1] * 16 * 4
                           + c_.shape[0] * r_ * r_ * 20, 16.0 * t_,
                           FP32_OPS_PER_S)
        print(f"[K1 raster_binned] {what}: V={c_.shape[0]} res={r_} "
              f"F={c_.shape[1]} pixel_box_tests={t_} ms={ms_:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})")
    table.append(dict(name="raster_legacy", route="cuda",
                      source="pointdreamer_tpu_torch/csrc/raster_legacy.cu",
                      replaces="pointdreamer_tpu/kernels/raster_pallas.py:310",
                      max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
                      bound_ms=k4_bound, bound_by=k4_by, library_ms=None))
    del proj, uv_map, fg, contrib, tri_k4, tri_o

    # K2 beyond the inference shapes, K5 and K6 (no caller on the main
    # paths: their launches there are 0)
    check_attention_training(dev, gen)
    table.append(check_groupnorm(dev, gen))
    table.append(check_winograd(dev, gen))
    torch.cuda.empty_cache()

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
    for t in table:
        if t["name"] != "raster_legacy":
            t["launches"] = launches[t["name"]]
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
                     "attention_qkv": 1600, "segment_sum": 100,
                     "groupnorm": 0, "winograd_conv3x3": 0}
    if launches != want_launches:
        fail(f"launches {launches}, not {want_launches}")
    for t in table:
        if t["name"] == "raster_legacy":
            t["launches"] = launches["raster_legacy"]
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
    del pipe, unet
    torch.cuda.empty_cache()

    # ---- 6. training -------------------------------------------------
    train_cli_model(dev)
    train_full_width(dev)

    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
