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
                1024^2 atlas bake), K4 legacy raster (8 x 512^2 culled
                and not, the optimizer's 8 x 256^2), both also on the
                binning's edge scene at 8 x 512^2 (big faces in the side
                lists); at each, the card's face bins against their CPU
                model as sets, and M, the list entries and side-list
                lengths; timed beside the bound through the wrapper, on
                the device (CUDA graph, which a host sync would break),
                and the binning and the tile kernel apart; K2
                attention (bf16, T/heads = 1024/8, 256/16, 64/16, batch
                8; then the training shapes:
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
                give; for K1-K5 also the device time of each launch and
                of the library call's from CUDA-graph replays (no host
                time).
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
  7. POCO     : the occupancy network (models/occupancy).  (a) Training at
                the reference width (hidden 64) with the training CLI's
                other defaults: one loss + backward on the card and on the
                CPU from the same weights and batch (losses agree, every
                gradient present and finite, each entry and each tensor's
                norm within 1e-3 of the CPU's plus four times the CPU's
                fp32 rounding, measured against its fp64 gradient, plus
                1e-6 of the largest gradient); the CUDA-graph step
                fit replays against the eager step (23 steps each, losses
                within 1e-6); then fit, batch 4 of 1,024 points and 512
                queries, lr 1e-3, 36 x 50 steps with cosine decay (the
                CLI's 6 x 50 leaves the network at the class prior): the
                last epoch's mean loss below the first's, validation OA
                above the all-outside prior, everything finite; ms per
                step (eager and captured) and peak memory.  (b)
                Pipeline.create(configs/default.yaml, device="cuda") with
                poco_checkpoint = (a)'s checkpoint and the seeded random
                552.8M UNet, one timed recon_one_textured_mesh of the
                cloud alone (build/smoke/in_ply/cube.ply, switch off),
                geometry warnings raised as errors (an SPR or hoppe
                fallback fails), after a warm-up of the geometry alone:
                8,000 to 10,000 faces, launches K1 >= 3, K2 = 1600, K3 =
                100, phase 4's output checks; the card's field at 4,096
                grid queries against the port's CPU field from the same
                checkpoint and draws (latents of the first cover pass):
                within 1e-4 on average, and within 1e-3 wherever both
                devices attend to the same 64 points (CUDA's and the CPU's
                topk break distance ties apart: >= 99% of the queries);
                the POCO sub-stage seconds, the unwrap thread's own wall
                and CPU time, and the mesh's distance to the cube beside
                phase 5's.  Then the same shape once more with the first
                run's mesh and unwrap cached (K2 = 1600): its inpaint
                without the host unwrap beside it.
  8. dataset  : the dataset runs and the evaluation stack at full width,
                on phase 4's Pipeline.  (a) render_mesh_dir of phase 5's
                exported mesh, 20 blender views at 512^2, switch off (K1)
                and on (K4): the kernel against its plain version at that
                shape (face ids equal at every pixel), its ms, device ms,
                bound and plain ms (kernel table rows *_render); one
                launch per render; the card's images against the port's
                CPU render of 2 of the views within 1e-5 where both chose
                the same face.  (b) Inception-v3 and VGG16 + LPIPS from
                torch.save'd seeded random weights through the loaders;
                ground truth: the cube's cached mesh coloured by the
                analytic field, 20 views; card against CPU (TF32 off):
                features within 1e-3 x max |f|, LPIPS within 1e-4 of the
                largest; FID, LPIPS, PSNR, SSIM and each network's ms.
                (c) run_dataset(default.yaml, render_after_inference,
                concurrency 2, pipe=) on the cloud alone, a 30,000-point
                sphere and a 30,001-point cloud: statuses exactly ok / ok
                / failed, 20 renders each, the cube's metrics against
                (b)'s ground truth, launches K1 = 8, K2 = 3200, K3 = 200;
                the same call again: cached, no launch; the two good
                clouds serially: the same faces, atlases within 40 dB
                PSNR; shapes/s and each shape's wall time and stage sum.
                (d) selfparity.run_roundtrip('cube') at its full defaults
                for the cloud's seeds 0-7: mean psnr_db >= 30 (one seed's
                score moves by +-1.3 dB with the draw).
  9. w8a8     : the w8a8 DDNM path (K7 quantize_act, K8 int8_conv;
                phase 1 also requires IMMA in K8's four instantiations).
                (a) K7 and K8 against their plain versions at the 552.8M
                UNet's shapes (3x3 256->256 at 8x256^2, 3x3 1024->1024 at
                8x16^2, a 1x1 768->512 skip at 8x64^2, the qkv dense
                512->1536 over 8x32^2 rows, a stride-2 3x3 at 2x64^2):
                K7's int8, ax and amax bit-equal, K8 within one bf16 ulp;
                ms through the wrapper and on the device, the bound
                (bytes at 3.35 TB/s or operations at 1979 TOPS int8), the
                plain versions', torch._int_mm's (after F.unfold for a
                conv) and bf16 F.conv2d's.  (b) configs/default.yaml with
                ddnm_quant_int8 (static scales) on phase 4's cached-mesh
                cube at full width: the first recon calibrates (K7 = K8 =
                2 x 136 x 100, K2 = 3200), the second is timed (136 x 100,
                K2 = 1600, K3 = 100, K1 >= 3); phase 4's output checks;
                its inpaint seconds beside phase 4's; its views against
                phase 4's (finite, known region >= 60 dB).  (c)
                cli/w8a8_fidelity on the flagship at 10 sampling steps:
                the int8 samplers' PSNR against bf16 on perturbed weights
                (finite, known region >= 60 dB; the rest recorded).
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
    """K2's bf16 instantiations, K6 and K8's four must hold tensor-core
    instructions (HMMA / HGMMA, for K8 the int8 IMMA, in `cuobjdump -sass`
    of the built library); print each count and the registers and spills
    `-Xptxas -v` gave them."""
    import re

    from pointdreamer_tpu_torch import kernels

    counts = kernels.sass_mma_counts(path)
    want = {f"K2 bf16 hd {hd}{' masked' if m else ''}":
            f"attn_mma_kernelILi{hd}ELb{m}E"
            for hd in (16, 32, 64) for m in (0, 1)}
    want["K6"] = "wino_mma_kernel"
    for bf, nchw in ((1, 1), (1, 0), (0, 1), (0, 0)):
        want[f"K8 {'bf16' if bf else 'fp32'} {'NCHW' if nchw else 'rows'}"] \
            = f"int8_conv_kernelILb{bf}ELb{nchw}E"
    with open(path + ".ptxas.txt") as f:
        ptxas = f.read()
    for what, key in want.items():
        found = [c for name, c in counts.items() if key in name]
        regs = re.search(re.escape(key) + r".*?Used (\d+) registers",
                         ptxas, re.S)
        spills = re.search(re.escape(key) + r".*?(\d+) bytes spill stores",
                           ptxas, re.S)
        print(f"[build] {what}: {found[0] if found else 0} tensor-core "
              f"instructions ({'IMMA' if what.startswith('K8') else 'HMMA'}"
              f"/GMMA), "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{spills.group(1) if spills else '?'} bytes spilled")
        if len(found) != 1 or found[0] == 0:
            fail(f"{what}: no tensor-core instructions in its SASS "
                 f"({found})")
    fp32 = [c for name, c in counts.items() if "attn_fma_kernel" in name]
    print(f"[build] K2 fp32 (CUDA-core FMAs): {len(fp32)} instantiations, "
          f"{sum(fp32)} tensor-core instructions")


def raster_fns(orast, route: str, args, res: int):
    """(wrapper, plain version, the binning alone, the tile kernel alone on
    given bins, the tile rectangles of the binning's CPU model) of K1
    (args = cof, bbox) or K4 (args = tri,)."""
    if route == "K1":
        cof, bbox = args
        return (lambda: orast.rasterize_coefficients(cof, bbox, res),
                lambda: orast.rasterize_coefficients_plain(cof, bbox, res),
                lambda: orast.bin_pixel_boxes(bbox, res),
                lambda b: orast.raster_binned_tiles(cof, bbox, b),
                orast.tile_rects(bbox, res))
    (tri,) = args
    return (lambda: orast.rasterize_legacy(tri, res),
            lambda: orast.rasterize_legacy_plain(tri, res),
            lambda: orast.bin_xy_boxes(tri, res),
            lambda b: orast.raster_legacy_tiles(tri, b),
            orast.legacy_tile_rects(tri, res))


def check_bins(orast, bins, rects, what: str):
    """The card's bins against bin_faces_plain's on the same tile
    rectangles: equal starts and side-list lengths (the counts spent), and
    every tile list and side list equal as a set (the card's order is its
    atomics').  Returns (list entries, side-list length of each view)."""
    import torch

    model = orast.bin_faces_plain(rects, bins.res)
    if not torch.equal(bins.work, model.work):
        fail(f"{what}: the card's counts, starts or side-list lengths "
             f"differ from bin_faces_plain's")
    V, F, T = bins.V, bins.F, bins.T
    n = int(model.starts[-1])
    tile = torch.repeat_interleave(
        torch.arange(V * T, device=rects.device),
        model.starts.diff().long(), output_size=n)
    key = tile * F
    if not torch.equal((key + bins.lists[:n]).sort().values,
                       key + model.lists[:n]):
        fail(f"{what}: a tile list differs from bin_faces_plain's")
    side_n = model.side_n.tolist()
    for v, k in enumerate(side_n):
        if not torch.equal(bins.side[v, :k].sort().values,
                           model.side[v, :k]):
            fail(f"{what}: view {v}'s side list differs from "
                 f"bin_faces_plain's")
    return n, side_n


def check_raster_shape(orast, route: str, args, res: int, what: str,
                       timed: bool = True) -> dict:
    """K1 or K4 against its plain version on the same input: face ids equal
    at every pixel (exact z ties included: both take the lexicographic
    minimum of (z, face id)), zbuf and barycentrics within 1e-5 where
    covered; the card's bins against their CPU model (check_bins); the
    tile kernel alone on those bins equal to the wrapper.  Timed: the
    wrapper's ms (CUDA events) and device ms (CUDA graph: the capture
    fails on a host sync), and the binning's and the tile kernel's
    apart."""
    import torch

    from pointdreamer_tpu_torch.ops.raster import BIN_MAX_TILES

    name = "K1 raster_binned" if route == "K1" else "K4 raster_legacy"
    wrapper, plain, binning, tiles, rects = raster_fns(orast, route, args,
                                                       res)
    got = wrapper()
    want = plain()
    torch.cuda.synchronize()
    n_diff = int((got.face_id != want.face_id).sum())
    if n_diff:
        fail(f"{name} ({what}) face ids differ at {n_diff} pixels")
    hit = got.face_id >= 0
    if not bool(hit.any()):
        fail(f"{name} ({what}) covered no pixel")
    err = max(float((got.zbuf[hit] - want.zbuf[hit]).abs().max()),
              float((got.bary[hit] - want.bary[hit]).abs().max()))
    if not err <= 1e-5:
        fail(f"{name} ({what}) zbuf/bary differ by {err}")
    bins = binning()
    pairs, side_n = check_bins(orast, bins, rects, f"{name} ({what})")
    alone = tiles(bins)
    if not all(torch.equal(a, b) for a, b in zip(alone, got)):
        fail(f"{name} ({what}) the tile kernel alone differs from the "
             f"wrapper")
    V, F = rects.shape[:2]
    row = dict(err=err, pairs=pairs, side_n=side_n)
    line = (f"[{name}] {what}: V={V} res={res} F={F} M={BIN_MAX_TILES} "
            f"list_entries={pairs} (capacity {V * F * BIN_MAX_TILES}) "
            f"side_list={side_n} covered={int(hit.sum())} "
            f"face_id_mismatches={n_diff} max_abs_err={err:.3g}")
    if timed:
        row.update(ms=cuda_ms(wrapper), device_ms=graph_ms(wrapper),
                   bin_ms=cuda_ms(binning), bin_device_ms=graph_ms(binning),
                   tile_ms=cuda_ms(lambda: tiles(bins)),
                   tile_device_ms=graph_ms(lambda: tiles(bins)))
        line += (f" ms={row['ms']:.4f} device_ms={row['device_ms']:.4f}; "
                 f"binning ms={row['bin_ms']:.4f} device_ms="
                 f"{row['bin_device_ms']:.4f}; tile kernel ms="
                 f"{row['tile_ms']:.4f} device_ms={row['tile_device_ms']:.4f}")
    print(line)
    return row


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


def mesh_vs_cube(v_np, f_np, xyz_n):
    """Each vertex's distance to the surface of the cloud's bounding box
    (the cube), and the share of faces whose normal points away from its
    centre."""
    import numpy as np

    lo, hi = xyz_n.min(0), xyz_n.max(0)
    d_out = np.maximum(np.maximum(lo - v_np, v_np - hi), 0.0)
    d_in = np.minimum(v_np - lo, hi - v_np).min(1)
    dist = np.where(d_out.max(1) > 0, np.linalg.norm(d_out, axis=1), d_in)
    tri = v_np[f_np]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outward = float(((nrm * (tri.mean(1) - (lo + hi) / 2)).sum(1) > 0)
                    .mean())
    return dist, outward


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


POCO_EPOCHS = 36


def train_poco(dev, work: str) -> str:
    """Phase 7 (a): POCO at hidden 64, card against CPU for one step, the
    captured step against the eager one, then fit; returns the
    checkpoint's path."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch.models.occupancy import train as otrain
    from pointdreamer_tpu_torch.models.occupancy.convert import init_params
    from pointdreamer_tpu_torch.models.occupancy.network import \
        network_from_tree
    from pointdreamer_tpu_torch.models.occupancy.synthetic import (
        batch_iterator, make_sample, random_shape)

    tree = init_params(seed=0, hidden=64)
    batch = next(batch_iterator(1, 4, 1024, 512, 0.005))
    losses, grads = {}, {}
    for name, d, dt in (("cpu", torch.device("cpu"), torch.float32),
                        ("cpu, fp64", torch.device("cpu"), torch.float64),
                        ("card", dev, torch.float32)):
        net = network_from_tree(tree, device=d).to(dt)
        t0 = time.perf_counter()
        loss, acc = otrain.loss_fn(net, *(
            torch.as_tensor(a, device=d).to(dt) if a.dtype.kind == "f"
            else torch.as_tensor(a, device=d) for a in batch))
        loss.backward()
        losses[name] = loss.item()
        print(f"[poco] hidden 64, batch 4 x 1024 points, 512 queries, one "
              f"loss + backward on the {name}: loss {losses[name]:.7f} in "
              f"{time.perf_counter() - t0:.3f} s (first call)")
        grads[name] = {n: p.grad for n, p in net.named_parameters()}
    if not abs(losses["card"] - losses["cpu"]) <= 1e-5 * losses["cpu"]:
        fail(f"POCO losses differ: card {losses['card']} cpu {losses['cpu']}")
    # every entry of every gradient, held relative to its own tensor:
    # |card - cpu| <= 1e-3 max |g| + 4 n + f, n the tensor's fp32 rounding
    # (the CPU's largest fp32 error against its fp64 gradient) and f 1e-6
    # of the largest gradient (n is one sample: a scalar's can be small by
    # chance); and each tensor whole, ||card - cpu|| <= 1e-3 ||g|| +
    # 4 ||cpu - fp64|| + f, so that a zeroed or doubled tensor fails
    # unless its norm is within that bound: a bias whose true gradient is
    # zero, one whose terms cancel (an instance-norm bias of the FKAConv at
    # the 47-point level), a scalar under f
    top = max(float(g.abs().max()) for g in grads["cpu"].values())
    n_entries = n_unchecked = 0
    worst, worst_name, worst_l2, worst_l2_name = 0.0, "", 0.0, ""
    rounding = []
    for n, gc in grads["cpu"].items():
        gk = grads["card"][n]
        if gk is None or not bool(torch.isfinite(gk).all()):
            fail(f"card POCO gradient of {n} is "
                 f"{'None' if gk is None else 'not finite'}")
        gc, gk = gc.double(), gk.double().cpu()
        err64 = gc - grads["cpu, fp64"][n]
        g_max = float(gc.abs().max())
        lim = 1e-3 * g_max + 4 * float(err64.abs().max()) + 1e-6 * top
        d = (gk - gc).abs()
        if not float(d.max()) <= lim:
            fail(f"card POCO gradient of {n} differs from the CPU's by "
                 f"{float(d.max())} (bound {lim}: its max |g| {g_max}, its "
                 f"fp32 rounding {float(err64.abs().max())}; "
                 f"{int((d > lim).sum())} entries over)")
        g_l2, n_l2 = float(gc.norm()), float(err64.norm())
        lim_l2 = 1e-3 * g_l2 + 4 * n_l2 + 1e-6 * top
        if not float(d.norm()) <= lim_l2:
            fail(f"card POCO gradient of {n} differs from the CPU's by "
                 f"{float(d.norm())} in norm (bound {lim_l2}: its norm "
                 f"{g_l2}, its fp32 rounding's {n_l2})")
        # entries the gate cannot tell from zero or from twice their value
        n_entries += gc.numel()
        n_unchecked += int((gc.abs() <= lim).sum())
        if g_l2 <= lim_l2:
            rounding.append(f"{n} (norm {g_l2 / top:.3g} of the largest "
                            f"gradient, its fp32 rounding's {n_l2 / top:.3g})")
            continue
        if float(d.max()) / lim > worst:
            worst, worst_name = float(d.max()) / lim, n
        if float(d.norm()) / lim_l2 > worst_l2:
            worst_l2, worst_l2_name = float(d.norm()) / lim_l2, n
    print(f"[poco] card vs CPU: loss rel diff "
          f"{abs(losses['card'] - losses['cpu']) / losses['cpu']:.3g}; "
          f"{len(grads['cpu'])} gradients all present and finite; every "
          f"entry within 1e-3 of its tensor's max |g| + 4 x the tensor's "
          f"fp32 rounding + 1e-6 of the largest gradient (worst max |d| / "
          f"bound {worst:.3g}, {worst_name}), "
          f"every tensor in norm (worst {worst_l2:.3g}, {worst_l2_name}); "
          f"{n_unchecked} of {n_entries} entries at most their bound in "
          f"size; tensors that the gate cannot tell from zero: {rounding}")
    del grads

    # the captured step (what fit replays on the card) against the eager
    # one: 23 steps each from the same weights on the same batches; ms per
    # step on resident batches
    it = batch_iterator(2, 4, 1024, 512, 0.005)
    bs = [[torch.as_tensor(a, device=dev) for a in next(it)]
          for _ in range(23)]
    runs = {}
    for name in ("eager", "captured"):
        net = network_from_tree(tree, device=dev)
        opt = otrain.AdamCosine(net.parameters(), 1e-3, 100)
        step = (otrain.CapturedStep(net, opt, *bs[0]) if name == "captured"
                else lambda *b, n=net, o=opt: otrain.train_step(n, o, *b))
        losses = [float(step(*b)[0]) for b in bs[:3]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bs[3:]:
            step(*b)
        torch.cuda.synchronize()
        runs[name] = (losses, (time.perf_counter() - t0) / 20 * 1e3,
                      [p.detach() for p in net.parameters()])
    d_loss = max(abs(a - b) / a for a, b in zip(runs["eager"][0],
                                                runs["captured"][0]))
    diffs = torch.cat([(a - b).abs().flatten() for a, b in
                       zip(runs["eager"][2], runs["captured"][2])])
    print(f"[poco] train_step on resident batches: eager "
          f"{runs['eager'][1]:.2f} ms, captured (CUDA graph) "
          f"{runs['captured'][1]:.2f} ms per step; after 23 steps each the "
          f"losses differ by {d_loss:.3g} (relative), the parameters by at "
          f"most {float(diffs.max()):.3g}, "
          f"{int((diffs > 1e-6).sum())} of {diffs.numel()} by more than 1e-6")
    if not (d_loss <= 1e-6 and float(diffs.max()) <= 2 * 1e-3 * 23
            and float((diffs > 1e-6).float().mean()) <= 5e-3):
        fail("the captured POCO step differs from the eager one")
    del runs, bs

    # fit, the training CLI's defaults at hidden 64 but for the length:
    # 36 x 50 steps (at its 6 x 50 the network stays at the class prior,
    # all outside, and the cube's field has no surface)
    ckpt = os.path.join(work, "poco_hidden64.pkl")
    net = network_from_tree(tree, device=dev)
    rng = np.random.default_rng(123)
    val = make_sample(random_shape(rng), rng, 1024, 512, 0.005)
    val = tuple(np.stack([v]) for v in val)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, hist = otrain.fit(net, batch_iterator(0, 4, 1024, 512, 0.005),
                         epochs=POCO_EPOCHS, steps_per_epoch=50, lr=1e-3,
                         checkpoint_path=ckpt, val_batch=val,
                         checkpoint_every=POCO_EPOCHS, lr_decay=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = POCO_EPOCHS * 50
    print(f"[poco] fit {POCO_EPOCHS} x 50 steps: losses "
          f"{[round(h['loss'], 4) for h in hist]}; validation OA "
          f"{[round(h['OA'], 3) for h in hist]}; {dt:.3f} s, "
          f"{dt / steps * 1e3:.2f} ms per step (host batches and validation "
          f"included), peak memory {peak / 2**30:.3f} GiB")
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"POCO losses {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        fail(f"POCO's last epoch loss {hist[-1]['loss']} is not below the "
             f"first's {hist[0]['loss']}")
    prior = float(1 - val[2].mean())        # OA of "all outside"
    if not hist[-1]["OA"] > prior + 0.05:
        fail(f"POCO's validation OA {hist[-1]['OA']} is not above the class "
             f"prior's {prior}")
    if not all(bool(torch.isfinite(p).all()) for p in net.parameters()):
        fail("POCO parameters not finite after fit")
    return ckpt


def poco_default_config(dev, ckpt: str, ply_alone: str, work: str,
                        spr_dist: float) -> None:
    """Phase 7 (b): configs/default.yaml whole, geometry from POCO."""
    import warnings

    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.log import StageTimer
    from pointdreamer_tpu_torch.models.occupancy import network as onet
    from pointdreamer_tpu_torch.models.occupancy.train import load_checkpoint
    from pointdreamer_tpu_torch.ops.knn import knn
    from pointdreamer_tpu_torch.pipeline.geometry import (GRID_HI, GRID_LO,
                                                          normalize_points,
                                                          reconstruct_mesh)
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    cfg.poco_checkpoint = ckpt
    cfg.output_path = os.path.join(work, "out_poco")
    pipe = Pipeline.create(cfg, device="cuda", allow_random_diffusion=True)
    if pipe.poco_apply is None:
        fail("Pipeline.create built no POCO field")
    n_params = sum(p.numel() for p in pipe.inpainter.model.parameters())
    if n_params != 552_814_086:
        fail(f"UNet has {n_params} parameters, not 552,814,086")
    # warm-up of the geometry alone: the first calls at the encode's and
    # the field's shapes (the texture path is warm from phases 4-5)
    xyz_a, _ = pio.read_ply_xyzrgb(ply_alone)
    xyz_n, _, _ = normalize_points(xyz_a)
    t0 = time.perf_counter()
    reconstruct_mesh(xyz_n, "POCO", cfg.grid_res, cfg.target_face_num,
                     poco_apply=pipe.poco_apply, device=dev)
    torch.cuda.synchronize()
    print(f"[poco] geometry warm-up {time.perf_counter() - t0:.3f} s")
    timer = StageTimer(None, sync=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with warnings.catch_warnings():
        # an SPR or hoppe fallback of the geometry stage fails the phase
        warnings.filterwarnings(
            "error", module=r"pointdreamer_tpu_torch\.pipeline\.geometry")
        t0 = time.perf_counter()
        obj = pipe.recon_one_textured_mesh(ply_alone, timer=timer)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stages = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"[poco] timed run {total:.3f} s stages {json.dumps(stages)}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print("[poco] geometry sub-stages (s): " + ", ".join(
        f"{k[9:]} {v:.4f}" for k, v in stages.items()
        if k.startswith("geometry.")))
    print(f"[poco] launches {json.dumps(launches)}")
    if launches["attention_qkv"] != 1600:
        fail(f"K2 launched {launches['attention_qkv']} times, not 1600")
    if launches["segment_sum"] != 100:
        fail(f"K3 launched {launches['segment_sum']} times, not 100")
    if launches["raster_binned"] < 3:
        fail(f"K1 launched {launches['raster_binned']} times, not >= 3")
    check_outputs(obj, cfg, "poco")

    geo = pio.load_obj(os.path.join(os.path.dirname(os.path.dirname(obj)),
                                    "geo", "untextured.obj"))
    v_np, f_np = geo["vertices"].astype(np.float32), geo["faces"]
    dist, outward = mesh_vs_cube(v_np, f_np, xyz_n)
    print(f"[poco] mesh {len(v_np)} vertices {len(f_np)} faces; distance to "
          f"the cube mean {dist.mean():.5f} p95 "
          f"{np.percentile(dist, 95):.5f} (phase 5's SPR mesh: mean "
          f"{spr_dist:.5f}); outward faces {outward:.5f}")
    if not 0.8 * cfg.target_face_num <= len(f_np) <= cfg.target_face_num:
        fail(f"{len(f_np)} faces, not within 0.8-1.0 x {cfg.target_face_num}")

    # the same shape again, in a fresh output directory that holds the
    # first run's geo/ (mesh and unwrap): geometry reads the mesh and the
    # unwrap thread its cache, so inpaint runs with no host unwrap beside
    # it, in the same process and state as the first run
    geo_dir = os.path.join(os.path.dirname(os.path.dirname(obj)), "geo")
    pipe.cfg.output_path = os.path.join(work, "out_poco_unwrapped")
    shutil.copytree(geo_dir, os.path.join(pipe.cfg.output_path,
                                          os.path.basename(os.path.dirname(
                                              geo_dir)), "geo"))
    timer_b = StageTimer(None, sync=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe.recon_one_textured_mesh(ply_alone, timer=timer_b)
    torch.cuda.synchronize()
    total_b = time.perf_counter() - t0
    if kernels.LAUNCHES["attention_qkv"] != 1600:
        fail(f"K2 launched {kernels.LAUNCHES['attention_qkv']} times in the "
             "run with the unwrap cached, not 1600")
    print(f"[poco] again with the mesh and its unwrap cached: {total_b:.3f} s,"
          f" inpaint {timer_b.times['inpaint']:.4f} s (first run "
          f"{stages['inpaint']:.4f} s, its unwrap thread "
          f"{stages.get('unwrap.thread', 0.0):.4f} s wall, "
          f"{stages.get('unwrap.thread_cpu', 0.0):.4f} s CPU)")

    # the card's field against the CPU's: the same checkpoint, the same
    # draws (make_poco_field's noise, then the first cover pass).  The two
    # devices compute the same fp32 distances, but CUDA's and the CPU's
    # topk break their ties (frequent: |q|^2 - 2 q.r + |r|^2 rounds at
    # |q|^2's scale) apart, so a query may attend to another 64-point set
    params = load_checkpoint(ckpt)["params"]
    axis = np.linspace(GRID_LO, GRID_HI, 16, dtype=np.float32)
    q = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                 -1).reshape(-1, 3)
    fields, sets = {}, {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        net = onet.network_from_tree(params, cfg.network_decoder, d)
        rng = np.random.default_rng(42)
        pts = xyz_n + rng.normal(0, 0.005, xyz_n.shape).astype(np.float32)
        pts = torch.as_tensor(pts, device=d)
        qt = torch.as_tensor(q, device=d)
        t0 = time.perf_counter()
        lat = onet.encode_latents(net, pts, cover=1, rng=rng)
        fields[name] = onet.query_occupancy(net, lat, pts, qt).cpu().numpy()
        sets[name] = np.sort(knn(qt, pts, 64)[1].cpu().numpy(), 1)
        print(f"[poco] field at {len(q)} grid queries on the {name} (first "
              f"cover pass, 10 subsets): {time.perf_counter() - t0:.3f} s, "
              f"{int((fields[name] < 0).sum())} inside")
    d_f = np.abs(fields["card"] - fields["cpu"])
    same = (sets["card"] == sets["cpu"]).all(1)
    worst = np.argsort(-d_f)[:4]
    print(f"[poco] card vs CPU field: mean |d| {d_f.mean():.3g} (bound "
          f"1e-4); {int(same.sum())} of {len(q)} queries with the same 64 "
          f"points (bound 99%), max |d| there {d_f[same].max():.3g} (bound "
          f"1e-3), elsewhere {d_f[~same].max(initial=0.0):.3g}; largest "
          f"|d| {[(round(float(d_f[i]), 6), bool(same[i])) for i in worst]}")
    if not (d_f.mean() <= 1e-4 and same.mean() >= 0.99
            and d_f[same].max() <= 1e-3):
        fail("the card's POCO field differs from the CPU's")
    del pipe


RENDER_CPU_VIEWS = (0, 10)   # the views the CPU also renders (~7-14 s each)


def render_phase(dev, obj: str, work: str, table: list) -> str:
    """Phase 8 (a): render_mesh_dir of phase 5's exported mesh, 20 blender
    views at 512^2, with the switch off (K1) and on (K4): the kernel
    against its plain version at that shape (face ids equal at every
    pixel), timed beside its bound; the entry point's launches; the card's
    images against the port's CPU render (RENDER_CPU_VIEWS) within 1e-5 on
    pixels whose face ids agree.  Returns the switch-off render dir."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.camera import make_camera_rig
    from pointdreamer_tpu_torch.eval import render as erender
    from pointdreamer_tpu_torch.kernels import FP32_OPS_PER_S
    from pointdreamer_tpu_torch.ops import raster as orast

    m = pio.load_obj(obj)
    atlas = pio.load_rgb(obj.replace(".obj", ".png"))[::-1].copy()
    res = 512
    out_dirs = {}
    for route, name, src, repl, switch in (
            ("K1", "raster_binned", "raster.cu", 143, None),
            ("K4", "raster_legacy", "raster_legacy.cu", 310, "1")):
        if switch:
            os.environ["PD_USE_PALLAS_RASTER"] = switch
        else:
            os.environ.pop("PD_USE_PALLAS_RASTER", None)
        on = {d: {k: torch.as_tensor(np.asarray(a), device=d)
                  for k, a in m.items()} for d in (dev, torch.device("cpu"))}
        at = {d: torch.as_tensor(atlas, device=d) for d in on}
        rig = make_camera_rig(20, res=res, distribution="blender", device=dev)
        ndc, depth = rig.transform(on[dev]["vertices"])
        faces = on[dev]["faces"]
        args = (orast.prepare_views(ndc, depth, faces, res, False)
                if route == "K1" else
                (orast.prepare_legacy(ndc, depth, faces, res, False),))
        row = check_raster_shape(orast, route, args, res, "render 20x512^2")
        bb = orast.prepare_views(ndc, depth, faces, res, False)[1]
        n_in = (args[0].shape[0] * args[0].shape[1]
                * (16 if route == "K1" else orast.LEGACY_WIDTH))
        tests = pixel_box_tests(ndc, faces, bb, res)
        b_ms, b_by = bound(n_in * 4 + 20 * res * res * 20, 16.0 * tests,
                           FP32_OPS_PER_S)
        plain = cuda_ms(raster_fns(orast, route, args, res)[1], reps=3,
                        warmup=1)
        del args, bb

        # the entry point, counted
        rdir = os.path.join(work, f"render_{route}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = erender.render_mesh_dir(obj, rdir, device="cuda")
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        want = {"raster_binned": 0, "raster_legacy": 0, "attention_qkv": 0,
                "segment_sum": 0, "groupnorm": 0, "winograd_conv3x3": 0,
                "quantize_act": 0, "int8_conv": 0}
        want[name] = 1
        if launches != want or len(paths) != 20:
            fail(f"render_mesh_dir ({route}): {len(paths)} views, launches "
                 f"{launches}, not {want}")

        # the card's images against the CPU's, on the views the CPU renders
        # too, where both rasterizers chose the same face
        imgs, fids = {}, {}
        orig = orast.rasterize_views
        for d in on:
            r_d = rig if d == dev else make_camera_rig(
                20, res=res, distribution="blender", device=d)
            if d != dev:
                r_d = r_d._replace(**{f: getattr(r_d, f)[list(
                    RENDER_CPU_VIEWS)] for f in ("eyes", "rot", "base_dirs",
                                                 "up_dirs")})

            def capture(*a, _d=d, **k):
                out = orig(*a, **k)
                fids[_d] = out.face_id
                return out

            orast.rasterize_views = capture
            try:
                t0 = time.perf_counter()
                imgs[d] = erender.render_textured_views(
                    r_d, on[d]["vertices"], on[d]["faces"], on[d]["uvs"],
                    on[d]["face_uv_idx"], at[d], res).cpu()
                if d == dev:
                    torch.cuda.synchronize()
                t_d = time.perf_counter() - t0
            finally:
                orast.rasterize_views = orig
            if d != dev:
                t_cpu = t_d
        sel = list(RENDER_CPU_VIEWS)
        card, cpu = imgs[dev][sel], imgs[torch.device("cpu")]
        same = (fids[dev][sel].cpu() == fids[torch.device("cpu")])
        err = float((card - cpu).abs().max(-1).values[same].max())
        n_diff = int((~same).sum())
        print(f"[render] {route} ({name}): render_mesh_dir 20 x {res}^2 in "
              f"{wall:.3f} s (PNG writes included), launches {launches}; "
              f"{len(m['faces'])} faces; K ms={row['ms']:.4f} device_ms="
              f"{row['device_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"plain_ms={plain:.3f}; card vs CPU on views {sel}: "
              f"{n_diff} of {same.numel()} pixels with other face ids "
              f"(depth ties), max |d| {err:.3g} elsewhere (bound 1e-5); the "
              f"CPU took {t_cpu:.2f} s for {len(sel)} views")
        if not err <= 1e-5 or n_diff > 1e-3 * same.numel():
            fail(f"render ({route}): card vs CPU {err}, {n_diff} pixels of "
                 f"other faces")
        table.append(dict(
            name=f"{name}_render", route="cuda",
            source=f"pointdreamer_tpu_torch/csrc/{src}",
            replaces=f"pointdreamer_tpu/kernels/raster_pallas.py:{repl}",
            launches=launches[name], max_abs_err=row["err"], ms=row["ms"],
            device_ms=row["device_ms"], plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        out_dirs[route] = rdir
        del on, at, imgs, fids, card, cpu
    os.environ.pop("PD_USE_PALLAS_RASTER", None)
    return out_dirs["K1"]


def perception_phase(dev, work: str, mesh_v, mesh_f, pred_dir: str) -> str:
    """Phase 8 (b): the perception networks on the card from torch.save'd
    random weights, against the CPU; ground-truth renders of the cube's
    cached mesh coloured by the analytic field.  Returns their dir."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import synthetic
    from pointdreamer_tpu_torch.camera import make_camera_rig
    from pointdreamer_tpu_torch.eval.render import render_vertex_color_views
    from pointdreamer_tpu_torch.eval.run_evaluation import \
        evaluate_image_dirs
    from pointdreamer_tpu_torch.models.perception import (
        convert, load_inception_features, load_lpips)

    paths = {}
    for name, sd in (("inception", convert.random_inception_state_dict(0)),
                     ("vgg16", convert.random_vgg16_state_dict(0)),
                     ("lpips_lin", convert.random_lpips_lin_state_dict(0))):
        paths[name] = os.path.join(work, f"{name}_random.pth")
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
                   paths[name])
    gt_dir = os.path.join(work, "gt_renders", "cube")
    rig = make_camera_rig(20, res=512, distribution="blender", device=dev)
    v = torch.as_tensor(mesh_v, device=dev)
    col = torch.as_tensor(synthetic.analytic_color(mesh_v).astype(
        np.float32), device=dev)
    gt = render_vertex_color_views(rig, v, torch.as_tensor(mesh_f,
                                                           device=dev), col)
    for i, img in enumerate(pio.to_uint8(gt)):
        pio.save_rgb(img, os.path.join(gt_dir, f"{i:03d}.png"))
    gt = torch.as_tensor(np.stack([pio.load_rgb(os.path.join(gt_dir, f))
                                   for f in sorted(os.listdir(gt_dir))]))
    pred = torch.as_tensor(np.stack([pio.load_rgb(os.path.join(pred_dir, f))
                                     for f in sorted(os.listdir(pred_dir))]))

    nets = {}
    for d in ("cuda", "cpu"):
        nets[d] = (load_inception_features(paths["inception"], device=d),
                   load_lpips(paths["vgg16"], paths["lpips_lin"], device=d))
    feats, dist = nets["cuda"]
    feats(gt[:2])                           # first calls: cuDNN set-up
    dist(gt[:2], pred[:2])
    times = {}
    for what, fn in (("inception", lambda: feats(gt)),
                     ("lpips", lambda: dist(pred, gt))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[what] = (time.perf_counter() - t0) * 1e3
        times[what + "_out"] = out
    f_card = times.pop("inception_out")
    d_card = times.pop("lpips_out")
    t0 = time.perf_counter()
    f_cpu = nets["cpu"][0](gt)
    sub = slice(0, 4)
    d_cpu = nets["cpu"][1](pred[sub], gt[sub])
    t_cpu = time.perf_counter() - t0
    f_err = float(np.abs(f_card - f_cpu).max()) / float(np.abs(f_cpu).max())
    d_err = float(np.abs(d_card[sub] - d_cpu).max()) / float(
        np.abs(d_cpu).max())
    t0 = time.perf_counter()
    m = evaluate_image_dirs(gt_dir, pred_dir, feature_fn=feats, lpips_fn=dist,
                            device="cuda")
    t_eval = time.perf_counter() - t0
    print(f"[perception] Inception over 20 images at 512^2 (resized to "
          f"299): {times['inception']:.2f} ms; LPIPS over 20 pairs at "
          f"512^2: {times['lpips']:.2f} ms (card, fp32, TF32 off); the CPU "
          f"took {t_cpu:.2f} s for 20 + 4 of them")
    print(f"[perception] card vs CPU: Inception max |d| / max |f| "
          f"{f_err:.3g} (bound 1e-3), LPIPS max |d| / max {d_err:.3g} on 4 "
          f"pairs (bound 1e-4)")
    print(f"[perception] phase 5's renders against the ground truth: "
          f"{json.dumps(m)} ({t_eval:.2f} s, FID's 2048^2 sqrtm on the host "
          f"included)")
    if not (f_err <= 1e-3 and d_err <= 1e-4):
        fail("the card's perception networks differ from the CPU's")
    if not all(math.isfinite(m[k]) for k in ("fid", "lpips", "psnr", "ssim")
               ) or m["n_images"] != 20:
        fail(f"evaluate_image_dirs gave {m}")
    return gt_dir


def dataset_phase(pipe, ply_alone: str, work: str, gt_dir: str,
                  table: list) -> None:
    """Phase 8 (c): run_dataset on phase 4's Pipeline, three clouds (one
    that must fail), concurrency 2; again (cached); the two good ones
    serially into a fresh directory (the same faces)."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.eval.selfparity import sphere_cloud
    from pointdreamer_tpu_torch.log import StageTimer
    from pointdreamer_tpu_torch.pipeline.batch import run_dataset

    src = os.path.join(work, "in_dataset")
    os.makedirs(src, exist_ok=True)
    shutil.copy(ply_alone, os.path.join(src, "cube.ply"))
    pts, col = sphere_cloud(30000)
    pio.save_colored_pc_ply(pts, col, os.path.join(src, "sphere.ply"))
    pts, col = sphere_cloud(30001, seed=1)      # over max_points: fails
    pio.save_colored_pc_ply(pts, col, os.path.join(src, "broken.ply"))
    files = [os.path.join(src, f"{n}.ply") for n in ("cube", "sphere",
                                                     "broken")]
    cfg = pipe.cfg
    cfg.render_after_inference = True

    # each shape's own wall time and stage sum (its StageTimer)
    recon = pipe.recon_one_textured_mesh
    shape_times = {}

    def timed(pc_file, name=None, timer=None):
        timer = StageTimer(None, sync=True)
        t0 = time.perf_counter()
        try:
            return recon(pc_file, name, timer=timer)
        finally:
            shape_times[name] = (time.perf_counter() - t0, timer.total())

    pipe.recon_one_textured_mesh = timed
    runs = {}
    try:
        for what, out, fs, conc in (
                ("concurrency 2", "out_dataset", files, 2),
                ("again", "out_dataset", files, 2),
                ("concurrency 1", "out_dataset_serial", files[:2], 1)):
            cfg.output_path = os.path.join(work, out)
            shape_times.clear()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_dataset(cfg, fs, gt_render_dirs={"cube": gt_dir},
                              concurrency=conc, pipe=pipe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            statuses = {n: r["status"] for n, r in res.items()}
            n_ok = sum(s == "ok" for s in statuses.values())
            print(f"[dataset] {what}: {wall:.3f} s, statuses {statuses}, "
                  f"{n_ok / wall:.4f} shapes/s; launches "
                  f"{json.dumps(launches)}")
            for n, (w, st) in sorted(shape_times.items()):
                print(f"[dataset] {what}: {n} recon wall {w:.3f} s, its stage "
                      f"sum {st:.3f} s")
            runs[what] = (cfg.output_path, res, launches)
    finally:
        del pipe.recon_one_textured_mesh
        cfg.render_after_inference = False

    out, res, launches = runs["concurrency 2"]
    want = {"cube": "ok", "sphere": "ok", "broken": "failed"}
    if {n: r["status"] for n, r in res.items()} != want:
        fail(f"run_dataset statuses {res}, not {want}")
    want_launches = {"raster_binned": 8, "raster_legacy": 0,
                     "attention_qkv": 3200, "segment_sum": 200,
                     "groupnorm": 0, "winograd_conv3x3": 0,
                     "quantize_act": 0, "int8_conv": 0}
    if launches != want_launches:
        fail(f"run_dataset launches {launches}, not {want_launches} (two "
             f"shapes: K1 3 + 1 render, K2 1600, K3 100 each)")
    for n in ("cube", "sphere"):
        if sorted(os.listdir(res[n]["renders"])) != \
                [f"{i:03d}.png" for i in range(20)]:
            fail(f"{n}: not 20 renders")
    mc = res["cube"].get("metrics", {})
    if mc.get("n_images") != 20 or not all(
            math.isfinite(mc.get(k, float("nan"))) for k in ("psnr", "ssim")):
        fail(f"cube metrics {mc}")
    if "metrics" in res["sphere"]:
        fail("the sphere has no ground truth, but metrics")
    print(f"[dataset] cube against its ground-truth renders: {json.dumps(mc)}")
    _, again, l_again = runs["again"]
    if {n: r["status"] for n, r in again.items()} != \
            {"cube": "cached", "sphere": "cached", "broken": "failed"} or \
            any(l_again.values()):
        fail(f"the second call: {again}, launches {l_again}")
    for t in table:
        if t["name"] == "raster_binned":
            t["launches_dataset"] = launches["raster_binned"]

    # the serial run against the concurrent one
    out1, res1, _ = runs["concurrency 1"]
    if {n: r["status"] for n, r in res1.items()} != \
            {"cube": "ok", "sphere": "ok"}:
        fail(f"the serial run: {res1}")
    for n in ("cube", "sphere"):
        a = pio.load_obj(res[n]["obj"])
        b = pio.load_obj(res1[n]["obj"])
        if a["faces"].shape != b["faces"].shape or \
                not (a["faces"] == b["faces"]).all():
            fail(f"{n}: the concurrent run's faces differ from the serial "
                 f"run's")
        img_a = pio.load_png(res[n]["obj"][:-4] + ".png").astype(np.int64)
        img_b = pio.load_png(res1[n]["obj"][:-4] + ".png").astype(np.int64)
        d = np.abs(img_a - img_b)
        mse = float((((img_a - img_b) / 255.0) ** 2).mean())
        psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
        print(f"[dataset] {n}: the concurrent and serial runs: same "
              f"{len(a['faces'])} faces, vertices max |d| "
              f"{float(np.abs(a['vertices'] - b['vertices']).max()):.3g}; "
              f"atlases: {int((d.max(-1) > 0).sum())} of {d.shape[0] * d.shape[1]} "
              f"texels differ, max {int(d.max())} / 255, PSNR {psnr:.2f} dB "
              f"(bound 40)")
        if not psnr >= 40.0:
            fail(f"{n}: the concurrent run's atlas is {psnr} dB from the "
                 f"serial run's")


SELFPARITY_SEEDS = 8


def selfparity_phase(work: str) -> None:
    """Phase 8 (d): the self-parity round trip at its full defaults, for
    the cloud's seeds 0..SELFPARITY_SEEDS-1.  The score is dominated by
    the reconstructed mesh at the cube's sharp edges, which moves with the
    cloud's draw by +-1.3 dB (the JAX package on the CPU: 30.04, 30.47,
    29.74 dB at seeds 0, 1, 2): the 30 dB gate holds their mean; seed 0,
    the run_roundtrip default, is printed beside it."""
    from pointdreamer_tpu_torch.eval.selfparity import run_roundtrip

    t0 = time.perf_counter()
    runs = [run_roundtrip(os.path.join(work, f"selfparity_{seed}"), "cube",
                          seed=seed, device="cuda")
            for seed in range(SELFPARITY_SEEDS)]
    psnr = [r["psnr_db"] for r in runs]
    mean = sum(psnr) / len(psnr)
    print(f"[selfparity] cube, nearest fill, SPR 128^3, 8 x 512^2, 1024^2 "
          f"atlas, seeds 0-{SELFPARITY_SEEDS - 1}: psnr_db "
          f"{[round(p, 4) for p in psnr]}, mean {mean:.4f} (gate >= 30.0); "
          f"seed 0 (the default) {psnr[0]:.4f} dB, mean_abs_err "
          f"{runs[0]['mean_abs_err']:.6f}, {runs[0]['n_faces']} faces; "
          f"{time.perf_counter() - t0:.2f} s")
    if not mean >= 30.0:
        fail(f"self-parity: mean {mean} dB over {SELFPARITY_SEEDS} seeds < 30")


# K8's shapes in phase 9 (a): (what, B, Cin, H, W, Cout, k, stride, rows);
# the first four are the 552.8M UNet's own (its largest 3x3, its 1024-wide
# 3x3 at 16^2, an output block's 1x1 skip, the qkv of an attention block
# at 32^2), the last the stride-2 path at a small shape
K8_SHAPES = (
    ("3x3 256->256 at 8x256^2", 8, 256, 256, 256, 256, 3, 1, False),
    ("3x3 1024->1024 at 8x16^2", 8, 1024, 16, 16, 1024, 3, 1, False),
    ("1x1 skip 768->512 at 8x64^2", 8, 768, 64, 64, 512, 1, 1, False),
    ("dense qkv 512->1536 over 8x32^2 rows", 8, 512, 1024, 1, 1536, 1, 1,
     True),
    ("3x3 stride 2 256->256 at 2x64^2", 2, 256, 64, 64, 256, 3, 2, False),
)


def check_quant(dev, gen) -> list:
    """Phase 9 (a): K7 and K8 against their plain versions at K8_SHAPES
    (bf16 activations): K7's int8 output, ax and the amax it records bit
    for bit, also with a static amax from a scale table, and channels last
    at the attention's proj shape; K8 within one bf16 ulp at every
    element, also from those rows to NCHW.  Prints for each
    shape the wrapper's and the device (CUDA graph) ms of both, their
    bounds, the plain versions' ms, the library's int8 product
    (torch._int_mm; for a conv after F.unfold) and bf16 F.conv2d
    (channels last).  Returns the two kernel-table rows, times and bounds
    summed over the shapes."""
    import torch
    import torch.nn.functional as F_

    from pointdreamer_tpu_torch.kernels import INT8_OPS_PER_S
    from pointdreamer_tpu_torch.kernels import quant as kq

    rows = {n: dict(name=n, route="cuda",
                    source="pointdreamer_tpu_torch/csrc/quant.cu",
                    replaces=f"pointdreamer_tpu/models/diffusion/unet.py:"
                             f"{line}",
                    max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                    library_ms=0.0, bytes=0.0, ops=0.0)
            for n, line in (("quantize_act", 92), ("int8_conv", 95))}

    def k7_same(what, x, channels_last, static):
        q, ax = kq.quantize_act(x, channels_last, static)
        q_p, ax_p = kq.quantize_act_plain(x, channels_last, static)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_p) and torch.equal(ax, ax_p)):
            fail(f"K7 {what}: {int((q != q_p).sum())} int8 entries, ax "
                 f"{float(ax)} vs {float(ax_p)}")
        return q, ax

    for what, B, Cin, H, W, N, k, s, as_rows in K8_SHAPES:
        pad = 1 if k == 3 else 0
        x = (torch.randn((B, Cin, H, W), generator=gen, device=dev) * 1.7
             + 0.2).to(torch.bfloat16)
        slot = torch.zeros(2, device=dev)
        q, ax = kq.quantize_act(x, calib_out=slot[1:2])
        q_p, ax_p = kq.quantize_act_plain(x)
        amax_p = x.float().abs().amax()
        torch.cuda.synchronize()
        if not (torch.equal(q, q_p) and torch.equal(ax, ax_p)
                and bool(slot[1] == amax_p) and bool(slot[0] == 0)):
            fail(f"K7 {what}: {int((q != q_p).sum())} int8 entries, ax "
                 f"{float(ax)} vs {float(ax_p)}, amax {float(slot[1])} vs "
                 f"{float(amax_p)}")
        # static scales, as the recon runs K7: a one-element view into a
        # [sites, steps] table, below max |x| (entries saturate)
        table = torch.zeros((3, 4), device=dev)
        table[1, 2] = amax_p * 0.7
        k7_same(f"{what}, static", x, False, table[1, 2:3])
        xq = q.view(B, H, W, Cin)
        wq = torch.randint(-127, 128, (N, k * k * Cin), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(N, generator=gen, device=dev) * 2e-3 + 1e-4
        bias = torch.randn(N, generator=gen, device=dev) * 0.1
        args = (xq, wq, ax, ks, bias, k, k, s, pad, torch.bfloat16, as_rows)
        y = kq.int8_conv(*args)
        y_p = kq.int8_conv_plain(*args).float()
        torch.cuda.synchronize()
        err = (y.float() - y_p).abs()
        ulps = float((err / bf16_ulp(y_p)).max())
        if not ulps <= 1.0:
            fail(f"K8 {what}: {ulps} bf16 ulps from its plain version")
        # times: the wrapper (host included) and the device (CUDA graph)
        ms7 = cuda_ms(lambda: kq.quantize_act(x))
        gms7 = graph_ms(lambda: kq.quantize_act(x))
        pms7 = cuda_ms(lambda: kq.quantize_act_plain(x), reps=3, warmup=1)
        ms8 = cuda_ms(lambda: kq.int8_conv(*args))
        gms8 = graph_ms(lambda: kq.int8_conv(*args))
        pms8 = cuda_ms(lambda: kq.int8_conv_plain(*args), reps=3, warmup=1)
        # the library: the int8 product of torch._int_mm, after F.unfold
        # (im2col, as bf16: unfold takes no int8) for a conv; bf16 F.conv2d
        w_col = wq.view(N, k, k, Cin).permute(0, 3, 1, 2).reshape(N, -1)
        if k == 1:
            a2 = xq.reshape(-1, Cin)
            lib = lambda: torch._int_mm(a2, wq.t())  # noqa: E731
        else:
            xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)

            def lib():
                cols = F_.unfold(xb, k, padding=pad, stride=s)
                return torch._int_mm(
                    cols.transpose(1, 2).reshape(-1, k * k * Cin)
                    .to(torch.int8), w_col.t())
        acc_lib = lib()
        acc_p = kq.int8_conv_acc_plain(xq, wq, k, k, s, pad)
        lib_same = torch.equal(acc_lib.view(acc_p.shape), acc_p)
        del acc_lib, acc_p
        lms = cuda_ms(lib, reps=5, warmup=1)
        xc = x.contiguous(memory_format=torch.channels_last)
        wb = torch.randn((N, Cin, k, k), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cms = cuda_ms(lambda: F_.conv2d(xc, wb, None, s, pad))
        # bounds: K7 reads x once and writes int8; K8 reads xq and wq once
        # and writes bf16, and does 2 M N K int8 operations
        n_x = x.numel()
        M = y.numel() // N
        b7 = n_x * 2 + n_x
        b8 = xq.numel() + wq.numel() + M * N * 2
        o8 = 2.0 * M * N * k * k * Cin
        bm7, by7 = bound(b7, n_x * 4.0, INT8_OPS_PER_S)
        bm8, by8 = bound(b8, o8, INT8_OPS_PER_S)
        print(f"[K7 quantize_act] {what}: x {list(x.shape)} bf16, bit-equal "
              f"(int8, ax, amax); ms={ms7:.4f} device_ms={gms7:.4f} "
              f"plain_ms={pms7:.4f} bound_ms={bm7:.4f} ({by7}; device time "
              f"{bm7 / gms7:.0%} of it)")
        print(f"[K8 int8_conv] {what}: M={M} N={N} K={k * k * Cin} "
              f"max_abs_err={float(err.max()):.3g} ({ulps:.3g} bf16 ulp) "
              f"ms={ms8:.4f} device_ms={gms8:.4f} plain_ms={pms8:.4f} "
              f"int_mm_ms={lms:.4f} (int32 equal {lib_same}) "
              f"bf16_conv2d_ms={cms:.4f} bound_ms={bm8:.4f} ({by8}; device "
              f"time {bm8 / gms8:.0%} of it, "
              f"{o8 / gms8 / 1e9:.0f} TOP/s)")
        for n, ms, gms, pms, lm, by, op, e in (
                ("quantize_act", ms7, gms7, pms7, 0.0, b7, n_x * 4.0, 0.0),
                ("int8_conv", ms8, gms8, pms8, lms, b8, o8,
                 float(err.max()))):
            r = rows[n]
            r["ms"] += ms
            r["device_ms"] += gms
            r["plain_ms"] += pms
            r["library_ms"] += lm
            r["bytes"] += by
            r["ops"] += op
            r["max_abs_err"] = max(r["max_abs_err"], e)
        del x, q, q_p, xq, wq, y, y_p, err, xc, wb
        torch.cuda.empty_cache()
    # the attention's proj: K7 channels last (the [b, t, c] K2 writes),
    # dynamic and static, and K8 from those rows back to NCHW
    B, T, C = 8, 1024, 512
    x = (torch.randn((B, T, C), generator=gen, device=dev) * 1.7
         + 0.2).to(torch.bfloat16)
    table = torch.zeros((3, 4), device=dev)
    table[2, 1] = x.float().abs().amax() * 0.7
    k7_same("proj 512->512 rows, static", x, True, table[2, 1:2])
    q, ax = k7_same("proj 512->512 rows", x, True, None)
    wq = torch.randint(-127, 128, (C, C), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(C, generator=gen, device=dev) * 2e-3 + 1e-4
    bias = torch.randn(C, generator=gen, device=dev) * 0.1
    args = (q.view(B, T, 1, C), wq, ax, ks, bias, 1, 1, 1, 0,
            torch.bfloat16, False)
    y = kq.int8_conv(*args)
    y_p = kq.int8_conv_plain(*args).float()
    ulps = float(((y.float() - y_p).abs() / bf16_ulp(y_p)).max())
    print(f"[K7 quantize_act] proj 512->512 over 8x32^2 rows (channels "
          f"last): bit-equal, dynamic and static; [K8 int8_conv] to NCHW "
          f"{list(y.shape)}: {ulps:.3g} bf16 ulp")
    if not ulps <= 1.0:
        fail(f"K8 proj 512->512 to NCHW: {ulps} bf16 ulps from its plain "
             f"version")
    del x, q, wq, y, y_p
    out = []
    for n, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("ops"),
                                             INT8_OPS_PER_S)
        if n == "quantize_act":
            r["library_ms"] = None
        print(f"[{'K7' if n == 'quantize_act' else 'K8'} {n}] "
              f"{len(K8_SHAPES)} shapes: ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.4f}")
        out.append(r)
    return out


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def w8a8_recon(ply: str, work: str, cfg_path: str, bf16_out: str,
               bf16_inpaint: float, table: list) -> None:
    """Phase 9 (b): configs/default.yaml with ddnm_quant_int8 (static
    scales) on the cached-mesh cube: Pipeline.create builds the w8a8
    552.8M UNet, the first recon calibrates (two samplers: K7 and K8 at
    2 x 136 x 100, K2 3200), the second is timed (136 x 100, K2 1600);
    phase 4's output checks; inpaint seconds beside phase 4's bf16 ones;
    the inpainted views against phase 4's (the same sparse views and
    draws)."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.log import StageTimer
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    cfg = load_config(cfg_path)
    cfg.ddnm_quant_int8, cfg.ddnm_quant_static = True, True
    cfg.output_path = os.path.join(work, "out_w8a8_calib")
    t0 = time.perf_counter()
    pipe = Pipeline.create(cfg, device="cuda", allow_random_diffusion=True)
    unet = pipe.inpainter.model
    n_sites = unet.n_sites
    n_int8 = sum(p.numel() for p in unet.parameters()
                 if p.dtype == torch.int8)
    print(f"[w8a8] UNet w8a8: {n_sites} sites, {n_int8} int8 weights, "
          f"built in {time.perf_counter() - t0:.2f} s")
    if n_sites != 136 or n_int8 != 498_204_672 \
            or not pipe.inpainter.static_calib:
        fail(f"w8a8 UNet: {n_sites} sites, {n_int8} int8 weights, static "
             f"{pipe.inpainter.static_calib}")
    steps = pipe.inpainter.t_sampling
    runs = {}
    for what, out in (("calibrating", "out_w8a8_calib"),
                      ("timed", "out_w8a8")):
        cfg.output_path = os.path.join(work, out)
        timer = StageTimer(None, sync=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        obj = pipe.recon_one_textured_mesh(ply, timer=timer)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stages = {k: round(v, 4) for k, v in timer.times.items()}
        print(f"[w8a8] {what} run {total:.3f} s stages {json.dumps(stages)}")
        print(f"[w8a8] {what} launches {json.dumps(launches)}")
        n = 2 if what == "calibrating" else 1
        want = {"quantize_act": n * n_sites * steps,
                "int8_conv": n * n_sites * steps,
                "attention_qkv": n * 1600, "segment_sum": 100,
                "raster_legacy": 0, "groupnorm": 0, "winograd_conv3x3": 0}
        got = {k: launches[k] for k in want}
        if got != want or launches["raster_binned"] < 3:
            fail(f"w8a8 {what} launches {launches}, not {want} and K1 >= 3")
        check_outputs(obj, cfg, f"w8a8 {what}")
        runs[what] = (obj, stages, launches)
    scales = pipe.inpainter.act_scales
    print(f"[w8a8] static scales {tuple(scales.shape)}: finite "
          f"{bool(torch.isfinite(scales).all())}, min {float(scales.min()):.4g}"
          f" max {float(scales.max()):.4g}")
    obj, stages, launches = runs["timed"]
    for t in table:
        if t["name"] in ("quantize_act", "int8_conv"):
            t["launches"] = launches[t["name"]]
    print(f"[w8a8] inpaint {stages['inpaint']:.4f} s (w8a8, static "
          f"scales) against {bf16_inpaint:.4f} s (bf16, phase 4), "
          f"x{stages['inpaint'] / bf16_inpaint:.3f}; calibrating call "
          f"{runs['calibrating'][1]['inpaint']:.4f} s")
    # the same sparse views and draws as phase 4's bf16 sampler
    others = os.path.join(os.path.dirname(os.path.dirname(obj)), "others")
    q, b, known = [], [], []
    for i in range(cfg.view_num):
        q.append(pio.load_rgb(os.path.join(others, f"{i}_inpainted.png")))
        b.append(pio.load_rgb(os.path.join(bf16_out, f"{i}_inpainted.png")))
        sp = pio.load_rgb(os.path.join(others, f"{i}_sparse.png"))
        known.append(np.broadcast_to((sp.max(-1) > 0)[..., None], sp.shape))
    q, b, known = np.stack(q), np.stack(b), np.stack(known)
    full, kn = _psnr(q, b), _psnr(q[known], b[known])
    print(f"[w8a8] static int8 sampler against the bf16 one (phase 4, same "
          f"draws), 8-bit views: PSNR {full:.2f} dB, known region "
          f"{kn:.2f} dB (gate >= 60); the random init zeroes the final conv, "
          f"so eps is 0 in both and the views agree: (c) measures the "
          f"int8 error on perturbed weights")
    if not (np.isfinite(q).all() and kn >= 60.0):
        fail(f"w8a8 views: finite {np.isfinite(q).all()}, known-region "
             f"PSNR {kn}")
    del pipe, unet


def w8a8_fidelity_phase(work: str, t_sampling: int = 10) -> None:
    """Phase 9 (c): cli/w8a8_fidelity on the flagship at `t_sampling`
    steps (the synthetic cube's views; static scales calibrated on the
    sphere's): PSNR and correlation of the int8 samplers against the bf16
    one on the same draws.  Gates: finite outputs, known region >= 60 dB;
    the full-image numbers are recorded."""
    from pointdreamer_tpu_torch.cli import w8a8_fidelity

    res = w8a8_fidelity.main([
        "--device", "cuda", "--t_sampling", str(t_sampling),
        "--cache_dir", os.path.join(work, "w8a8_fidelity"),
        "--out", os.path.join(work, "w8a8_fidelity", "fidelity.json")])
    for leg in ("int8_dynamic", "int8_static"):
        r = res[leg]
        print(f"[w8a8 fidelity] {leg}: PSNR vs bf16 {r['psnr_vs_bf16']} dB, "
              f"known region {r['psnr_known_region']} dB, corr {r['corr']}, "
              f"per view {r['per_view_psnr']}")
        if not (r["finite"] and r["psnr_known_region"] >= 60.0):
            fail(f"w8a8 fidelity {leg}: {r}")
    print(f"[w8a8 fidelity] static vs dynamic {res['int8_static']['psnr_vs_dynamic']} "
          f"dB; sampler seconds {json.dumps(res['sampler_seconds'])} at "
          f"{t_sampling} steps; JAX tiny-model gates (28 dB, corr 0.99) "
          f"{res['gates_pass']}; {res['wall_sec']} s")


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

    # K1 and K4 at the main paths' launch shapes.  project: 8 views x 512^2
    # (K1 without culling on the cached mesh; K4 culled, as project does on
    # the port's own reconstruction, and also without); optimize: the view
    # maps at 8 x 256^2, culled; bake (K1 only): one 1024^2 view of the uv
    # layout, depth 1 everywhere, so every overlap is an exact z tie
    ndc, depth = rig.transform(verts_t)
    lo, hi = ndc.amin(1, keepdim=True), ndc.amax(1, keepdim=True)
    ndc = (ndc - (lo + hi) / 2) / (hi - lo).amax(2, keepdim=True) \
        * (1 - 2 * cfg.crop_padding) * 2.0
    res = cfg.cam_res
    R = cfg.xatlas_texture_res
    rr = cfg.optimize_render_res
    uvs, fuv = punwrap.unwrap(verts, faces, atlas_res=R)
    uv_ndc = (torch.as_tensor(uvs, device=dev) * 2.0 - 1.0)[None]
    fuv_t = torch.as_tensor(fuv, device=dev)
    proj = pproject.project_views(rig, verts_t, faces_t,
                                  torch.as_tensor(xyz_n, device=dev),
                                  padding=cfg.crop_padding,
                                  cull_backface=False)
    ndc_o, depth_o = rig.transform(verts_t)
    ndc_o = ((ndc_o - proj.uv_centers) / proj.uv_scales
             * (1.0 - 2.0 * proj.padding) + 0.5).clamp(0.0, 1.0) * 2.0 - 1.0
    shapes = {   # (route, what): (input, res, ndc and faces of the bound)
        ("K1", "project"): (orast.prepare_views(ndc, depth, faces_t, res,
                                                False), res, ndc, faces_t),
        ("K1", "optimize"): (orast.prepare_views(ndc_o, depth_o, faces_t, rr,
                                                 True), rr, ndc_o, faces_t),
        ("K1", "bake"): (orast.prepare_views(
            uv_ndc, torch.ones(uv_ndc.shape[:2], device=dev), fuv_t, R,
            False), R, uv_ndc, fuv_t),
        ("K4", "project, culled"): ((orast.prepare_legacy(
            ndc, depth, faces_t, res, True),), res, ndc, faces_t),
        ("K4", "optimize"): ((orast.prepare_legacy(
            ndc_o, depth_o, faces_t, rr, True),), rr, ndc_o, faces_t),
    }
    rows = {}
    for (route, what), (args, r_, nd_, fa_) in shapes.items():
        row = check_raster_shape(orast, route, args, r_, what)
        # the least time: bytes, the inputs once (K1 12 coefficients and a
        # 4-int pixel box a face, K4 its 13 floats) and 20 B a pixel out;
        # operations, 16 per (pixel, face) test of each face's own xy box
        # that can show (three edge functions and z)
        b_ = args[1] if route == "K1" else orast.prepare_views(
            nd_, torch.ones(nd_.shape[:2], device=dev), fa_, r_, True)[1]
        n_in = (args[0].shape[0] * args[0].shape[1]
                * (16 if route == "K1" else orast.LEGACY_WIDTH))
        row["tests"] = pixel_box_tests(nd_, fa_, b_, r_)
        row["bound_ms"], row["bound_by"] = bound(
            n_in * 4 + args[0].shape[0] * r_ * r_ * 20, 16.0 * row["tests"],
            FP32_OPS_PER_S)
        print(f"[{route}] {what}: pixel_box_tests={row['tests']} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}); device "
              f"time {row['bound_ms'] / row['device_ms']:.1%} of it")
        rows[route, what] = row
    # checked only: K4 without culling, and the binning's edge scene at 8 x
    # 512^2 (2,000 small faces a view, big faces past M tiles and a
    # screen-filling quad in the side lists, a zero-area sliver, a NaN
    # corner, an empty last view)
    k4_errs = [check_raster_shape(
        orast, "K4", (orast.prepare_legacy(ndc, depth, faces_t, res,
                                           False),),
        res, "project, no culling", timed=False)["err"]]
    e_ndc, e_depth, e_faces = (torch.as_tensor(a, device=dev) for a in
                               synthetic.raster_edge_scene(8, res, 2000))
    k1_errs = [check_raster_shape(
        orast, "K1", orast.prepare_views(e_ndc, e_depth, e_faces, res, False),
        res, "edge scene", timed=False)["err"]]
    for cull in (False, True):
        k4_errs.append(check_raster_shape(
            orast, "K4", (orast.prepare_legacy(e_ndc, e_depth, e_faces, res,
                                               cull),),
            res, f"edge scene, {'culled' if cull else 'no culling'}",
            timed=False)["err"])
    # the plain versions' time at the project shapes
    plain_ms = {route: cuda_ms(raster_fns(orast, route, shapes[route, what][0],
                                          res)[1], reps=3, warmup=1)
                for route, what in (("K1", "project"),
                                    ("K4", "project, culled"))}
    for route, name, src, repl, head in (
            ("K1", "raster_binned", "raster.cu", 143, "project"),
            ("K4", "raster_legacy", "raster_legacy.cu", 310,
             "project, culled")):
        mine = {w: r_ for (rt, w), r_ in rows.items() if rt == route}
        print(f"[{route}] " + "; ".join(
            f"{w}: ms={r_['ms']:.4f} device_ms={r_['device_ms']:.4f} "
            f"bound_ms={r_['bound_ms']:.4f}" for w, r_ in mine.items())
            + f"; plain_ms ({head}) {plain_ms[route]:.3f}")
        errs = k1_errs if route == "K1" else k4_errs
        table.append(dict(
            name=name, route="cuda",
            source=f"pointdreamer_tpu_torch/csrc/{src}",
            replaces=f"pointdreamer_tpu/kernels/raster_pallas.py:{repl}",
            max_abs_err=max(errs + [r_["err"] for r_ in mine.values()]),
            ms=mine[head]["ms"], device_ms=mine[head]["device_ms"],
            plain_ms=plain_ms[route], bound_ms=mine[head]["bound_ms"],
            bound_by=mine[head]["bound_by"], library_ms=None))
    del shapes, e_ndc, e_depth, e_faces

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

    del proj, uv_map, fg, contrib

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
    bf16_inpaint = timer.times["inpaint"]
    bf16_views = os.path.join(os.path.dirname(os.path.dirname(obj)),
                              "others")

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
                     "groupnorm": 0, "winograd_conv3x3": 0,
                     "quantize_act": 0, "int8_conv": 0}
    if launches != want_launches:
        fail(f"launches {launches}, not {want_launches}")
    for t in table:
        if t["name"] == "raster_legacy":
            t["launches"] = launches["raster_legacy"]
    check_outputs(obj, cfg, "geometry")
    obj5 = obj

    # the reconstructed mesh (normalized frame), against the cube
    geo = pio.load_obj(os.path.join(os.path.dirname(os.path.dirname(obj)),
                                    "geo", "untextured.obj"))
    v_np, f_np = geo["vertices"].astype(np.float32), geo["faces"]
    nf = len(f_np)
    xyz_a, _ = pio.read_ply_xyzrgb(ply_alone)
    xyz_n, _, _ = normalize_points(xyz_a)
    dist, outward = mesh_vs_cube(v_np, f_np, xyz_n)
    spr_dist = float(dist.mean())
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
    del unet
    torch.cuda.empty_cache()

    # ---- 6. training -------------------------------------------------
    train_cli_model(dev)
    train_full_width(dev)
    torch.cuda.empty_cache()

    # ---- 7. POCO: training, then default.yaml from the cloud alone ----
    ckpt = train_poco(dev, work)
    poco_default_config(dev, ckpt, ply_alone, work, spr_dist)
    torch.cuda.empty_cache()

    # ---- 8. dataset runs and evaluation --------------------------------
    pred_dir = render_phase(dev, obj5, work, table)
    gt_dir = perception_phase(dev, work, verts, faces, pred_dir)
    dataset_phase(pipe, ply_alone, work, gt_dir, table)
    del pipe
    torch.cuda.empty_cache()
    selfparity_phase(work)

    # ---- 9. w8a8 DDNM: K7 and K8, the recon, the fidelity --------------
    table.extend(check_quant(dev, gen))
    torch.cuda.empty_cache()
    w8a8_recon(ply, work, os.path.join(REPO, "configs", "default.yaml"),
               bf16_views, bf16_inpaint, table)
    torch.cuda.empty_cache()
    w8a8_fidelity_phase(work)

    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
