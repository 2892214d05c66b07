"""Smoke run of the PyTorch port on one NVIDIA GPU (H100 / sm_90a).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build    : compile the port's CUDA kernels (csrc/*.cu, one nvcc per
                source in parallel, -Xptxas -v kept beside the library) and
                the host hull and QEM libraries; count the tensor-core
                instructions (HMMA/HGMMA, `cuobjdump -sass`) of K2's
                six bf16 instantiations and of K6, and the IGMMA of K8's
                four, and fail if any has none;
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
                phase 1 also requires the warpgroup product IGMMA in K8's
                four instantiations).
                (a) K7 and K8 against their plain versions at the 552.8M
                UNet's shapes (3x3 256->256 at 8x256^2, 3x3 1024->1024 at
                8x16^2 and at 8x8^2, both split-K, a 1x1 768->512 skip at
                8x64^2, the qkv dense 512->1536 over 8x32^2 rows, a
                stride-2 3x3 at 2x64^2): K7's int8, ax and amax bit-equal
                (dynamic, static, channels last), K8 within one bf16 ulp;
                K8's launch plan; ms through the wrapper and on the
                device (K7 static and dynamic), the bound (bytes at 3.35
                TB/s or operations at 1979 TOPS int8; K7 per mode), the
                plain versions', torch.quantize_per_tensor's (K7),
                torch._int_mm's (after F.unfold for a conv) and bf16
                F.conv2d's (K8).  (b) configs/default.yaml with
                ddnm_quant_int8 (static scales) on phase 4's cached-mesh
                cube at full width: the first recon calibrates (K7 = K8 =
                2 x 136 x 100, K2 = 3200), the second is timed (136 x 100,
                K2 = 1600, K3 = 100, K1 >= 3); phase 4's output checks;
                its inpaint seconds beside phase 4's; its views against
                phase 4's (finite, known region >= 60 dB).  (c)
                cli/w8a8_fidelity on the flagship at 10 sampling steps:
                the int8 samplers' PSNR against bf16 on perturbed weights
                (finite, known region >= 60 dB; the rest recorded).
 10. options  : the Pipeline options of the later slice, on phase 4's
                Pipeline.  (a) complete_unseen_by 'optimize' (the
                tri-plane colour field, 400 Adam steps replayed from one
                CUDA graph) on the cached-mesh cube, DDNM included:
                launches K1 >= 3, K2 = 1600, K3 = 100; phase 4's output
                checks; the texels NBF painted unchanged; the fit's loss
                falls; the card's 20-step fit against the port's CPU fit
                from one init on a uniform 32,768-point cloud (predictions
                within 1e-4); the complete stage's seconds beside phase
                4's neighbour completion, the fit's step eager and
                captured.  (b) unproject_by 'face', naive_face_view false
                (DDNM runs) then true (the Pipeline's own inpainted-view
                cache, K2 = 0): all faces in 8 usemtl groups, 8 view PNGs,
                labels >= 0 and equal to the CPU's assign_face_views on
                the card's counts (equal to the CPU's counts), no unwrap.
                (c) reconstruct_mesh(SPR, 128, 10,000, iso_method 'tets')
                of the cloud alone: phase 5's mesh gates; marching_tets on
                the card against the CPU on one field, and
                decimate_vertex_clustering of both, equal;
                refine_orientation_by_visibility card against CPU (signs
                agree >= 99.9%).  Seconds of each, and the phase's wall.
 11. restore  : the rest of diffusion and NKSR.  (a) cli/ddnm_restore in
     & NKSR     dataset mode (IMAGENET, sr4, batch 8, 100 steps) over 8
                synthetic PNGs of mixed sizes (BOX halving and BICUBIC) on
                the seeded random 552.8M bf16 UNet: K2 = 1600, 8 finite
                outputs in [0, 1], the restored and degraded PNGs; seconds
                beside phase 4's inpaint.  (b) ddnm_plus_sample, card
                against CPU, for all ten --deg at sigma_y 0 and 0.05 (tiny
                fp32 UNet at 32^2, the same draws, 10 steps; 1e-4 of the
                largest value).  (c) one timed forward each at batch 8:
                the classifier (EncoderUNetModel at the public 256x256
                classifier's widths, attention pool) at 256^2, SuperRes
                over the 552.8M torso 64^2 -> 256^2, the DDPM UNet at
                celeba_plan at 256^2; K2 launches 7, 16, 0; K2 against its
                plain version at the classifier's shapes (T/heads 1024/4,
                256/8, 64/8; one bf16 ulp; kernel table row
                attention_qkv_encoder); each model at a tiny width, card
                against CPU (1e-4 relative).  (d) recon_one_shape_NKSR at
                its defaults on the cloud alone on the card (distance to
                the cube beside phase 5's), the card against the CPU at
                grid 64 (chamfer < 1e-3), stage seconds, the QEM to
                10,000 faces; geometry_table --backends NKSR on the card.
 12. multi-   : (a) at world size 1 through NCCL (one process, a
     device     tcp://127.0.0.1 store; the card cannot hold two ranks, so
     & host     dp > 1 and tp > 1 run only on the CPU, in the tests):
     tools      DDNMInpainter on the seeded random 552.8M bf16 UNet over
                phase 4's 8 sparse views (256^2, the UNet's input), 100
                steps, without and with make_mesh(1): bit-equal, K2 = 1600 and one all_gather on the
                mesh run; POCO's fit at phase 7's shape (hidden 64, batch 4
                x 1,024 points, 512 queries), 2 x 10 captured steps without
                and with the mesh: bit-equal, one broadcast and 22
                all_reduces (a pair that differs is rerun without the mesh:
                a mesh-less run that reproduces itself fails the pair);
                seconds of each.  (b) the host modules on the machine
                without PIL or matplotlib: the JPEG fixtures of
                tests/data/jpeg against their committed PIL decodes (bit
                for bit), 30,000 points sampled from phase 4's OBJ on the
                card against the CPU (coordinates equal, colours within
                1e-5), phase 4's mesh as GLB read back (triangles and
                texture), a sheet of phase 4's views and the cloud's three
                views.
 13. image    : the image decoders of the port (webp.py, vp8.py, vp8l.py,
     input      jpeg.py's progressive scans; host code).  (a) every WebP
                fixture of tests/data/webp and every progressive JPEG
                fixture of tests/data/jpeg through io.load_image against
                its committed PIL decode, bit for bit; host seconds per
                file type.  (b) cli/ddnm_restore in dataset mode over a
                folder of 8 of those fixtures (lossy, lossless, alpha,
                raw-alpha and animated WebP, progressive JPEG), IMAGENET
                preprocessing, sr4, batch 8, 100 steps on the seeded
                random 552.8M bf16 UNet: the batch the dataset feeds equals
                the batch built from the committed PNG decodes, K2 = 1600,
                outputs finite in [0, 1], 16 PNGs.  (c) the 512x384 timing
                fixtures of tests/data/timing (lossy WebP at quality 80,
                progressive JPEG): the median host seconds of 3 decodes
                and the SHA-256 of the decoded bytes against the committed
                one; the host CPU's model.
 14. inputs   : what the JAX package reads through PIL and PyYAML that the
     by         port refused before (config.py, io.py's sniffing and modes,
     content    jpeg.py's CMYK / YCCK, arithmetic, lossless and smoothed
                frames, gif.py, tiff.py; host code).  (a) every JPEG, GIF,
                TIFF and PNG fixture of this phase against its committed
                PIL decode, bit for bit; host seconds by detected type.
                (b) cli/ddnm_restore over a folder of 8 of them (CMYK,
                YCCK, arithmetic, arithmetic progressive, smoothed
                progressive, lossless RGB and grey JPEG, a PNG named
                .JPEG), as phase 13 (b): sr4, batch 8, 100 steps, the
                seeded random 552.8M bf16 UNet, the fed batch equal to
                the one built from the PNG decodes, K2 = 1600; then
                --image on a 256x256 LZW TIFF and on a 256x256 GIF, each
                fed image equal to its PNG decode, K2 = 1600 each.  (c)
                save_config -> load_config of phase 4's config equal; the
                committed config the JAX package's save_config wrote
                (block-style lists) read equal and written back byte for
                byte.  (d) morph_close (exact), bilateral_filter (1e-5)
                and ndc_to_pixels (exact) on CUDA tensors against the CPU,
                with their CUDA-event ms.  (e) the 512x384 LZW TIFF, GIF
                and arithmetic-JPEG timing fixtures: median host seconds
                of 3 decodes, the SHA-256 against the committed one.
 15. readers  : configs and images the JAX package reads through PyYAML
                and PIL that the port refused or misread (yamlread.py,
                io.py's PNM, tiff.py, fax.py, tga.py, pcx.py, sgi.py,
                qoi.py, ico.py, msp.py, xbm.py; host code).  (a) every
                fixture under tests/data/{pnm,tiff_more,tga,pcx,sgi,qoi,
                ico,bilevel,restore16} against its committed PIL decode
                (convert("RGBA")), bit for bit; host seconds by detected
                type.  (b) cli/ddnm_restore over tests/data/restore16 (P6
                at maxval 65535 and 100, P5 at 1000, a CMYK LZW TIFF, a
                YCbCr JPEG TIFF, an RLE TGA, an RLE SGI and a QOI, under
                .ppm, .png and .jpg names), as phase 13 (b): sr4, batch 8,
                100 steps, the seeded random 552.8M bf16 UNet, the fed
                batch equal to the one built from the PIL decodes, K2 =
                1600; then --image on a 256x256 TGA, the fed image equal to
                its PIL decode, K2 = 1600.  (c) the configs with anchors,
                merge keys, block scalars and tags load to the
                PipelineConfig of their plain twin; strict=True raises on
                their unknown keys.
 16. rest     : the rest of PIL 12.1's readers (bcn.py, dds.py, psd.py,
                icns.py, blp.py, im.py, spider.py, fits.py, xpm.py,
                fli.py, sun.py, dcx.py, pcd.py, iptc.py, smallimg.py,
                refused.py; host code).  (a) every fixture under
                tests/data/{dds,blp,psd,icns,im,sci,xpm,fli,sun,dcx,pcd,
                small,restore17} against its committed PIL decode
                (convert("RGBA")) and, for "F", "I" and "I;16*", its
                committed pixels, bit for bit; host seconds by detected
                type.  (b) cli/ddnm_restore over tests/data/restore17 (a
                PackBits PSD, a BC7 and a DXT1 DDS, a BLP2 palette, an
                IM, an RLE SUN, an FLI and a float FITS, under the
                dataset's extensions), as phase 15 (b), K2 = 1600; then
                --image on a 256x256 PackBits PSD, K2 = 1600.  (c) MPEG,
                WMF, BUFR, GRIB and HDF5 headers are named as PIL names
                them and raise naming the type.
 17. j2k      : JPEG 2000 and ZSTD TIFF (jpeg2000.py, jp2.py,
                j2k_codestream.py, j2k_t2.py, j2k_t1.py, j2k_dwt.py,
                zstd.py; host code).  (a) every fixture under
                tests/data/{jp2,zstd,restore18} against its committed PIL
                decode (convert("RGBA")) and, for "I;16", its committed
                pixels, bit for bit; host seconds by detected type.  (b)
                cli/ddnm_restore over tests/data/restore18 (JP2 files and
                raw codestreams, 5/3 and 9/7, tiled, layered, RPCL with
                precincts, SOP / EPH, an ICNS of a JPEG 2000 icon and a
                ZSTD TIFF, under the dataset's extensions), as phase 15
                (b), K2 = 1600; then --image on a 256x256 JP2 (9/7, 5
                levels, 3 layers), the fed image equal to its PIL decode,
                K2 = 1600.  (d) an AVIF fixture decodes, bit-equal to its
                PIL decode.
 18. avif     : AVIF (avif.py, av1_*.py, avif_rgb.py; host code).  (a)
                every fixture under tests/data/{avif,restore19} against
                its committed PIL decode ("RGB" / "RGBA"), bit for bit;
                host seconds by bit depth and chroma format.  (b)
                cli/ddnm_restore over tests/data/restore19 (8 AVIFs under
                the dataset's extensions: 4:2:0, 4:4:4, RGBA, 10-bit,
                film grain, lossless, 4:2:2, screen content), the fed
                batch equal to the PIL-decoded batch, K2 = 1600.  (c)
                --image on a 256x256 AVIF, K2 = 1600.  (d) the host
                decode seconds of a 512x384 q60 AVIF (median of 3) and
                the SHA-256 of its pixels against the committed digest.
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
    """K2's bf16 instantiations, K6 and K8's two must hold tensor-core
    instructions (HMMA / HGMMA in `cuobjdump -sass` of the built library;
    for K8 the int8 warpgroup product IGMMA, so a K8 on mma.sync's IMMA
    fails); print each count and the registers and spills `-Xptxas -v`
    gave them."""
    import re

    from pointdreamer_tpu_torch import kernels

    counts = kernels.sass_mma_counts(path)
    igmma = kernels.sass_mma_counts(path, ("IGMMA",))
    want = {f"K2 bf16 hd {hd}{' masked' if m else ''}":
            f"attn_mma_kernelILi{hd}ELb{m}E"
            for hd in (16, 32, 64) for m in (0, 1)}
    want["K6"] = "wino_mma_kernel"
    for bf in (1, 0):
        want[f"K8 {'bf16' if bf else 'fp32'}"] = f"int8_conv_kernelILb{bf}EE"
    with open(path + ".ptxas.txt") as f:
        ptxas = f.read()
    for what, key in want.items():
        found = [c for name, c in (igmma if what.startswith("K8") else
                                   counts).items() if key in name]
        regs = re.search(re.escape(key) + r".*?Used (\d+) registers",
                         ptxas, re.S)
        spills = re.search(re.escape(key) + r".*?(\d+) bytes spill stores",
                           ptxas, re.S)
        print(f"[build] {what}: {found[0] if found else 0} tensor-core "
              f"instructions ({'IGMMA' if what.startswith('K8') else 'HMMA'}"
              f"{'' if what.startswith('K8') else '/GMMA'}), "
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


# the 552.8M UNet's GroupNorm sites, each one K5 launch a forward: the
# norms of its 42 ResBlocks (two each), 16 attention blocks and the head
GN_SITES = 101


def unet_split(unet, dev, gen, reps: int = 5) -> None:
    """Phase 4's UNet, one forward at the sampler's batch (8 views at
    256^2): profile_unet's kernel time by class with every GroupNorm site
    on K5, then with every site the unfused chain (the route's predicate
    replaced for the call), so the norm, elementwise, transpose and conv
    classes show what the fused route moved; K5 launches a forward."""
    import torch

    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.models.diffusion import unet as tunet
    from pointdreamer_tpu_torch.models.diffusion.unet import DYNAMIC
    from pointdreamer_tpu_torch.profile_unet import _report, profile_forward

    x = torch.randn((8, 256, 256, 3), generator=gen, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    route = tunet._fused_norm_ok
    for what, ok in (("K5 route", route), ("unfused chain",
                                            lambda *args: False)):
        tunet._fused_norm_ok = ok
        try:
            kernels.reset_launches()
            with torch.no_grad():
                unet(x, t)
            n = kernels.LAUNCHES["groupnorm"]
            r = profile_forward(unet, x, t, DYNAMIC, reps)
        finally:
            tunet._fused_norm_ok = route
        print(f"[unet] {what}: K5 launches a forward {n}")
        _report(what, r, reps)
        if what == "K5 route" and n != GN_SITES:
            fail(f"K5 launched {n} times in a forward, not {GN_SITES}")
    torch.cuda.empty_cache()


def check_groupnorm(dev, gen) -> dict:
    """K5 against its plain version at the 552.8M UNet's GroupNorm shapes
    and modes (bf16 in, B = 8): the ResBlocks' scale-shift norms at C 256,
    512 and 1024, their in-norms, the attention norm, the head's with its
    fp32 output.  A bf16 output within one bf16 ulp, an fp32 one within
    2e-5 (the same fp32 statistics summed in another order, an FMA, a
    fast exp).  Prints, for each shape, the wrapper's ms and its device ms
    (CUDA-graph replays), F.group_norm's two, and the bound.  Returns the
    kernel table row (times and bounds summed over the shapes)."""
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
    bf, f32 = torch.bfloat16, torch.float32
    shapes = (
        ((8, 65536, 256), True, True, bf, "256^2 ResBlock out_norm"),
        ((8, 65536, 512), False, True, bf, "256^2 first output block"),
        ((8, 4096, 512), True, True, bf, "64^2 ResBlock out_norm"),
        ((8, 256, 1024), True, True, bf, "16^2 ResBlock out_norm"),
        ((8, 256, 1024), False, False, bf, "16^2 attention norm"),
        ((8, 64, 2048), False, False, bf, "8^2 output-block concat"),
        ((8, 65536, 256), False, True, f32, "256^2 head norm, fp32 out"))
    for (B, S, C), with_ss, silu, od, what in shapes:
        x = (torch.randn((B, S, C), generator=gen, device=dev) * 2.0
             + 0.3).to(torch.bfloat16)
        g = torch.randn(C, generator=gen, device=dev) * 0.5 + 1.0
        b = torch.randn(C, generator=gen, device=dev) * 0.2
        ss = (torch.randn((B, 2 * C), generator=gen, device=dev) * 0.3
              if with_ss else None)
        got = fused_groupnorm(x, g, b, ss, silu=silu, out_dtype=od)
        want = fused_groupnorm_plain(x, g, b, ss, silu=silu,
                                     out_dtype=od).float()
        torch.cuda.synchronize()
        if got.dtype != od:
            fail(f"K5 {what}: output {got.dtype}, not {od}")
        err = (got.float() - want).abs()
        ulps = float((err / bf16_ulp(want)).max())
        if od == bf and not ulps <= 1.0:
            fail(f"K5 {what}: {ulps} bf16 ulps from its plain version")
        if od == f32 and not float(err.max()) <= 2e-5:
            fail(f"K5 {what}: {float(err.max())} from its plain version")
        # 30 calls for the wrapper times: at the small shapes they are the
        # host's, which varies from call to call
        ms = cuda_ms(lambda: fused_groupnorm(x, g, b, ss, silu=silu,
                                             out_dtype=od), reps=30)
        gms = graph_ms(lambda: fused_groupnorm(x, g, b, ss, silu=silu,
                                               out_dtype=od))
        pms = cuda_ms(lambda: fused_groupnorm_plain(
            x, g, b, ss, silu=silu, out_dtype=od), reps=3, warmup=1)
        xc = x.transpose(1, 2).contiguous()
        gb, bb = g.bfloat16(), b.bfloat16()
        lms = cuda_ms(lambda: F_.group_norm(xc, 32, gb, bb, 1e-5), reps=30)
        glms = graph_ms(lambda: F_.group_norm(xc, 32, gb, bb, 1e-5))
        # one read of x (bf16) and one write of y, gamma/beta/ss once;
        # per element: sum, square, sum of squares, scale, bias, and 3
        # for the scale-shift, 4 for the SiLU
        n = B * S * C
        ob = got.element_size()
        b_x = n * (2 + ob) + C * 8 + (B * 2 * C * 4 if with_ss else 0)
        o_x = n * (5 + 3 * with_ss + 4 * silu)
        b_ms, b_by = bound(b_x, o_x, FP32_OPS_PER_S)
        plan = launch_plan(B, S, C, 2, ob, _resident(dev, True, od == bf))
        print(f"[K5 groupnorm] {what} {[B, S, C]} ss={with_ss} silu={silu} "
              f"out={str(od)[6:]} {plan} max_abs_err={float(err.max()):.3g} "
              f"({ulps:.3g} bf16 ulp) "
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
    print(f"[K5 groupnorm] {len(shapes)} shapes: ms={row['ms']:.4f} "
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
                     "groupnorm": 2 * GN_SITES * 100, "winograd_conv3x3": 0,
                     "quantize_act": 0, "int8_conv": 0}
    if launches != want_launches:
        fail(f"run_dataset launches {launches}, not {want_launches} (two "
             f"shapes: K1 3 + 1 render, K2 1600, K3 100, K5 10,100 each)")
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


# K8's shapes in phase 9 (a): (what, B, Cin, H, W, Cout, k, stride); the
# first five are the 552.8M UNet's own (its largest 3x3, its 1024-wide
# 3x3 at 16^2 and at 8^2, both split-K, an output block's 1x1 skip, the
# qkv of an attention block at 32^2: QDense8's [b, t, c] is H = t, W =
# 1), the last the stride-2 path at a small shape
K8_SHAPES = (
    ("3x3 256->256 at 8x256^2", 8, 256, 256, 256, 256, 3, 1),
    ("3x3 1024->1024 at 8x16^2", 8, 1024, 16, 16, 1024, 3, 1),
    ("3x3 1024->1024 at 8x8^2", 8, 1024, 8, 8, 1024, 3, 1),
    ("1x1 skip 768->512 at 8x64^2", 8, 768, 64, 64, 512, 1, 1),
    ("dense qkv 512->1536 over 8x32^2 rows", 8, 512, 1024, 1, 1536, 1, 1),
    ("3x3 stride 2 256->256 at 2x64^2", 2, 256, 64, 64, 256, 3, 2),
)


def check_quant(dev, gen) -> list:
    """Phase 9 (a): K7 and K8 against their plain versions at K8_SHAPES
    (bf16 activations), called as QConv8 calls them: K7 on the NHWC view
    of a channels-last NCHW activation, K8 writing rows.  K7's int8
    output, ax and the amax it records bit for bit, also with a static
    amax from a scale table, and at the attention's proj ([b, t, c]); K8
    within one bf16 ulp at every element, with its launch plan.  Prints
    for each shape the wrapper's and the device (CUDA graph) ms of both
    (K7 static, the recon's mode, and dynamic), their bounds (K7 static:
    x read once, int8 written; dynamic: x read twice), the plain
    versions' ms, the library's: for K7 torch.quantize_per_tensor of x
    cast to fp32 (cast included; it clamps to -128 and multiplies by
    1 / scale, so it is not bit-equal), for K8 the
    int8 product of torch._int_mm (for a conv after F.unfold) and bf16
    F.conv2d (channels last).  Returns the two kernel-table rows, times
    and bounds summed over the shapes (K7's in static mode, its dynamic
    ones beside them)."""
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
    dyn = dict(ms=0.0, device_ms=0.0, bytes=0.0)   # K7 with dynamic amax

    def k7_same(what, x, static):
        q, ax = kq.quantize_act(x, static)
        q_p, ax_p = kq.quantize_act_plain(x, static)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_p) and torch.equal(ax, ax_p)):
            fail(f"K7 {what}: {int((q != q_p).sum())} int8 entries, ax "
                 f"{float(ax)} vs {float(ax_p)}")
        return q, ax

    for what, B, Cin, H, W, N, k, s in K8_SHAPES:
        pad = 1 if k == 3 else 0
        # the torso's activation (channels last in memory) and the NHWC
        # view of it that QConv8 hands K7
        xc = (torch.randn((B, Cin, H, W), generator=gen, device=dev) * 1.7
              + 0.2).to(torch.bfloat16).contiguous(
                  memory_format=torch.channels_last)
        x = xc.permute(0, 2, 3, 1)
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
        k7_same(f"{what}, static", x, table[1, 2:3])
        xq = q.view(B, H, W, Cin)
        wq = torch.randint(-127, 128, (N, k * k * Cin), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(N, generator=gen, device=dev) * 2e-3 + 1e-4
        bias = torch.randn(N, generator=gen, device=dev) * 0.1
        args = (xq, wq, ax, ks, bias, k, k, s, pad, torch.bfloat16)
        y = kq.int8_conv(*args)
        y_p = kq.int8_conv_plain(*args).float()
        torch.cuda.synchronize()
        err = (y.float() - y_p).abs()
        ulps = float((err / bf16_ulp(y_p)).max())
        if not ulps <= 1.0:
            fail(f"K8 {what}: {ulps} bf16 ulps from its plain version")
        # times: the wrapper (host included) and the device (CUDA graph);
        # K7 static (the recon's mode) and dynamic
        slot = table[1, 2:3]
        ms7 = cuda_ms(lambda: kq.quantize_act(x, slot))
        gms7 = graph_ms(lambda: kq.quantize_act(x, slot))
        dms7 = cuda_ms(lambda: kq.quantize_act(x))
        dgms7 = graph_ms(lambda: kq.quantize_act(x))
        pms7 = cuda_ms(lambda: kq.quantize_act_plain(x, slot),
                       reps=3, warmup=1)
        scale = float(kq.act_scale(table[1, 2]))
        lms7 = cuda_ms(lambda: torch.quantize_per_tensor(
            x.float(), scale, 0, torch.qint8))
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
        wb = torch.randn((N, Cin, k, k), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cms = cuda_ms(lambda: F_.conv2d(xc, wb, None, s, pad))
        # bounds: K7 static reads x once and writes int8, dynamic reads x
        # twice; K8 reads xq and wq once and writes bf16, and does 2 M N K
        # int8 operations
        n_x = x.numel()
        M = y.numel() // N
        b7 = n_x * 2 + n_x
        b8 = xq.numel() + wq.numel() + M * N * 2
        o8 = 2.0 * M * N * k * k * Cin
        bm7, by7 = bound(b7, n_x * 4.0, INT8_OPS_PER_S)
        dbm7, _ = bound(b7 + n_x * 2, n_x * 4.0, INT8_OPS_PER_S)
        bm8, by8 = bound(b8, o8, INT8_OPS_PER_S)
        print(f"[K7 quantize_act] {what}: x {list(x.shape)} bf16, bit-equal "
              f"(int8, ax, amax; dynamic and static); static: ms={ms7:.4f} "
              f"device_ms={gms7:.4f} bound_ms={bm7:.4f} ({by7}; device time "
              f"{bm7 / gms7:.0%} of it); dynamic: ms={dms7:.4f} "
              f"device_ms={dgms7:.4f} bound_ms={dbm7:.4f} ({dbm7 / dgms7:.0%});"
              f" plain_ms={pms7:.4f} quantize_per_tensor_ms={lms7:.4f}")
        plan = kq.conv_plan(B, H, W, Cin, N, k, k, s, pad)
        print(f"[K8 int8_conv] {what}: plan chunk {plan.chunk} "
              f"{'rows' if plan.rows else f'box {plan.box}'} "
              f"tiles {plan.m_tiles}x{plan.n_tiles} split-K {plan.splits} "
              f"grid {plan.grid}")
        print(f"[K8 int8_conv] {what}: M={M} N={N} K={k * k * Cin} "
              f"max_abs_err={float(err.max()):.3g} ({ulps:.3g} bf16 ulp) "
              f"ms={ms8:.4f} device_ms={gms8:.4f} plain_ms={pms8:.4f} "
              f"int_mm_ms={lms:.4f} (int32 equal {lib_same}) "
              f"bf16_conv2d_ms={cms:.4f} bound_ms={bm8:.4f} ({by8}; device "
              f"time {bm8 / gms8:.0%} of it, "
              f"{o8 / gms8 / 1e9:.0f} TOP/s)")
        dyn["ms"] += dms7
        dyn["device_ms"] += dgms7
        dyn["bytes"] += b7 + n_x * 2
        for n, ms, gms, pms, lm, by, op, e in (
                ("quantize_act", ms7, gms7, pms7, lms7, b7, n_x * 4.0, 0.0),
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
    # the attention's proj: K7 on the [b, t, c] K2 writes, dynamic and
    # static, and K8 to rows
    B, T, C = 8, 1024, 512
    x = (torch.randn((B, T, C), generator=gen, device=dev) * 1.7
         + 0.2).to(torch.bfloat16)
    table = torch.zeros((3, 4), device=dev)
    table[2, 1] = x.float().abs().amax() * 0.7
    k7_same("proj 512->512 rows, static", x, table[2, 1:2])
    q, ax = k7_same("proj 512->512 rows", x, None)
    wq = torch.randint(-127, 128, (C, C), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(C, generator=gen, device=dev) * 2e-3 + 1e-4
    bias = torch.randn(C, generator=gen, device=dev) * 0.1
    args = (q.view(B, T, 1, C), wq, ax, ks, bias, 1, 1, 1, 0,
            torch.bfloat16)
    y = kq.int8_conv(*args)
    y_p = kq.int8_conv_plain(*args).float()
    ulps = float(((y.float() - y_p).abs() / bf16_ulp(y_p)).max())
    print(f"[K7 quantize_act] proj 512->512 over 8x32^2 rows: bit-equal, "
          f"dynamic and static; [K8 int8_conv] to rows {list(y.shape)}: "
          f"{ulps:.3g} bf16 ulp")
    if not ulps <= 1.0:
        fail(f"K8 proj 512->512 to rows: {ulps} bf16 ulps from its plain "
             f"version")
    del x, q, wq, y, y_p
    out = []
    for n, r in rows.items():
        ops = r.pop("ops")
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), ops,
                                             INT8_OPS_PER_S)
        if n == "quantize_act":
            r["dynamic_ms"], r["dynamic_device_ms"] = dyn["ms"], \
                dyn["device_ms"]
            r["dynamic_bound_ms"] = bound(dyn["bytes"], ops,
                                          INT8_OPS_PER_S)[0]
        print(f"[{'K7' if n == 'quantize_act' else 'K8'} {n}] "
              f"{len(K8_SHAPES)} shapes: ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f}"
              + (f"; dynamic amax: ms={r['dynamic_ms']:.4f} device_ms="
                 f"{r['dynamic_device_ms']:.4f} bound_ms="
                 f"{r['dynamic_bound_ms']:.4f}" if n == "quantize_act"
                 else ""))
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
    2 x 136 x 100, K5 2 x 101 x 100, K2 3200), the second is timed (136 x
    100, K5 101 x 100, K2 1600);
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
                "raster_legacy": 0, "groupnorm": n * GN_SITES * steps,
                "winograd_conv3x3": 0}
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


def _launch_run(pipe, ply: str, out: str):
    """One timed recon_one_textured_mesh into `out`, the launch counts set
    to 0 just before it and read just after.  Returns (obj, stage seconds,
    launches, wall seconds)."""
    import torch

    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.log import StageTimer

    pipe.cfg.output_path = out
    timer = StageTimer(None, sync=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    obj = pipe.recon_one_textured_mesh(ply, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return obj, dict(timer.times), dict(kernels.LAUNCHES), wall


def optimize_completion_phase(dev, pipe, ply: str, work: str,
                              e2e_stages: dict) -> None:
    """Phase 10 (a): configs/default.yaml with complete_unseen_by
    'optimize' on phase 4's cached-mesh cube, whole (DDNM included);
    launches K1 >= 3, K2 = 1600, K3 = 100; phase 4's output checks; the
    texels NBF painted unchanged by the fit; the fit's loss falls; the
    card's field after 20 steps against the port's CPU fit from the same
    init on a uniform cloud; the fit's step times, eager and captured."""
    import copy

    import numpy as np
    import torch

    import pointdreamer_tpu_torch.models.texture_field as texfield
    from pointdreamer_tpu_torch.models.texture_field import triplane

    cfg = pipe.cfg
    seen = {}
    real_fit, real_paint = triplane.fit_color_field, texfield.fit_and_paint

    def fit_spy(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        field, losses = real_fit(*a, **k)
        torch.cuda.synchronize()
        seen["fit_s"] = time.perf_counter() - t0
        seen["losses"] = losses.cpu().numpy()
        return field, losses

    def paint_spy(atlas_img, painted, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_paint(atlas_img, painted, *a, **k)
        torch.cuda.synchronize()
        seen["paint_s"] = time.perf_counter() - t0
        seen["painted_kept"] = bool((out[painted] == atlas_img[painted])
                                    .all())
        seen["n_painted"] = int(painted.sum())
        seen["n_unseen"] = int((a[1] & ~painted).sum())
        return out

    cfg.complete_unseen_by = "optimize"
    triplane.fit_color_field, texfield.fit_and_paint = fit_spy, paint_spy
    try:
        obj, stages, launches, wall = _launch_run(
            pipe, ply, os.path.join(work, "out_optimize"))
    finally:
        triplane.fit_color_field, texfield.fit_and_paint = (real_fit,
                                                            real_paint)
        cfg.complete_unseen_by = "neighbor"
    print(f"[optimize] timed run {wall:.3f} s stages "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}")
    print(f"[optimize] launches {json.dumps(launches)}")
    if launches["attention_qkv"] != 1600 or launches["segment_sum"] != 100 \
            or launches["raster_binned"] < 3:
        fail(f"optimize completion launches {launches}: not K2 = 1600, "
             f"K3 = 100, K1 >= 3")
    check_outputs(obj, cfg, "optimize")
    losses = seen["losses"]
    print(f"[optimize] complete stage {stages['complete']:.4f} s against "
          f"phase 4's neighbour completion {e2e_stages['complete']:.4f} s: "
          f"the fit {seen['fit_s']:.4f} s (the field's init, the capture, "
          f"400 replays), the field at the {cfg.xatlas_texture_res}^2 "
          f"texels "
          f"{seen['paint_s'] - seen['fit_s']:.4f} s, the rest (the nearest "
          f"fill) {stages['complete'] - seen['paint_s']:.4f} s; "
          f"{seen['n_unseen']} unseen texels painted by the field, "
          f"{seen['n_painted']} NBF texels kept: {seen['painted_kept']}; "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f} over {len(losses)} "
          f"steps")
    if not seen["painted_kept"]:
        fail("the complete stage changed texels NBF painted")
    if not (len(losses) == 400 and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        fail(f"the fit's loss did not fall: {losses[0]} -> {losses[-1]}")

    # the card against the port's CPU, from one init on a uniform cloud of
    # the pipeline's padded size.  The gradient: within 1e-4 of each
    # tensor's largest.  The fit (20 steps): Adam turns gradient entries
    # that cancel to rounding level into full steps of either sign
    # (tests/test_torch_texture_field.py), so the summation order alone
    # moves the field; the CPU's own order spread (1 thread against 4)
    # sets the bound: mean |d| within 4 x its.
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-0.5, 0.5, (32768, 3)).astype(np.float32)
    rgb = rng.random((32768, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (65536, 3)).astype(np.float32)
    init = triplane.TriplaneColorField(
        torch.Generator(device="cpu").manual_seed(1), device="cpu")
    grads = []
    for d in (dev, torch.device("cpu")):
        f = copy.deepcopy(init).to(d)
        opt = triplane.AdamCosine(f.parameters(), 1e-2, 20, alpha=1.0)
        triplane.loss_and_grad(f, opt, torch.as_tensor(xyz, device=d),
                               torch.as_tensor(rgb, device=d) * 2.0 - 1.0)
        grads.append({n: p.grad.cpu() for n, p in f.named_parameters()})
    g_err = max(float((grads[0][n] - g).abs().max()
                      / g.abs().max().clamp(min=1e-30))
                for n, g in grads[1].items())
    n_threads = torch.get_num_threads()
    runs = []
    for d, threads in ((dev, n_threads), ("cpu", 1), ("cpu", 4)):
        torch.set_num_threads(threads)
        f, ls = triplane.fit_color_field(
            torch.as_tensor(xyz, device=d), torch.as_tensor(rgb, device=d),
            20, init=init)
        with torch.no_grad():
            runs.append((f(torch.as_tensor(q, device=d)).cpu().numpy(),
                         ls.cpu().numpy()))
    torch.set_num_threads(n_threads)
    (pred_card, loss_card), (pred_cpu, loss_cpu), (pred_cpu4, _) = runs
    d_card = np.abs(pred_card - pred_cpu)
    d_cpu = np.abs(pred_cpu4 - pred_cpu)
    lrel = float((np.abs(loss_card - loss_cpu) / loss_cpu).max())
    print(f"[optimize] the card against the CPU (32768 uniform points): "
          f"gradient at the init within {g_err:.3g} of each tensor's "
          f"largest (bound 1e-4); after 20 steps, over 65536 queries, "
          f"mean |d| {d_card.mean():.3g} max {d_card.max():.3g} against "
          f"the CPU's own spread (1 vs 4 threads) mean {d_cpu.mean():.3g} "
          f"max {d_cpu.max():.3g}; losses within {lrel:.3g} relative")
    if not (g_err <= 1e-4 and d_card.mean() <= 4 * d_cpu.mean() + 1e-6):
        fail(f"the card's fit against the CPU's: gradient {g_err}, field "
             f"mean |d| {d_card.mean()} (CPU spread {d_cpu.mean()})")

    # the fit's step on the card: eager against one CUDA-graph replay, at
    # the pipeline's shape (the padded cloud)
    xyz_t = torch.as_tensor(xyz, device=dev)
    target = torch.as_tensor(rgb, device=dev) * 2.0 - 1.0
    field = triplane.TriplaneColorField(device=dev)
    opt = triplane.AdamCosine(field.parameters(), 1e-2, 400, alpha=1.0)
    eager = cuda_ms(lambda: triplane.fit_step(field, opt, xyz_t, target),
                    reps=20, warmup=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = triplane.CapturedFitStep(field, opt, xyz_t, target, 100)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captured = cuda_ms(step, reps=20, warmup=3)
    print(f"[optimize] fit step at 32768 points: eager {eager:.4f} ms, "
          f"captured {captured:.4f} ms (400 steps: {0.4 * captured:.3f} s); "
          f"warm-up and capture, the process's second: {capture_s:.4f} s")
    # where the step's device time goes: 5 eager steps traced
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            triplane.fit_step(field, opt, xyz_t, target)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            ms, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (ms + e.device_time_total / 5e3, n + e.count)
    kernel_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"[optimize] fit step traced: {sum(n for _, n in by_name.values()) / 5:.0f} "
          f"device events, {kernel_ms:.4f} ms of device time a step; top: "
          + "; ".join(f"{k[:70]} {ms:.4f} ms x{n // 5}"
                      for k, (ms, n) in top))


def _face_labels(path: str, n_faces: int):
    """Per face the material index of its usemtl group in a face-mode OBJ
    (face i's corners are vt 3i+1..3i+3); -1 where no line lists it."""
    import numpy as np

    labels = np.full(n_faces, -1, np.int64)
    mat = -1
    with open(path) as fh:
        for line in fh:
            if line.startswith("usemtl material_"):
                mat = int(line.split("_")[1])
            elif line.startswith("f "):
                t = int(line.split()[1].split("/")[1])
                labels[(t - 1) // 3] = mat
    return labels


def face_mode_phase(dev, pipe, ply: str, work: str) -> None:
    """Phase 10 (b): unproject_by 'face' on phase 4's Pipeline and cached
    mesh, naive_face_view false (DDNM runs: K1 >= 1, K2 = 1600), then true
    into the same output directory (the Pipeline's own inpainted-view
    cache: K2 = 0).  The OBJ lists all F faces in 8 usemtl groups, 8 view
    PNGs beside it, every label >= 0; the card's counts equal the CPU's
    from the same face-id maps and the labels equal the port's CPU
    assign_face_views on them (naive: argmax of normal . view); no unwrap
    ran."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.ops import raster as orast
    from pointdreamer_tpu_torch.pipeline import face_assign as pface
    from pointdreamer_tpu_torch.pipeline.geometry import normalize_points
    from pointdreamer_tpu_torch.pipeline.pipeline import _pad_mesh

    cfg = pipe.cfg
    seen = {}
    real_counts = pface.face_view_pixel_counts

    def counts_spy(face_idxs, n_faces):
        out = real_counts(face_idxs, n_faces)
        seen["face_idxs"], seen["counts"] = face_idxs, out
        return out

    # the similarity the pipeline computes, from the same mesh and ops
    xyz, _ = pio.read_ply_xyzrgb(ply)
    _, center, scale = normalize_points(xyz)
    mesh = pio.load_obj(ply.replace(".ply", "_untextured_mesh.obj"))
    verts = (mesh["vertices"] - center) / scale
    faces = mesh["faces"]
    n_faces = len(faces)
    verts_p, faces_p, _, _ = _pad_mesh(verts, faces)
    f_normals = orast.face_normals(torch.as_tensor(verts_p, device=dev),
                                   torch.as_tensor(faces_p, device=dev))
    sim = (f_normals[:n_faces] @ pipe.rig.base_dirs.T).cpu().numpy()
    neighbors = pface.face_adjacency_neighbors(faces)

    out = os.path.join(work, "out_face")
    cfg.unproject_by = "face"
    pface.face_view_pixel_counts = counts_spy
    try:
        for naive in (False, True):
            cfg.naive_face_view = naive
            seen.clear()
            obj, stages, launches, wall = _launch_run(pipe, ply, out)
            cached = launches["attention_qkv"] == 0
            what = f"face, naive_face_view {naive}"
            print(f"[{what}] timed run {wall:.3f} s stages "
                  f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}"
                  f"; launches {json.dumps(launches)}; inpainted views from "
                  f"the Pipeline's cache: {cached}")
            if launches["raster_binned"] < 1 or launches["attention_qkv"] != \
                    (0 if naive else 1600) or launches["segment_sum"] != 0:
                fail(f"{what}: launches {launches}")
            if cached != naive:
                fail(f"{what}: the inpaint cache was taken: {cached}")
            labels = _face_labels(obj, n_faces)
            with open(obj) as fh:
                text = fh.read()
            groups = text.count("usemtl material_")
            models = os.path.dirname(obj)
            pngs = [pio.load_png(os.path.join(models, f"{i}.png"))
                    for i in range(cfg.view_num)]
            counts_card = seen["counts"][:n_faces].cpu().numpy()
            counts_cpu = pface.face_view_pixel_counts(
                seen["face_idxs"].cpu(), len(faces_p))[:n_faces].numpy()
            want = (sim.argmax(axis=1) if naive else
                    pface.assign_face_views(neighbors, counts_cpu, sim))
            geo = os.path.join(os.path.dirname(models), "geo")
            unwraps = [n for n in os.listdir(geo) if n.startswith("unwrap")]
            print(f"[{what}] {text.count(chr(10) + 'f ')} face lines in "
                  f"{groups} groups, faces per view "
                  f"{np.bincount(labels[labels >= 0], minlength=8).tolist()}"
                  f"; PNGs {[p.shape for p in pngs][:1]} x {len(pngs)}; "
                  f"{int((counts_card.sum(1) == 0).sum())} faces no view "
                  f"sees; labels equal to the CPU's: "
                  f"{int((labels == want).sum())} of {n_faces}; unproject "
                  f"{stages['unproject']:.4f} s, export {stages['export']:.4f}"
                  f" s; unwrap outputs {unwraps}")
            if text.count(chr(10) + "f ") != n_faces or groups != 8 \
                    or not (labels >= 0).all():
                fail(f"{what}: the OBJ does not list the {n_faces} faces in "
                     f"8 groups")
            if len(pngs) != 8 or any(p.shape != (cfg.res, cfg.res, 3)
                                     for p in pngs):
                fail(f"{what}: view PNGs {[p.shape for p in pngs]}")
            if not (counts_card == counts_cpu).all():
                fail(f"{what}: the card's pixel counts differ from the CPU's")
            if not (labels == want).all():
                fail(f"{what}: labels differ from the CPU's")
            if "unwrap.thread" in stages or unwraps:
                fail(f"{what}: an unwrap ran")
    finally:
        pface.face_view_pixel_counts = real_counts
        cfg.unproject_by, cfg.naive_face_view = "vertex", False


def tets_phase(dev, cfg, ply_alone: str, spr_dist: float) -> None:
    """Phase 10 (c): reconstruct_mesh(..., 'SPR', 128, 10000,
    iso_method='tets') of the cloud alone on the card: phase 5's mesh
    gates against the cube and the port's CPU tets mesh; marching_tets on
    the card against the CPU on the same field, then
    decimate_vertex_clustering of both; refine_orientation_by_visibility
    on the 30,000 points, card against CPU."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.log import StageTimer
    from pointdreamer_tpu_torch.ops import iso as oiso
    from pointdreamer_tpu_torch.ops import sdf as osdf
    from pointdreamer_tpu_torch.pipeline import geometry as pgeo

    xyz, _ = pio.read_ply_xyzrgb(ply_alone)
    xyz_n, _, _ = pgeo.normalize_points(xyz)
    target = cfg.target_face_num
    kw = dict(refine_iters=cfg.refine_vertex_iters,
              screen_weight=cfg.spr_screen_weight, iso_method="tets")
    timer = StageTimer(None, sync=True)
    t0 = time.perf_counter()
    v, f = pgeo.reconstruct_mesh(xyz_n, "SPR", cfg.grid_res, target,
                                 device=dev, timer=timer, **kw)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_cpu, f_cpu = pgeo.reconstruct_mesh(xyz_n, "SPR", cfg.grid_res, target,
                                         device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    dist, outward = mesh_vs_cube(v, f, xyz_n)
    tv, tf = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    cv = torch.as_tensor(v_cpu, device=dev)
    cf = torch.as_tensor(f_cpu, device=dev)
    chamfer = 0.5 * float(to_surface(tv, cv, cf).mean()
                          + to_surface(cv, tv, tf).mean())
    print(f"[tets] reconstruct_mesh(SPR, {cfg.grid_res}, {target}, tets) "
          f"{t_card:.3f} s on the card "
          f"{json.dumps({k: round(x, 4) for k, x in timer.times.items()})}, "
          f"{t_cpu:.2f} s on the host; {len(v)} vertices {len(f)} faces "
          f"({len(f_cpu)} on the CPU); distance to the cube mean "
          f"{dist.mean():.5f} (marching cubes, phase 5: {spr_dist:.5f}) p95 "
          f"{np.percentile(dist, 95):.5f}; outward {outward:.5f}; chamfer to "
          f"the CPU mesh {chamfer:.3g}")
    if not 0.8 * target <= len(f) <= target:
        fail(f"tets: {len(f)} faces, not within 0.8-1.0 x {target}")
    if not (dist.mean() < 0.01 and outward >= 0.99 and chamfer <= 1e-3):
        fail(f"tets: distance {dist.mean()}, outward {outward}, chamfer "
             f"{chamfer}")

    # marching tets on the card and on the host from the same field, then
    # the clustering decimation of each
    normals = osdf.estimate_oriented_normals(xyz_n, device=dev)
    pts01 = (xyz_n - pgeo.GRID_LO) / (pgeo.GRID_HI - pgeo.GRID_LO)
    field = osdf.poisson_indicator_grid(
        torch.as_tensor(pts01, device=dev),
        torch.as_tensor(normals, device=dev), res=cfg.grid_res,
        screen_weight=cfg.spr_screen_weight)
    axis = np.linspace(pgeo.GRID_LO, pgeo.GRID_HI, cfg.grid_res,
                       dtype=np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vc, fc, kc = oiso.marching_tets(field, axis, return_edge_keys=True)
    t_mt = time.perf_counter() - t0
    vh, fh, kh = oiso.marching_tets(field.cpu(), axis, return_edge_keys=True)
    same_mt = (fc.shape == fh.shape and (fc == fh).all()
               and (kc == kh).all())
    dv = float(np.abs(vc - vh).max()) if same_mt else float("nan")
    vc, fc = pgeo.largest_component(vc, fc)
    vh, fh = pgeo.largest_component(vh, fh)
    t0 = time.perf_counter()
    dc = pgeo.decimate_vertex_clustering(vc, fc, target)
    t_cl = time.perf_counter() - t0
    dh = pgeo.decimate_vertex_clustering(vh, fh, target)
    same_cl = (dc[1].shape == dh[1].shape and (dc[1] == dh[1]).all()
               and (dc[0] == dh[0]).all())
    print(f"[tets] marching_tets on the card {t_mt:.4f} s: {len(fc)} faces, "
          f"the CPU's on the same field equal: {same_mt} (vertices max |d| "
          f"{dv:.3g}); decimate_vertex_clustering {len(fc)} -> "
          f"{len(dc[1])} faces in {t_cl:.3f} s, equal to the CPU's: "
          f"{same_cl}")
    if not (same_mt and dv <= 1e-6 and same_cl):
        fail("tets: the card's marching tets or clustering differ from "
             "the CPU's")

    t0 = time.perf_counter()
    rc = osdf.refine_orientation_by_visibility(xyz_n, normals, device=dev)
    t_rf = time.perf_counter() - t0
    rh = osdf.refine_orientation_by_visibility(xyz_n, normals, device="cpu")
    sc, sh = np.sign((rc * normals).sum(1)), np.sign((rh * normals).sum(1))
    agree = float((sc == sh).mean())
    print(f"[tets] refine_orientation_by_visibility on {len(xyz_n)} points "
          f"{t_rf:.3f} s: {int((sc < 0).sum())} normals flipped; signs "
          f"agree with the CPU run's at {agree:.5f} (bound 0.999)")
    if not agree >= 0.999:
        fail(f"refine_orientation_by_visibility: card and CPU agree at "
             f"{agree}")


# ---- phase 11: the rest of diffusion and NKSR --------------------------

# (width, height) of the restore's inputs: a short side >= 512 takes the
# BOX halving before the BICUBIC scale, the odd sizes the BICUBIC alone
RESTORE_SIZES = ((700, 520), (1030, 600), (512, 777), (640, 512),
                 (300, 260), (257, 301), (333, 291), (401, 389))
# the public 256x256 classifier's widths (the defaults of the JAX package's
# convert_encoder_state_dict): width 128, depth 2, attention at ds 8/16/32
# with 64-channel heads, 1000 classes, attention pool
CLASSIFIER_256 = dict(model_channels=128, out_channels=1000,
                      pool="attention", image_size=256)
# the tiny UNet of the card-against-CPU checks (fp32)
TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_ds=(2,), num_head_channels=16)


def _perturbed(model, seed: int, scale: float = 0.05):
    """`model` (on the CPU) with seeded random init plus noise on every
    parameter, so that no layer is its zero init."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * scale)
    return model.eval()


def restore_phase(dev, work: str, bf16_inpaint: float, steps: int = 100,
                  batch: int = 8) -> None:
    """Phase 11 (a): cli/ddnm_restore in dataset mode (IMAGENET
    preprocessing, sr4) over 8 synthetic PNGs of mixed sizes on the seeded
    random 552.8M bf16 UNet: K2 = 16 x steps launches, 8 finite outputs in
    [0, 1], the restored and the degraded PNGs; seconds beside phase 4's
    inpaint."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.cli import ddnm_restore
    from pointdreamer_tpu_torch.models.diffusion import svd_ops

    src = os.path.join(work, "restore")
    out = os.path.join(work, "restore_out")
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(RESTORE_SIZES):
        yy, xx = np.mgrid[0:h, 0:w] / max(w, h)
        img = np.stack([0.5 + 0.4 * np.sin(6 * xx + i), 0.5 + 0.4 * np.cos(
            5 * yy), 0.5 + 0.3 * np.sin(4 * (xx + yy))], -1)
        img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1)
        pio.save_rgb(img, os.path.join(src, f"img{i}.png"))
    runs = []
    plain = svd_ops.ddnm_plus_sample

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain(*a, **k)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, y))
        return y

    svd_ops.ddnm_plus_sample = timed
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        ddnm_restore.main(["--image_dir", src, "--dataset", "IMAGENET",
                           "--deg", "sr4", "--batch", str(batch),
                           "--steps", str(steps), "--out", out])
    finally:
        svd_ops.ddnm_plus_sample = plain
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ys = torch.cat([y for _, y in runs]) if runs else torch.zeros(0)
    finite = bool(torch.isfinite(ys).all())
    lo, hi = (float(ys.min()), float(ys.max())) if ys.numel() else (0, 0)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    want = sorted(f"img{i}{s}.png" for i in range(len(RESTORE_SIZES))
                  for s in ("", "_degraded"))
    shapes = {pio.load_png(os.path.join(out, f)).shape for f in files}
    print(f"[restore] ddnm_restore --dataset IMAGENET --deg sr4 --batch "
          f"{batch} --steps {steps} over {len(RESTORE_SIZES)} PNGs "
          f"{list(RESTORE_SIZES)}: {wall:.3f} s (the sampler "
          f"{sum(t for t, _ in runs):.3f} s over {len(runs)} batch(es); "
          f"phase 4's inpaint, 8 views at 256^2 x 100 steps: "
          f"{bf16_inpaint:.4f} s); launches {json.dumps(launches)}; outputs "
          f"{tuple(ys.shape)} finite {finite} in [{lo:.4f}, {hi:.4f}]; "
          f"{len(files)} PNGs {sorted(shapes)}")
    if launches.get("attention_qkv") != 16 * steps:
        fail(f"restore: K2 launched {launches.get('attention_qkv')} times, "
             f"not {16 * steps}")
    if not (ys.shape[0] == len(RESTORE_SIZES) and finite and lo >= 0
            and hi <= 1):
        fail(f"restore: outputs {tuple(ys.shape)}, finite {finite}, range "
             f"[{lo}, {hi}]")
    if files != want or shapes != {(256, 256, 3)}:
        fail(f"restore: wrote {files} of shapes {shapes}")


def operators_phase(dev) -> None:
    """Phase 11 (b): ddnm_plus_sample on the card against the port's CPU
    run for every --deg of the CLI at sigma_y 0 and 0.05: a tiny fp32 UNet
    at 32^2 (batch 2), the same injected draws, 10 steps; within 1e-4 of
    the largest value."""
    import copy

    import torch

    from pointdreamer_tpu_torch.cli.ddnm_restore import (DEGRADATIONS,
                                                         degradation)
    from pointdreamer_tpu_torch.models.diffusion import svd_ops
    from pointdreamer_tpu_torch.models.diffusion.unet import (UNetModel,
                                                              init_random_)

    cpu_m = _perturbed(init_random_(UNetModel(**TINY_UNET), 0), 1)
    card_m = copy.deepcopy(cpu_m).to(dev)
    B, S, T = 2, 32, 10
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((B, S, S, 3), generator=gen) * 2 - 1
    noise = torch.randn((1 + T, B, S, S, 3), generator=gen)
    errs = {}
    t0 = time.perf_counter()
    for deg in DEGRADATIONS:
        for sy in (0.0, 0.05):
            res = []
            for d, m in (("cpu", cpu_m), (dev, card_m)):
                op = degradation(deg, S, S, 1234, d)
                res.append(svd_ops.ddnm_plus_sample(
                    m, op.A(x.to(d)), op, sigma_y=sy, t_sampling=T,
                    noise=noise.to(d)).cpu())
            errs[deg, sy] = float((res[1] - res[0]).abs().max()
                                  / res[0].abs().max())
    worst = max(errs, key=errs.get)
    print(f"[operators] {len(DEGRADATIONS)} degradations x sigma_y {{0, "
          f"0.05}}, tiny fp32 UNet at {S}^2, {T} steps, card against CPU "
          f"on the same draws: max |d| / max |cpu| worst {errs[worst]:.3g} "
          f"({worst[0]}, sigma_y {worst[1]}), all "
          + json.dumps({f"{k[0]}@{k[1]}": round(v, 9)
                        for k, v in errs.items()})
          + f" in {time.perf_counter() - t0:.2f} s")
    if not errs[worst] <= 1e-4:
        fail(f"operators: {worst} card vs CPU {errs[worst]} (bound 1e-4)")


# K2 at the 256x256 classifier's attention shapes: (T, heads, launches a
# forward), hd 64 (levels ds 8, 16, 32 and the middle block)
ENCODER_K2 = ((1024, 4, 2), (256, 8, 2), (64, 8, 3))


def encoder_attention_row(dev, gen) -> dict:
    """K2 against its plain version at the classifier's shapes (bf16,
    batch 8): within one bf16 ulp of the largest output; ms through the
    wrapper and on the device (CUDA graph), SDPA's, the bound.  Returns the
    kernel table row (summed over one forward's 7 launches)."""
    import torch
    import torch.nn.functional as F_

    from pointdreamer_tpu_torch.kernels import BF16_OPS_PER_S
    from pointdreamer_tpu_torch.models.diffusion.attention import (
        attention_qkv, attention_qkv_plain)

    row = dict(name="attention_qkv_encoder", route="cuda",
               source="pointdreamer_tpu_torch/csrc/attention.cu",
               replaces="pointdreamer_tpu/kernels/attention_pallas.py:97",
               max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
               library_ms=0.0, library_device_ms=0.0)
    by = ops = 0.0
    for T, heads, n in ENCODER_K2:
        B, C = 8, heads * 64
        qkv = torch.randn((B, T, 3 * C), generator=gen, device=dev,
                          dtype=torch.float32).to(torch.bfloat16)
        out = attention_qkv(qkv, heads)
        ref = attention_qkv_plain(qkv, heads)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ulp = float(bf16_ulp(ref.float().abs().max()))
        if not err <= ulp:
            fail(f"K2 encoder T={T} heads={heads}: max abs err {err}, one "
                 f"bf16 ulp of max |out| {ulp}")
        q, k, v = qkv.reshape(B, T, heads, 3, 64).permute(3, 0, 2, 1, 4)
        ms = cuda_ms(lambda: attention_qkv(qkv, heads))
        pms = cuda_ms(lambda: attention_qkv_plain(qkv, heads), reps=3)
        lms = cuda_ms(lambda: F_.scaled_dot_product_attention(q, k, v))
        gms = graph_ms(lambda: attention_qkv(qkv, heads))
        glms = graph_ms(lambda: F_.scaled_dot_product_attention(q, k, v))
        b_x = B * T * 3 * C * 2 + B * T * C * 2
        o_x = 4.0 * B * heads * T * T * 64
        b_ms, b_by = bound(b_x, o_x, BF16_OPS_PER_S)
        print(f"[K2 attention_qkv] classifier B={B} T={T} heads={heads} "
              f"max_abs_err={err:.3g} (one bf16 ulp of max |out|: {ulp:.3g})"
              f" ms={ms:.4f} device_ms={gms:.4f} plain_ms={pms:.4f} "
              f"sdpa_ms={lms:.4f} sdpa_device_ms={glms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) x{n} per forward")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, val in (("ms", ms), ("device_ms", gms), ("plain_ms", pms),
                         ("library_ms", lms), ("library_device_ms", glms)):
            row[key] += n * val
        by += n * b_x
        ops += n * o_x
    row["bound_ms"], row["bound_by"] = bound(by, ops, BF16_OPS_PER_S)
    print(f"[K2 attention_qkv] classifier, per forward (7 launches): "
          f"ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
          f"sdpa_device_ms={row['library_device_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    return row


def models_phase(dev, gen, table: list, B: int = 8,
                 side: int = 256) -> None:
    """Phase 11 (c): one timed forward each at batch 8 on the card (the
    classifier at the public 256x256 classifier's widths, attention pool,
    at 256^2; SuperRes over the 552.8M torso, 64^2 -> 256^2, both bf16;
    the DDPM UNet at celeba_plan, fp32, 256^2) with K2's launches (7, 16,
    0); K2 at the classifier's shapes (a kernel table row); each model at
    a tiny width, card against CPU, within 1e-4 of the largest output."""
    import copy

    import torch

    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.models import diffusion as D
    from pointdreamer_tpu_torch.models.diffusion.unet import init_random_

    row = encoder_attention_row(dev, gen)
    x = torch.randn((B, side, side, 3), generator=gen, device=dev)
    low = torch.rand((B, side // 4, side // 4, 3), generator=gen, device=dev)
    t = torch.full((B,), 500.0, device=dev)
    cases = (
        ("classifier", 7, lambda: D.build_unet(
            dev, cls=D.EncoderUNetModel,
            model_kwargs=CLASSIFIER_256), lambda m: m(x, t)),
        ("superres", 16, lambda: D.build_unet(dev, cls=D.SuperResModel),
         lambda m: m(x, t, low)),
        ("ddpm", 0, lambda: D.build_ddpm_unet(D.celeba_plan(), dev),
         lambda m: m(x, t)))
    for name, want_k2, build, call in cases:
        model = build()
        n_params = sum(p.numel() for p in model.parameters())
        with torch.no_grad():
            kernels.reset_launches()
            y = call(model)
            torch.cuda.synchronize()
            k2 = kernels.LAUNCHES["attention_qkv"]
            ms = cuda_ms(lambda: call(model), reps=5, warmup=1)
        ok = bool(torch.isfinite(y).all())
        print(f"[models] {name}: {n_params} parameters, batch {B}, output "
              f"{tuple(y.shape)} finite {ok}; forward {ms:.3f} ms; K2 "
              f"launches {k2} (want {want_k2}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if k2 != want_k2 or not ok:
            fail(f"{name}: K2 launched {k2} times (want {want_k2}), finite "
                 f"{ok}")
        if name == "classifier":
            row["launches"] = k2
        del model, y
        torch.cuda.empty_cache()
    table.append(row)

    # tiny widths, card against CPU (fp32; K2's fp32 path on the card)
    gc = torch.Generator().manual_seed(3)
    xs = torch.randn((2, 16, 16, 3), generator=gc)
    lows = torch.rand((2, 8, 8, 3), generator=gc)
    ts = torch.tensor([10.0, 700.0])
    tiny = (
        ("classifier", init_random_(D.EncoderUNetModel(
            **TINY_UNET, out_channels=10, pool="attention", image_size=16)),
         lambda m, d: m(xs.to(d), ts.to(d))),
        ("superres", init_random_(D.SuperResModel(**TINY_UNET)),
         lambda m, d: m(xs.to(d), ts.to(d), lows.to(d))),
        ("ddpm", D.init_ddpm_(D.DDPMUNet(D.DDPMPlan(
            ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16))), lambda m, d: m(xs.to(d), ts.to(d))))
    for name, cpu_m, call in tiny:
        cpu_m = _perturbed(cpu_m, 4)
        card_m = copy.deepcopy(cpu_m).to(dev)
        with torch.no_grad():
            want = call(cpu_m, "cpu")
            got = call(card_m, dev).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        print(f"[models] {name} at a tiny width, card against CPU: max |d| /"
              f" max |cpu| {rel:.3g} (bound 1e-4)")
        if not rel <= 1e-4:
            fail(f"{name}: card vs CPU {rel}")


def nksr_phase(dev, ply_alone: str, work: str, spr_dist: float) -> None:
    """Phase 11 (d): recon_one_shape_NKSR at its defaults (4,096 centres,
    grid 128, mise_iter 2) on the cloud alone on the card (after a small
    warm-up), timed, its distance to the cube beside phase 5's SPR mesh,
    each stage's seconds, the QEM of its mesh to 10,000 faces; the card
    against the port's CPU path at grid 64 (the two meshes
    within a chamfer of 1e-3; the CPU reference at the defaults took 85-146
    s of the script's limit); then cli/geometry_table --backends NKSR once
    on the card."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.baselines.nksr import recon_one_shape_NKSR
    from pointdreamer_tpu_torch.cli import geometry_table
    from pointdreamer_tpu_torch.log import StageTimer
    from pointdreamer_tpu_torch.ops import qem
    from pointdreamer_tpu_torch.pipeline.geometry import normalize_points

    compare_grid = 64
    xyz, rgb = pio.read_ply_xyzrgb(ply_alone)
    xyz_n, _, _ = normalize_points(xyz)
    rgb01 = rgb.astype(np.float32) / 255.0
    recon_one_shape_NKSR(xyz_n, rgb01, grid_res=32, device=dev)  # warm-up
    timers = {}
    meshes = {}
    for what, d, grid in (("card, defaults", dev, 128),
                          (f"card, grid {compare_grid}", dev, compare_grid),
                          (f"CPU, grid {compare_grid}", "cpu",
                           compare_grid)):
        timers[what] = StageTimer(None, sync=True)
        t0 = time.perf_counter()
        meshes[what] = recon_one_shape_NKSR(xyz_n, rgb01, grid_res=grid,
                                            device=d, timer=timers[what])
        torch.cuda.synchronize()
        timers[what].times["wall"] = time.perf_counter() - t0
    v, f, c = meshes["card, defaults"]
    (vg, fg, cg), (vc, fc, cc) = (meshes[f"card, grid {compare_grid}"],
                                  meshes[f"CPU, grid {compare_grid}"])
    tv, tf = torch.as_tensor(vg, device=dev), torch.as_tensor(fg, device=dev)
    cv, cf = torch.as_tensor(vc, device=dev), torch.as_tensor(fc, device=dev)
    chamfer = 0.5 * float(to_surface(tv, cv, cf).mean()
                          + to_surface(cv, tv, tf).mean())
    dist, outward = mesh_vs_cube(v, f, xyz_n)
    t0 = time.perf_counter()
    _, fq = qem.simplify(v, f, 10000)
    t_qem = time.perf_counter() - t0

    def colours_ok(col):
        # inverse-distance weights summing to one, in fp32
        return col is not None and bool(np.isfinite(col).all()) and \
            float(col.min()) >= -1e-6 and float(col.max()) <= 1 + 1e-6

    ok_col = colours_ok(c) and colours_ok(cg)
    for what, timer in timers.items():
        print(f"[nksr] recon_one_shape_NKSR, {what}: " + json.dumps(
            {k: round(s, 4) for k, s in timer.times.items()}))
    same = fg.shape == fc.shape and bool((fg == fc).all())
    print(f"[nksr] card mesh at the defaults {len(v)} vertices {len(f)} "
          f"faces; at grid {compare_grid} card {len(fg)} / CPU {len(fc)} "
          f"faces, same faces {same}, chamfer card to CPU {chamfer:.3g} "
          f"(bound 1e-3); distance to the cube mean {dist.mean():.5f} p95 "
          f"{np.percentile(dist, 95):.5f} (SPR, phase 5: {spr_dist:.5f}); "
          f"outward {outward:.5f}; colours in [0, 1] {ok_col}; the QEM of "
          f"the card's mesh to {len(fq)} faces {t_qem:.3f} s")
    if not (len(f) and len(fg) and chamfer < 1e-3 and ok_col):
        fail(f"nksr: {len(f)} / {len(fg)} faces, chamfer {chamfer}, "
             f"colours {ok_col}")

    data = os.path.join(work, "in_nksr")
    os.makedirs(data, exist_ok=True)
    shutil.copy(ply_alone, os.path.join(data, "cube.ply"))
    out = os.path.join(work, "geom_nksr.json")
    t0 = time.perf_counter()
    geometry_table.main(["--data", data, "--backends", "NKSR", "--out", out])
    row = json.load(open(out))["cube"]["NKSR"]
    print(f"[nksr] geometry_table --backends NKSR on the card "
          f"{time.perf_counter() - t0:.3f} s: {json.dumps(row)}")
    if not (0 < row["n_faces"] <= 10000
            and all(np.isfinite(v) for v in row.values())):
        fail(f"geometry_table NKSR row {row}")


def _state_equal(a, b) -> bool:
    return all(torch_equal(a[k], b[k]) for k in a)


def torch_equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and bool(torch.equal(x, y))


def _max_diff(a, b) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a) if a else 0.0


def multidevice_phase(dev, work: str, views_dir: str, steps: int = 100,
                      fit_steps: int = 10) -> None:
    """Phase 12 (a): the multi-device paths at world size 1 through NCCL
    (one process on the one card, a tcp://127.0.0.1 store): the 552.8M
    bf16 UNet's DDNMInpainter with and without make_mesh(1) on phase 4's
    8 sparse views (the config's res, 256^2), 100 steps; POCO's fit at phase 7's shape
    (hidden 64, batch 4 x 1,024 points, 512 queries) 2 x `fit_steps`
    steps with and without the mesh.  Each pair must be bit-equal; when a
    pair is not, the mesh-less run is repeated: a mesh-less path that
    reproduces itself makes the difference the mesh's (a failure), one
    that does not bounds it by its own spread (printed).  Prints the NCCL
    collectives and K2's launches of the mesh run."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.models.diffusion import (DDNMInpainter,
                                                         build_unet)
    from pointdreamer_tpu_torch.models.occupancy import train as otrain
    from pointdreamer_tpu_torch.models.occupancy.convert import init_params
    from pointdreamer_tpu_torch.models.occupancy.network import \
        network_from_tree
    from pointdreamer_tpu_torch.models.occupancy.synthetic import \
        batch_iterator
    from pointdreamer_tpu_torch.parallel import mesh as pmesh

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = pmesh.make_mesh(1)
        print(f"[multidevice] backend {dist.get_backend()}, world 1, mesh "
              f"{mesh.shape}")
        imgs = torch.as_tensor(np.stack([
            pio.load_rgb(os.path.join(views_dir, f"{i}_sparse.png"))
            for i in range(8)]), device=dev)
        masks = (imgs.amax(-1) > 0).float()
        t0 = time.perf_counter()
        unet = build_unet(dev, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"[multidevice] 552.8M bf16 UNet built in "
              f"{time.perf_counter() - t0:.2f} s; views "
              f"{tuple(imgs.shape)}, known pixels "
              f"{float(masks.mean()):.4f}")

        def inpaint(m):
            kernels.reset_launches()
            pmesh.reset_collectives()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = DDNMInpainter(unet, steps, mesh=m).inpaint(imgs, masks)
            torch.cuda.synchronize()
            return (out, time.perf_counter() - t0, dict(kernels.LAUNCHES),
                    dict(pmesh.COLLECTIVES))

        base, t_base, l_base, _ = inpaint(None)
        got, t_mesh, l_mesh, c_mesh = inpaint(mesh)
        same = torch_equal(got, base)
        print(f"[multidevice] DDNMInpainter {tuple(imgs.shape[:3])}, "
              f"{steps} steps: "
              f"{t_base:.3f} s without a mesh, {t_mesh:.3f} s with "
              f"make_mesh(1); K2 launches {l_base['attention_qkv']} / "
              f"{l_mesh['attention_qkv']}; NCCL collectives of the mesh run "
              f"{c_mesh}; bit-equal {same}")
        if l_mesh["attention_qkv"] != 16 * steps:
            fail(f"K2 launched {l_mesh['attention_qkv']} times on the world-1"
                 f" dp path, not {16 * steps}")
        if c_mesh.get("all_gather.dp") != 1:
            fail(f"the world-1 dp path launched {c_mesh}, not one all_gather")
        if not same:
            again = inpaint(None)[0]
            spread = float((again.float() - base.float()).abs().max())
            diff = float((got.float() - base.float()).abs().max())
            print(f"[multidevice] DDNM with the mesh differs by {diff}; the "
                  f"mesh-less run against itself by {spread}")
            if spread == 0.0 or diff > 4 * spread:
                fail("DDNMInpainter(mesh=make_mesh(1)) is not the mesh-less "
                     "run")
        del unet, base, got
        torch.cuda.empty_cache()

        tree = init_params(seed=0, hidden=64)

        def fit(m):
            net = network_from_tree(tree, device=dev)
            pmesh.reset_collectives()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, hist = otrain.fit(net, batch_iterator(5, 4, 1024, 512, 0.005),
                                 epochs=2, steps_per_epoch=fit_steps,
                                 lr=1e-3, mesh=m)
            torch.cuda.synchronize()
            return ({k: v.detach().clone() for k, v in
                     net.state_dict().items()}, hist,
                    time.perf_counter() - t0, dict(pmesh.COLLECTIVES))

        a, h_a, t_a, _ = fit(None)
        b, h_b, t_b, c_b = fit(mesh)
        same = _state_equal(a, b) and h_a == h_b
        print(f"[multidevice] POCO fit 2 x {fit_steps} steps (captured): "
              f"{t_a:.3f} s without a mesh, {t_b:.3f} s with make_mesh(1) "
              f"(the gradients' all_reduce between two graphs); losses "
              f"{[round(h['loss'], 6) for h in h_b]}; NCCL collectives "
              f"{c_b}; bit-equal {same}")
        if c_b.get("all_reduce.dp") != 2 * fit_steps + 2 \
                or c_b.get("broadcast.dp") != 1:
            fail(f"fit(mesh=make_mesh(1)) launched {c_b}")
        if not same:
            a2 = fit(None)[0]
            spread, diff = _max_diff(a, a2), _max_diff(a, b)
            print(f"[multidevice] fit with the mesh differs by {diff}; the "
                  f"mesh-less fit against itself by {spread}")
            if spread == 0.0 or diff > 4 * spread:
                fail("fit(mesh=make_mesh(1)) is not the mesh-less fit")
    finally:
        dist.destroy_process_group()


def host_tools_phase(dev, work: str, views_dir: str) -> None:
    """Phase 12 (b): the committed JPEG fixtures against their committed
    PIL decodes (bit for bit), a cloud sampled from phase 4's exported OBJ
    on the card against the CPU (1e-5), phase 4's mesh written as GLB and
    read back, a sheet of phase 4's views and the cloud's three views."""
    import numpy as np

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import vis
    from pointdreamer_tpu_torch.data import sample_from_obj
    from pointdreamer_tpu_torch.mesh import Mesh, read_glb

    t0 = time.perf_counter()
    fx = os.path.join(REPO, "tests", "data", "jpeg")
    names = sorted(f[:-4] for f in os.listdir(fx) if f.endswith(".jpg"))
    for n in names:
        got = pio.load_rgb_uint8(os.path.join(fx, n + ".jpg"))
        want = pio.load_png(os.path.join(fx, n + ".png"))
        if not (got.shape == want.shape and (got == want).all()):
            fail(f"JPEG fixture {n}: the decode is not PIL's")
    t_jpeg = time.perf_counter() - t0
    print(f"[host tools] {len(names)} JPEG fixtures {names} decode bit-equal "
          f"to their PIL decodes in {t_jpeg:.3f} s")
    if len(names) < 5:
        fail(f"JPEG fixtures {names}")

    obj = os.path.join(os.path.dirname(views_dir), "models",
                       "model_normalized.obj")
    t1 = time.perf_counter()
    card = sample_from_obj(obj, 30000, 0, device=dev)
    t_card = time.perf_counter() - t1
    cpu = sample_from_obj(obj, 30000, 0, device="cpu")
    for k in ("coords", "normals", "uvs"):
        if not (card[k] == cpu[k]).all():
            fail(f"sampled {k}: card and CPU differ")
    d_col = float(np.abs(card["colors"] - cpu["colors"]).max())
    print(f"[host tools] 30000 points sampled from {obj} on the card in "
          f"{t_card:.3f} s: colours within {d_col:.3g} of the CPU's")
    if not d_col <= 1e-5:
        fail(f"sampled colours differ by {d_col}")

    out = os.path.join(work, "phase12")
    m = Mesh.load(obj)
    glb = os.path.join(out, "mesh.glb")
    m.write(glb)
    gltf, binary = read_glb(glb)
    back = Mesh.load(glb)
    same_tris = bool((back.vertices[back.faces]
                      == m.vertices[m.faces].astype(np.float32)).all())
    tex8 = (np.clip(m.texture, 0, 1) * 255).astype(np.uint8)
    same_tex = bool((np.rint(back.texture * 255).astype(np.uint8)
                     == tex8).all())
    print(f"[host tools] GLB {os.path.getsize(glb)} bytes: "
          f"{len(gltf['accessors'])} accessors, "
          f"{len(gltf['bufferViews'])} views, BIN {len(binary)} bytes, "
          f"{len(back.faces)} faces; triangles {same_tris}, texture "
          f"{same_tex}")
    if not (same_tris and same_tex and len(back.faces) == len(m.faces)):
        fail("the GLB does not read back as the mesh")

    views = [pio.load_rgb(os.path.join(views_dir, f"{i}_inpainted.png"))
             for i in range(8)]
    sheet = vis.save_image_sheet(views, os.path.join(out, "views.png"),
                                 titles=[f"view {i}" for i in range(8)])
    pc = vis.save_pointcloud_views(card["coords"], card["colors"],
                                   os.path.join(out, "cloud.png"))
    print(f"[host tools] sheet {sheet.shape}, cloud views {pc.shape}; phase "
          f"12 (b) {time.perf_counter() - t0:.2f} s")
    for f in ("views.png", "cloud.png"):
        if pio.load_png(os.path.join(out, f)).shape[:2] \
                != (sheet if f == "views.png" else pc).shape[:2]:
            fail(f"{f} was not written")


# ---- phase 13: image input (WebP, progressive JPEG) -----------------------

# the restore folder's 8 fixtures: (directory under tests/data, name, ext)
RESTORE_FIXTURES = (("webp", "lossy", ".webp"),
                    ("webp", "lossless_palette", ".webp"),
                    ("webp", "lossless_noisy", ".webp"),
                    ("webp", "alpha_lossy", ".webp"),
                    ("webp", "raw_alpha", ".webp"),
                    ("webp", "animated", ".webp"),
                    ("jpeg", "prog_420", ".jpg"),
                    ("jpeg", "prog_restart", ".jpg"))


def host_cpu_model() -> str:
    """The host CPU's model name (lscpu, else /proc/cpuinfo) and its
    architecture."""
    import platform

    name = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.strip().startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                k, _, v = ln.partition(":")
                fields.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    if not name or name == "unknown":
        name = fields.get("model name", "unknown")
    # a virtualised host may hide the name: the vendor, family, model and clock
    # still identify the part
    ident = ", ".join(f"{k} {fields[k]}" for k in
                      ("vendor_id", "cpu family", "model", "cpu MHz")
                      if k in fields)
    return f"{name} ({ident}; {platform.machine()}, {os.cpu_count()} " \
        "logical CPUs)"


def image_input_phase(dev, work: str, steps: int = 100,
                      batch: int = 8) -> None:
    """Phase 13: the committed WebP and progressive-JPEG fixtures against
    their PIL decodes, the restore CLI over a folder of them, and the
    decode times of the 512x384 timing fixtures."""
    import hashlib

    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.cli import ddnm_restore
    from pointdreamer_tpu_torch.models.diffusion import datasets, svd_ops

    data = os.path.join(REPO, "tests", "data")
    # (a) fixtures, bit for bit
    fixtures = [("webp", f[:-5], ".webp") for f in sorted(os.listdir(
        os.path.join(data, "webp"))) if f.endswith(".webp")]
    fixtures += [("jpeg", f[:-4], ".jpg") for f in sorted(os.listdir(
        os.path.join(data, "jpeg"))) if f.startswith("prog_")
        and f.endswith(".jpg")]
    secs = {".webp": 0.0, ".jpg": 0.0}
    for sub, name, ext in fixtures:
        t0 = time.perf_counter()
        # the WebP PNGs hold Image.open's pixels, the JPEG ones convert("RGB")
        load = pio.load_image if ext == ".webp" else pio.load_rgb_uint8
        got = load(os.path.join(data, sub, name + ext))
        secs[ext] += time.perf_counter() - t0
        want = pio.load_png(os.path.join(data, sub, name + ".png"))
        if not (got.shape == want.shape and (got == want).all()):
            fail(f"image fixture {sub}/{name}{ext}: the decode is not PIL's")
    n_webp = sum(ext == ".webp" for _, _, ext in fixtures)
    print(f"[image input] {n_webp} WebP fixtures decode bit-equal to their "
          f"PIL decodes in {secs['.webp']:.3f} s, "
          f"{len(fixtures) - n_webp} progressive JPEG fixtures in "
          f"{secs['.jpg']:.3f} s (host)")
    if n_webp < 7 or len(fixtures) - n_webp < 4:
        fail(f"image fixtures: {fixtures}")

    # (b) the restore CLI over a folder of them
    src = os.path.join(work, "phase13_in")
    out = os.path.join(work, "phase13_out")
    os.makedirs(src, exist_ok=True)
    for sub, name, ext in RESTORE_FIXTURES:
        shutil.copy(os.path.join(data, sub, name + ext),
                    os.path.join(src, name + ext))
    fed, runs = [], []
    plain_batches = datasets.ImageFolderDataset.batches
    plain_sample = svd_ops.ddnm_plus_sample

    def batches(self, batch_size):
        for names, imgs in plain_batches(self, batch_size):
            fed.append((names, imgs))
            yield names, imgs

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain_sample(*a, **k)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, y))
        return y

    datasets.ImageFolderDataset.batches = batches
    svd_ops.ddnm_plus_sample = timed
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        ddnm_restore.main(["--image_dir", src, "--dataset", "IMAGENET",
                           "--deg", "sr4", "--batch", str(batch),
                           "--steps", str(steps), "--out", out])
    finally:
        datasets.ImageFolderDataset.batches = plain_batches
        svd_ops.ddnm_plus_sample = plain_sample
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ref_dir = {sub: os.path.join(data, sub) for sub, _, _ in
               RESTORE_FIXTURES}
    by_stem = {name: sub for sub, name, _ in RESTORE_FIXTURES}
    same = bool(fed)
    for names, imgs in fed:
        want = np.stack([datasets.center_crop_arr(pio.load_rgb_uint8(
            os.path.join(ref_dir[by_stem[os.path.splitext(
                os.path.basename(n))[0]]], os.path.splitext(
                os.path.basename(n))[0] + ".png")), 256).astype(
            np.float32) / 255.0 for n in names])
        same &= imgs.shape == want.shape and bool((imgs == want).all())
    ys = torch.cat([y for _, y in runs]) if runs else torch.zeros(0)
    finite = bool(torch.isfinite(ys).all())
    lo, hi = (float(ys.min()), float(ys.max())) if ys.numel() else (0, 0)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    want_files = sorted(f"{name}{s}.png" for _, name, _ in RESTORE_FIXTURES
                        for s in ("", "_degraded"))
    print(f"[image input] ddnm_restore --dataset IMAGENET --deg sr4 --batch "
          f"{batch} --steps {steps} over {len(RESTORE_FIXTURES)} WebP and "
          f"progressive JPEG fixtures: {wall:.3f} s (the sampler "
          f"{sum(t for t, _ in runs):.3f} s over {len(runs)} batch(es)); "
          f"fed batch equal to the PNG-decoded batch: {same}; launches "
          f"{json.dumps(launches)}; outputs {tuple(ys.shape)} finite "
          f"{finite} in [{lo:.4f}, {hi:.4f}]; {len(files)} PNGs")
    if not same:
        fail("restore: the dataset's batch differs from the batch of the "
             "committed PNG decodes")
    if launches.get("attention_qkv") != 16 * steps:
        fail(f"restore: K2 launched {launches.get('attention_qkv')} times, "
             f"not {16 * steps}")
    if not (ys.shape[0] == len(RESTORE_FIXTURES) and finite and lo >= 0
            and hi <= 1):
        fail(f"restore: outputs {tuple(ys.shape)}, finite {finite}, range "
             f"[{lo}, {hi}]")
    if files != want_files:
        fail(f"restore: wrote {files}")

    # (c) the timing fixtures
    timing = os.path.join(data, "timing")
    for f, what in (("webp_q80_512x384.webp", "lossy WebP (vp8.py)"),
                    ("jpeg_prog_512x384.jpg", "progressive JPEG (jpeg.py)")):
        path = os.path.join(timing, f)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = pio.load_image(path)
            times.append(time.perf_counter() - t0)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        with open(os.path.splitext(path)[0] + ".sha256") as fh:
            want = fh.read().strip()
        same = "matches" if digest == want else "DIFFERS"
        print(f"[image input] {f} {img.shape}: {what} decode "
              f"{sorted(times)[1]:.4f} s (median of 3, host CPU "
              f"{host_cpu_model()}); SHA-256 {same}")
        if digest != want:
            fail(f"{f}: decoded bytes {digest}, committed {want}")


# ---- phase 14: inputs by content (configs, JPEG variants, GIF, TIFF) -----

# the restore folder's 8 fixtures: (directory under tests/data, name, ext)
RESTORE14_FIXTURES = (("jpeg", "cmyk", ".jpg"), ("jpeg", "ycck", ".jpg"),
                      ("jpeg", "arith", ".jpg"),
                      ("jpeg", "arith_prog", ".jpg"),
                      ("jpeg", "smooth", ".jpg"),
                      ("jpeg", "lossless", ".jpg"),
                      ("jpeg", "lossless_grey", ".jpg"),
                      ("png", "png_named", ".JPEG"))
# the JPEG fixtures of this phase (the others are phase 12 b's and 13's)
JPEG14_FIXTURES = ("cmyk", "cmyk_no_adobe", "ycck", "arith", "arith_prog",
                   "smooth", "smooth_dc", "lossless", "lossless_grey")


def _restore_run(argv):
    """ddnm_restore.main(argv) on the card with the dataset's batches and
    the decoder's images recorded and the sampler timed: (fed [(names,
    float images)], runs [(s, outputs)], wall s, launches)."""
    import numpy as np
    import torch

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch import kernels
    from pointdreamer_tpu_torch.cli import ddnm_restore
    from pointdreamer_tpu_torch.models.diffusion import datasets, svd_ops

    fed, runs = [], []
    plain_batches = datasets.ImageFolderDataset.batches
    plain_sample = svd_ops.ddnm_plus_sample
    plain_load_rgb = pio.load_rgb

    def batches(self, batch_size):
        for names, imgs in plain_batches(self, batch_size):
            fed.append((names, imgs))
            yield names, imgs

    def load_rgb(path):
        img = plain_load_rgb(path)
        fed.append(([path], np.asarray(img)[None]))
        return img

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain_sample(*a, **k)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, y))
        return y

    datasets.ImageFolderDataset.batches = batches
    svd_ops.ddnm_plus_sample = timed
    pio.load_rgb = load_rgb
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        ddnm_restore.main(argv)
    finally:
        datasets.ImageFolderDataset.batches = plain_batches
        svd_ops.ddnm_plus_sample = plain_sample
        pio.load_rgb = plain_load_rgb
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return fed, runs, wall, dict(kernels.LAUNCHES)


def _check_restore(what, runs, launches, n_images, steps, files, want,
                   tag: str = "inputs"):
    import torch

    ys = torch.cat([y for _, y in runs]) if runs else torch.zeros(0)
    finite = bool(torch.isfinite(ys).all())
    lo, hi = (float(ys.min()), float(ys.max())) if ys.numel() else (0, 0)
    print(f"[{tag}] {what}: sampler {sum(t for t, _ in runs):.3f} s over "
          f"{len(runs)} batch(es); launches {json.dumps(launches)}; "
          f"outputs {tuple(ys.shape)} finite {finite} in [{lo:.4f}, "
          f"{hi:.4f}]; {len(files)} PNGs")
    if launches.get("attention_qkv") != 16 * steps:
        fail(f"{what}: K2 launched {launches.get('attention_qkv')} times, "
             f"not {16 * steps}")
    if not (ys.shape[0] == n_images and finite and lo >= 0 and hi <= 1):
        fail(f"{what}: outputs {tuple(ys.shape)}, finite {finite}, range "
             f"[{lo}, {hi}]")
    if files != want:
        fail(f"{what}: wrote {files}")


def inputs_phase(dev, work: str, cfg, steps: int = 100,
                 batch: int = 8) -> None:
    """Phase 14: every new input fixture against its committed PIL decode;
    the restore CLI over a folder of the JPEG variants and the PNG named
    .JPEG, and on a 256x256 LZW TIFF and GIF; the config round trip; the
    image operations on the card; the 512x384 timing fixtures."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from pointdreamer_tpu_torch import camera as pcam
    from pointdreamer_tpu_torch import config as pcfg
    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.models.diffusion import datasets
    from pointdreamer_tpu_torch.ops import image as pimg

    data = os.path.join(REPO, "tests", "data")
    # (a) the fixtures, bit for bit: JPEG through convert("RGB") (its PNGs
    # hold that), GIF, TIFF and the PNG named .JPEG through load_image
    fixtures = [("jpeg", n + ".jpg", pio.load_rgb_uint8)
                for n in JPEG14_FIXTURES]
    for sub in ("gif", "tiff"):
        fixtures += [(sub, f, pio.load_image) for f in sorted(os.listdir(
            os.path.join(data, sub))) if not f.endswith(".png")]
    fixtures.append(("png", "png_named.JPEG", pio.load_image))
    secs, counts = {}, {}
    for sub, f, load in fixtures:
        path = os.path.join(data, sub, f)
        with open(path, "rb") as fh:
            kind = pio.image_type(fh.read(16))
        t0 = time.perf_counter()
        got = load(path)
        secs[kind] = secs.get(kind, 0.0) + time.perf_counter() - t0
        counts[kind] = counts.get(kind, 0) + 1
        want = pio.load_png(os.path.splitext(path)[0] + ".png")
        if not (got.size == want.size and (got == want.reshape(
                got.shape)).all()):
            fail(f"input fixture {sub}/{f}: the decode is not PIL's")
    print("[inputs] " + ", ".join(
        f"{counts[k]} {k} in {secs[k]:.3f} s" for k in sorted(secs))
        + " (host), each bit-equal to its committed PIL decode")
    if counts.get("GIF", 0) < 5 or counts.get("TIFF", 0) < 13 \
            or counts.get("JPEG", 0) < 9 or counts.get("PNG") != 1:
        fail(f"input fixtures: {counts}")

    # (b) the restore CLI: a folder of 8, then --image on a TIFF and a GIF
    src = os.path.join(work, "phase14_in")
    os.makedirs(src, exist_ok=True)
    for sub, name, ext in RESTORE14_FIXTURES:
        shutil.copy(os.path.join(data, sub, name + ext),
                    os.path.join(src, name + ext))
    out = os.path.join(work, "phase14_out")
    fed, runs, wall, launches = _restore_run(
        ["--image_dir", src, "--dataset", "IMAGENET", "--deg", "sr4",
         "--batch", str(batch), "--steps", str(steps), "--out", out])
    pngs = {name: os.path.join(data, sub, name + ".png")
            for sub, name, _ in RESTORE14_FIXTURES}
    same = bool(fed)
    for names, imgs in fed:
        want = np.stack([datasets.center_crop_arr(pio.load_rgb_uint8(
            pngs[os.path.splitext(os.path.basename(n))[0]]), 256).astype(
            np.float32) / 255.0 for n in names])
        same &= imgs.shape == want.shape and bool((imgs == want).all())
    print(f"[inputs] ddnm_restore --image_dir over {len(pngs)} fixtures "
          "(CMYK, YCCK, arithmetic, arithmetic progressive, smoothed "
          "progressive, lossless RGB and grey JPEG, a PNG named .JPEG), "
          f"IMAGENET, sr4, batch {batch}, {steps} steps: {wall:.3f} s; fed "
          f"batch equal to the PNG-decoded batch: {same}")
    if not same:
        fail("restore: the dataset's batch differs from the batch of the "
             "committed PNG decodes")
    _check_restore("folder", runs, launches, len(pngs), steps,
                   sorted(os.listdir(out)) if os.path.isdir(out) else [],
                   sorted(f"{n}{s}.png" for n in pngs
                          for s in ("", "_degraded")))
    for sub, f in (("tiff", "restore_256_lzw.tif"),
                   ("gif", "restore_256.gif")):
        path = os.path.join(data, sub, f)
        out_png = os.path.join(work, f"phase14_{sub}", "out.png")
        os.makedirs(os.path.dirname(out_png), exist_ok=True)
        fed, runs, wall, launches = _restore_run(
            ["--image", path, "--dataset", "IMAGENET", "--deg", "sr4",
             "--steps", str(steps), "--out", out_png])
        want = pio.load_png(os.path.splitext(path)[0] + ".png")[..., :3]
        want = want.astype(np.float32)[None] / 255.0
        same = len(fed) == 1 and fed[0][1].shape == want.shape and bool(
            (fed[0][1] == want).all())
        print(f"[inputs] ddnm_restore --image {f} (256x256), sr4, {steps} "
              f"steps: {wall:.3f} s; fed image equal to its PNG decode: "
              f"{same}")
        if not same:
            fail(f"restore --image {f}: the fed image differs from its "
                 "committed PNG decode")
        _check_restore(f, runs, launches, 1, steps,
                       sorted(os.listdir(os.path.dirname(out_png))),
                       ["out.png", "out_degraded.png"])

    # (c) the config round trip, and a file the JAX package wrote
    path = os.path.join(work, "phase14_config.yaml")
    pcfg.save_config(cfg, path)
    back = pcfg.load_config(path)
    saved = os.path.join(data, "config", "jax_saved.yaml")
    want = dataclasses.replace(
        pcfg.load_config(os.path.join(REPO, "configs", "default.yaml")),
        edge_dilate_kernels=[21, 11, 5], exp_name="saved by save_config")
    jax_saved = pcfg.load_config(saved)
    again = os.path.join(work, "phase14_jax_saved.yaml")
    pcfg.save_config(jax_saved, again)
    with open(saved) as a, open(again) as b:
        same_text = a.read() == b.read()
    ok = (dataclasses.asdict(back) == dataclasses.asdict(cfg)
          and dataclasses.asdict(jax_saved) == dataclasses.asdict(want)
          and same_text)
    print(f"[inputs] save_config -> load_config of phase 4's config: "
          f"{dataclasses.asdict(back) == dataclasses.asdict(cfg)}; the "
          "JAX package's saved config (block-style lists) read: "
          f"{dataclasses.asdict(jax_saved) == dataclasses.asdict(want)}, "
          f"written back byte-equal: {same_text}")
    if not ok:
        fail("config: a round trip differs")

    # (d) the image operations on the card against the CPU
    gen = torch.Generator().manual_seed(14)
    mask = (torch.rand(8, 512, 512, generator=gen) < 0.7).float()
    img = torch.rand(8, 256, 256, 3, generator=gen)
    ndc = torch.rand(8, 100_000, 2, generator=gen) * 2.4 - 1.2
    close_cpu = pimg.morph_close(mask, 7)
    bil_cpu = pimg.bilateral_filter(img, 5)
    pix_cpu = pcam.ndc_to_pixels(ndc, 512)
    mask_d, img_d, ndc_d = mask.to(dev), img.to(dev), ndc.to(dev)
    close_d = pimg.morph_close(mask_d, 7)
    bil_d = pimg.bilateral_filter(img_d, 5)
    pix_d = pcam.ndc_to_pixels(ndc_d, 512)
    close_same = bool((close_d.cpu() == close_cpu).all())
    bil_err = float((bil_d.cpu() - bil_cpu).abs().max())
    pix_same = bool((pix_d.cpu() == pix_cpu).all())
    close_ms = cuda_ms(lambda: pimg.morph_close(mask_d, 7))
    bil_ms = cuda_ms(lambda: pimg.bilateral_filter(img_d, 5))
    print(f"[inputs] morph_close k 7 on 8x512^2 (card == CPU: {close_same}; "
          f"{close_ms:.4f} ms), bilateral_filter k 5 on 8x256^2x3 (max "
          f"|card - CPU| {bil_err:.3e}, bound 1e-5; {bil_ms:.4f} ms), "
          f"ndc_to_pixels of 8x100,000 points (card == CPU: {pix_same})")
    if not (close_same and bil_err <= 1e-5 and pix_same):
        fail("image operations: the card differs from the CPU")

    # (e) the 512x384 timing fixtures of the new types
    timing = os.path.join(data, "timing")
    for f, what in (("tiff_lzw_512x384.tif", "LZW TIFF (tiff.py)"),
                    ("gif_512x384.gif", "GIF (gif.py)"),
                    ("jpeg_arith_512x384.jpg",
                     "arithmetic JPEG (jpeg.py)")):
        path = os.path.join(timing, f)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = pio.load_image(path)
            times.append(time.perf_counter() - t0)
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        with open(os.path.splitext(path)[0] + ".sha256") as fh:
            want = fh.read().strip()
        print(f"[inputs] {f} {got.shape}: {what} decode "
              f"{sorted(times)[1]:.4f} s (median of 3, host CPU "
              f"{host_cpu_model()}); SHA-256 "
              f"{'matches' if digest == want else 'DIFFERS'}")
        if digest != want:
            fail(f"{f}: decoded bytes {digest}, committed {want}")


# ---- phase 15: configs and images the port refused or misread -----------

# the fixture folders of this phase under tests/data; each file's PIL
# decode (convert("RGBA")) is `<stem>_pil.png` beside it
READER_DIRS = ("pnm", "tiff_more", "tga", "pcx", "sgi", "qoi", "ico",
               "bilevel", "restore16")
READER_TYPES = {"PNM", "TIFF", "TGA", "PCX", "SGI", "QOI", "ICO", "CUR",
                "DIB", "MSP", "XBM"}


def readers_phase(dev, work: str, steps: int = 100) -> None:
    """Phase 15: every fixture of the new readers against its committed
    PIL decode; the restore CLI over tests/data/restore16 (files only the
    new readers decode, under the dataset's extensions) and --image on a
    256x256 TGA; the configs with anchors, merge keys, block scalars and
    tags against their plain twin."""
    import dataclasses
    import warnings

    import numpy as np

    from pointdreamer_tpu_torch import config as pcfg
    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.models.diffusion import datasets

    data = os.path.join(REPO, "tests", "data")
    # (a) the fixtures, bit for bit, host seconds by type
    t0 = time.perf_counter()
    secs, counts = {}, {}
    bad = []
    for sub in READER_DIRS:
        for f in sorted(os.listdir(os.path.join(data, sub))):
            if f.endswith("_pil.png"):
                continue
            path = os.path.join(data, sub, f)
            with open(path, "rb") as fh:
                kind = pio.image_type(fh.read())
            t1 = time.perf_counter()
            got = pio.load_rgba_uint8(path)
            secs[kind] = secs.get(kind, 0.0) + time.perf_counter() - t1
            counts[kind] = counts.get(kind, 0) + 1
            want = pio.load_png(os.path.join(
                data, sub, os.path.splitext(f)[0] + "_pil.png"))
            if got.shape != want.shape or not (got == want).all():
                bad.append(f"{sub}/{f}")
    print("[readers] " + ", ".join(
        f"{counts[k]} {k} in {secs[k]:.3f} s" for k in sorted(secs))
        + f" (host; {time.perf_counter() - t0:.3f} s in all), each "
        "bit-equal to its committed PIL decode")
    if bad or set(counts) != READER_TYPES:
        fail(f"reader fixtures: {bad} differ; types {sorted(counts)}")

    # (b) the restore CLI: the folder of 8, then --image on a TGA
    src = os.path.join(work, "phase15_in")
    os.makedirs(src, exist_ok=True)
    names = sorted(f for f in os.listdir(os.path.join(data, "restore16"))
                   if not f.endswith("_pil.png"))
    for f in names:
        shutil.copy(os.path.join(data, "restore16", f), os.path.join(src, f))
    out = os.path.join(work, "phase15_out")
    fed, runs, wall, launches = _restore_run(
        ["--image_dir", src, "--dataset", "IMAGENET", "--deg", "sr4",
         "--batch", "8", "--steps", str(steps), "--out", out])
    same = bool(fed)
    for fnames, imgs in fed:
        want = np.stack([datasets.center_crop_arr(pio.load_png(os.path.join(
            data, "restore16", os.path.splitext(os.path.basename(n))[0]
            + "_pil.png"))[..., :3], 256).astype(np.float32) / 255.0
            for n in fnames])
        same &= imgs.shape == want.shape and bool((imgs == want).all())
    kinds = sorted(pio.image_type(open(os.path.join(src, f), "rb").read())
                   for f in names)
    print(f"[readers] ddnm_restore --image_dir over {len(names)} files "
          f"({', '.join(kinds)} under .ppm, .png and .jpg names), IMAGENET, "
          f"sr4, batch 8, {steps} steps: {wall:.3f} s; fed batch equal "
          f"to the PIL-decoded batch: {same}")
    if not same or len(names) != 8:
        fail("restore: the dataset's batch differs from the batch of the "
             "committed PIL decodes")
    _check_restore("folder", runs, launches, len(names), steps,
                   sorted(os.listdir(out)) if os.path.isdir(out) else [],
                   sorted(f"{os.path.splitext(n)[0]}{s}.png" for n in names
                          for s in ("", "_degraded")), tag="readers")
    path = os.path.join(data, "tga", "restore_256.tga")
    out_png = os.path.join(work, "phase15_tga", "out.png")
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    fed, runs, wall, launches = _restore_run(
        ["--image", path, "--dataset", "IMAGENET", "--deg", "sr4",
         "--steps", str(steps), "--out", out_png])
    want = pio.load_png(os.path.join(data, "tga", "restore_256_pil.png"))
    want = want[..., :3].astype(np.float32)[None] / 255.0
    same = len(fed) == 1 and fed[0][1].shape == want.shape and bool(
        (fed[0][1] == want).all())
    print(f"[readers] ddnm_restore --image restore_256.tga (256x256, "
          f"bottom-up TGA), sr4, {steps} steps: {wall:.3f} s; fed image "
          f"equal to its PIL decode: {same}")
    if not same:
        fail("restore --image restore_256.tga: the fed image differs from "
             "its committed PIL decode")
    _check_restore("restore_256.tga", runs, launches, 1, steps,
                   sorted(os.listdir(os.path.dirname(out_png))),
                   ["out.png", "out_degraded.png"], tag="readers")

    # (c) the configs of the YAML reader against their plain twin
    t0 = time.perf_counter()
    cdir = os.path.join(data, "config")
    twin = dataclasses.asdict(pcfg.load_config(os.path.join(
        cdir, "plain_twin.yaml")))
    results = {}
    for f in ("anchors_merge.yaml", "block_scalars_tags.yaml"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = pcfg.load_config(os.path.join(cdir, f))
        try:
            pcfg.load_config(os.path.join(cdir, f), strict=True)
            strict = False
        except KeyError:
            strict = True
        results[f] = (dataclasses.asdict(cfg) == twin, sorted(cfg.extra),
                      strict)
    print(f"[readers] configs against plain_twin.yaml (equal, extra keys, "
          f"strict=True raises): {json.dumps(results)}; "
          f"{time.perf_counter() - t0:.4f} s")
    if not all(eq and strict for eq, _, strict in results.values()):
        fail(f"configs: {results}")



# ---- phase 16: the rest of PIL's readers ---------------------------------

# the fixture folders of this phase under tests/data; each file's PIL
# decode (convert("RGBA")) is `<stem>_pil.png` beside it, and its pixels
# `<stem>_pil.npy` where PNG cannot hold its mode ("F", "I", "I;16*")
REST_DIRS = ("dds", "blp", "psd", "icns", "im", "sci", "xpm", "fli", "sun",
             "dcx", "pcd", "small", "restore17")
REST_TYPES = {"DDS", "FTEX", "BLP", "PSD", "ICNS", "IM", "IMT", "SPIDER",
              "FITS", "XPM", "FLI", "SUN", "DCX", "PCD", "GBR", "MCIDAS",
              "PIXAR", "XVThumb", "IPTC"}
# files PIL identifies and the port refuses: (bytes, type, exception)
REFUSED = (
    (b"\x00\x00\x01\xb3\x02\x00\x18" + bytes(20), "MPEG", OSError),
    (b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(4) + b"\x90\x01\x2c\x01"
     + b"\xa0\x05" + bytes(6) + b"\x01\x00\t\x00" + bytes(18), "WMF",
     OSError),
    (b"BUFR" + bytes(40), "BUFR", OSError),
    (b"GRIB\0\0\0\x01" + bytes(40), "GRIB", OSError),
    (b"\x89HDF\r\n\x1a\n" + bytes(40), "HDF5", OSError),
)


def rest_readers_phase(dev, work: str, steps: int = 100) -> None:
    """Phase 16: every fixture of the rest of PIL's readers against its
    committed PIL decode (and native pixels); the restore CLI over
    tests/data/restore17 (files only these readers decode, under the
    dataset's extensions) and --image on a 256x256 PackBits PSD; the
    identified formats the port refuses."""
    import numpy as np

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.models.diffusion import datasets

    data = os.path.join(REPO, "tests", "data")
    # (a) the fixtures, bit for bit, host seconds by type
    t0 = time.perf_counter()
    secs, counts = {}, {}
    bad = []
    for sub in REST_DIRS:
        for f in sorted(os.listdir(os.path.join(data, sub))):
            if f.endswith(("_pil.png", "_pil.npy")):
                continue
            path = os.path.join(data, sub, f)
            stem = os.path.join(data, sub, os.path.splitext(f)[0])
            with open(path, "rb") as fh:
                raw = fh.read()
            kind = pio.image_type(raw)
            t1 = time.perf_counter()
            img = pio.decode_image(raw, path)
            got = pio.to_rgba(img)
            secs[kind] = secs.get(kind, 0.0) + time.perf_counter() - t1
            counts[kind] = counts.get(kind, 0) + 1
            want = pio.load_png(stem + "_pil.png")
            ok = got.shape == want.shape and bool((got == want).all())
            if os.path.exists(stem + "_pil.npy"):
                px = np.load(stem + "_pil.npy")
                ok &= img.pixels.shape == px.shape and np.array_equal(
                    img.pixels, px, equal_nan=px.dtype.kind == "f")
            if not ok:
                bad.append(f"{sub}/{f}")
    print("[rest] " + ", ".join(
        f"{counts[k]} {k} in {secs[k]:.3f} s" for k in sorted(secs))
        + f" (host; {time.perf_counter() - t0:.3f} s in all), each "
        "bit-equal to its committed PIL decode")
    if bad or set(counts) != REST_TYPES:
        fail(f"rest fixtures: {bad} differ; types {sorted(counts)}")

    # (b) the restore CLI: the folder of 8, then --image on a PSD
    src = os.path.join(work, "phase16_in")
    os.makedirs(src, exist_ok=True)
    names = sorted(f for f in os.listdir(os.path.join(data, "restore17"))
                   if not f.endswith(("_pil.png", "_pil.npy")))
    for f in names:
        shutil.copy(os.path.join(data, "restore17", f), os.path.join(src, f))
    out = os.path.join(work, "phase16_out")
    fed, runs, wall, launches = _restore_run(
        ["--image_dir", src, "--dataset", "IMAGENET", "--deg", "sr4",
         "--batch", "8", "--steps", str(steps), "--out", out])
    same = bool(fed)
    for fnames, imgs in fed:
        want = np.stack([datasets.center_crop_arr(pio.load_png(os.path.join(
            data, "restore17", os.path.splitext(os.path.basename(n))[0]
            + "_pil.png"))[..., :3], 256).astype(np.float32) / 255.0
            for n in fnames])
        same &= imgs.shape == want.shape and bool((imgs == want).all())
    kinds = sorted(pio.image_type(open(os.path.join(src, f), "rb").read())
                   for f in names)
    print(f"[rest] ddnm_restore --image_dir over {len(names)} files "
          f"({', '.join(kinds)} under .png, .jpg, .jpeg, .bmp, .webp and "
          f".ppm names), IMAGENET, sr4, batch 8, {steps} steps: "
          f"{wall:.3f} s; fed batch equal to the PIL-decoded batch: {same}")
    if not same or len(names) != 8:
        fail("restore: the dataset's batch differs from the batch of the "
             "committed PIL decodes")
    _check_restore("folder", runs, launches, len(names), steps,
                   sorted(os.listdir(out)) if os.path.isdir(out) else [],
                   sorted(f"{os.path.splitext(n)[0]}{s}.png" for n in names
                          for s in ("", "_degraded")), tag="rest")
    path = os.path.join(data, "psd", "restore_256.psd")
    out_png = os.path.join(work, "phase16_psd", "out.png")
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    fed, runs, wall, launches = _restore_run(
        ["--image", path, "--dataset", "IMAGENET", "--deg", "sr4",
         "--steps", str(steps), "--out", out_png])
    want = pio.load_png(os.path.join(data, "psd", "restore_256_pil.png"))
    want = want[..., :3].astype(np.float32)[None] / 255.0
    same = len(fed) == 1 and fed[0][1].shape == want.shape and bool(
        (fed[0][1] == want).all())
    print(f"[rest] ddnm_restore --image restore_256.psd (256x256, RGB "
          f"PackBits PSD), sr4, {steps} steps: {wall:.3f} s; fed image "
          f"equal to its PIL decode: {same}")
    if not same:
        fail("restore --image restore_256.psd: the fed image differs from "
             "its committed PIL decode")
    _check_restore("restore_256.psd", runs, launches, 1, steps,
                   sorted(os.listdir(os.path.dirname(out_png))),
                   ["out.png", "out_degraded.png"], tag="rest")

    # (c) the formats identified and refused
    results = {}
    for raw, kind, exc in REFUSED:
        named = pio.image_type(raw)
        try:
            pio.decode_image(raw, "x.png")
            raised = ""
        except exc as e:
            raised = type(e).__name__ if kind in str(e) else ""
        results[kind] = (named, raised)
    print(f"[rest] refused formats (type named, exception naming it): "
          f"{json.dumps(results)}")
    if any(named != kind or not raised
           for kind, (named, raised) in results.items()):
        fail(f"refused formats: {results}")



# ---- phase 17: JPEG 2000 and ZSTD TIFF -----------------------------------

# the fixture folders of this phase under tests/data; each file's PIL
# decode (convert("RGBA")) is `<stem>_pil.png` beside it, and its "I;16"
# pixels `<stem>_pil.npy`
J2K_DIRS = ("jp2", "zstd", "restore18")
J2K_TYPES = {"JPEG2000", "ICNS", "TIFF"}

def jpeg2000_phase(dev, work: str, steps: int = 100) -> None:
    """Phase 17: every JPEG 2000 and ZSTD TIFF fixture against its
    committed PIL decode (and "I;16" pixels); the restore CLI over
    tests/data/restore18 (files only these readers decode, under the
    dataset's extensions) and --image on a 256x256 9/7 JP2; an AVIF read
    as PIL reads it."""
    import numpy as np

    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.models.diffusion import datasets

    data = os.path.join(REPO, "tests", "data")
    # (a) the fixtures, bit for bit, host seconds by type
    t0 = time.perf_counter()
    secs, counts = {}, {}
    bad = []
    big = 0.0
    for sub in J2K_DIRS:
        for f in sorted(os.listdir(os.path.join(data, sub))):
            if f.endswith(("_pil.png", "_pil.npy")):
                continue
            path = os.path.join(data, sub, f)
            stem = os.path.join(data, sub, os.path.splitext(f)[0])
            with open(path, "rb") as fh:
                raw = fh.read()
            kind = pio.image_type(raw)
            t1 = time.perf_counter()
            img = pio.decode_image(raw, path)
            got = pio.to_rgba(img)
            dt = time.perf_counter() - t1
            secs[kind] = secs.get(kind, 0.0) + dt
            counts[kind] = counts.get(kind, 0) + 1
            if f == "restore_256.jp2":
                big = dt
            want = pio.load_png(stem + "_pil.png")
            ok = got.shape == want.shape and bool((got == want).all())
            if os.path.exists(stem + "_pil.npy"):
                px = np.load(stem + "_pil.npy")
                ok &= img.pixels.shape == px.shape and np.array_equal(
                    img.pixels, px)
            if not ok:
                bad.append(f"{sub}/{f}")
    print("[j2k] " + ", ".join(
        f"{counts[k]} {k} in {secs[k]:.3f} s" for k in sorted(secs))
        + f" (host; restore_256.jp2 alone {big:.3f} s; "
        f"{time.perf_counter() - t0:.3f} s in all), each bit-equal to its "
        "committed PIL decode")
    if bad or set(counts) != J2K_TYPES:
        fail(f"j2k fixtures: {bad} differ; types {sorted(counts)}")

    # (b) the restore CLI: the folder of 8, then --image on a JP2
    src = os.path.join(work, "phase17_in")
    os.makedirs(src, exist_ok=True)
    names = sorted(f for f in os.listdir(os.path.join(data, "restore18"))
                   if not f.endswith(("_pil.png", "_pil.npy")))
    for f in names:
        shutil.copy(os.path.join(data, "restore18", f), os.path.join(src, f))
    out = os.path.join(work, "phase17_out")
    fed, runs, wall, launches = _restore_run(
        ["--image_dir", src, "--dataset", "IMAGENET", "--deg", "sr4",
         "--batch", "8", "--steps", str(steps), "--out", out])
    same = bool(fed)
    for fnames, imgs in fed:
        want = np.stack([datasets.center_crop_arr(pio.load_png(os.path.join(
            data, "restore18", os.path.splitext(os.path.basename(n))[0]
            + "_pil.png"))[..., :3], 256).astype(np.float32) / 255.0
            for n in fnames])
        same &= imgs.shape == want.shape and bool((imgs == want).all())
    kinds = sorted(pio.image_type(open(os.path.join(src, f), "rb").read())
                   for f in names)
    print(f"[j2k] ddnm_restore --image_dir over {len(names)} files "
          f"({', '.join(kinds)} under .png, .jpg, .jpeg, .bmp, .webp and "
          f".ppm names), IMAGENET, sr4, batch 8, {steps} steps: "
          f"{wall:.3f} s; fed batch equal to the PIL-decoded batch: {same}")
    if not same or len(names) != 8:
        fail("restore: the dataset's batch differs from the batch of the "
             "committed PIL decodes")
    _check_restore("folder", runs, launches, len(names), steps,
                   sorted(os.listdir(out)) if os.path.isdir(out) else [],
                   sorted(f"{os.path.splitext(n)[0]}{s}.png" for n in names
                          for s in ("", "_degraded")), tag="j2k")
    path = os.path.join(data, "jp2", "restore_256.jp2")
    out_png = os.path.join(work, "phase17_jp2", "out.png")
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    fed, runs, wall, launches = _restore_run(
        ["--image", path, "--dataset", "IMAGENET", "--deg", "sr4",
         "--steps", str(steps), "--out", out_png])
    want = pio.load_png(os.path.join(data, "jp2", "restore_256_pil.png"))
    want = want[..., :3].astype(np.float32)[None] / 255.0
    same = len(fed) == 1 and fed[0][1].shape == want.shape and bool(
        (fed[0][1] == want).all())
    print(f"[j2k] ddnm_restore --image restore_256.jp2 (256x256, 9/7, 5 "
          f"levels, 3 layers), sr4, {steps} steps: {wall:.3f} s; fed image "
          f"equal to its PIL decode: {same}")
    if not same:
        fail("restore --image restore_256.jp2: the fed image differs from "
             "its committed PIL decode")
    _check_restore("restore_256.jp2", runs, launches, 1, steps,
                   sorted(os.listdir(os.path.dirname(out_png))),
                   ["out.png", "out_degraded.png"], tag="j2k")

    # (d) AVIF: identified and read as PIL reads it (phase 18 has the rest)
    path = os.path.join(data, "avif", "q60.avif")
    with open(path, "rb") as fh:
        raw = fh.read()
    named = pio.image_type(raw)
    got = pio.decode_image(raw, path).pixels
    want = pio.load_png(os.path.join(data, "avif", "q60_pil.png"))
    same = got.shape == want.shape and bool((got == want).all())
    print(f"[j2k] AVIF q60.avif: type {named!r}, equal to its PIL decode: "
          f"{same}")
    if named != "AVIF" or not same:
        fail(f"AVIF: type {named!r}, equal to PIL: {same}")


# the AVIF fixture folders under tests/data; each file's PIL decode (its
# mode, "RGB" or "RGBA") is `<stem>_pil.png` beside it
AVIF_DIRS = ("avif", "restore19")
AVIF_TIMING = ("timing", "avif_q60_512x384")


def avif_phase(dev, work: str, steps: int = 100) -> None:
    """Phase 18: every AVIF fixture against its committed PIL decode; the
    restore CLI over tests/data/restore19 (8 AVIFs under the dataset's
    extensions) and --image on a 256x256 AVIF; the 512x384 timing
    fixture."""
    import hashlib

    import numpy as np

    from pointdreamer_tpu_torch import avif
    from pointdreamer_tpu_torch import io as pio
    from pointdreamer_tpu_torch.av1_block import Stats
    from pointdreamer_tpu_torch.models.diffusion import datasets

    data = os.path.join(REPO, "tests", "data")
    # (a) the fixtures, bit for bit, host seconds by bit depth and format
    t0 = time.perf_counter()
    secs, counts = {}, {}
    bad = []
    for sub in AVIF_DIRS:
        for f in sorted(os.listdir(os.path.join(data, sub))):
            if f.endswith("_pil.png"):
                continue
            path = os.path.join(data, sub, f)
            with open(path, "rb") as fh:
                raw = fh.read()
            st = Stats()
            t1 = time.perf_counter()
            kind = pio.image_type(raw)
            got = avif.decode_avif(raw, st) if kind == "AVIF" else None
            dt = time.perf_counter() - t1
            # the colour image's depth and format come first in `st`
            depth = next((k[9:] for k in st if k.startswith("bitdepth")),
                         "?")
            fmt = next((k.replace("subsampling_", "ss")
                        for k in st if k.startswith(("subsampling", "mono"))),
                       "?")
            alpha = "+alpha" if got is not None and got.shape[-1] == 4 \
                else ""
            key = f"{depth}-bit {fmt}{alpha}"
            secs[key] = secs.get(key, 0.0) + dt
            counts[key] = counts.get(key, 0) + 1
            want = pio.load_png(os.path.join(data, sub, os.path.splitext(
                f)[0] + "_pil.png"))
            if got is None or got.shape != want.shape or not bool(
                    (got == want).all()):
                bad.append(f"{sub}/{f}")
    print("[avif] " + ", ".join(
        f"{counts[k]} {k} in {secs[k]:.3f} s" for k in sorted(secs))
        + f" (host; {time.perf_counter() - t0:.3f} s in all), each "
        "bit-equal to its committed PIL decode")
    if bad or sum(counts.values()) < 50:
        fail(f"avif fixtures: {bad} differ; {sum(counts.values())} read")

    # (b) the restore CLI: the folder of 8, then --image on an AVIF
    src = os.path.join(work, "phase18_in")
    os.makedirs(src, exist_ok=True)
    names = sorted(f for f in os.listdir(os.path.join(data, "restore19"))
                   if not f.endswith("_pil.png"))
    for f in names:
        shutil.copy(os.path.join(data, "restore19", f), os.path.join(src, f))
    out = os.path.join(work, "phase18_out")
    fed, runs, wall, launches = _restore_run(
        ["--image_dir", src, "--dataset", "IMAGENET", "--deg", "sr4",
         "--batch", "8", "--steps", str(steps), "--out", out])
    same = bool(fed)
    for fnames, imgs in fed:
        want = np.stack([datasets.center_crop_arr(pio.load_png(os.path.join(
            data, "restore19", os.path.splitext(os.path.basename(n))[0]
            + "_pil.png"))[..., :3], 256).astype(np.float32) / 255.0
            for n in fnames])
        same &= imgs.shape == want.shape and bool((imgs == want).all())
    kinds = sorted({pio.image_type(open(os.path.join(src, f), "rb").read())
                    for f in names})
    print(f"[avif] ddnm_restore --image_dir over {len(names)} files "
          f"({', '.join(kinds)} under .png, .jpg, .jpeg, .bmp, .webp and "
          f".ppm names), IMAGENET, sr4, batch 8, {steps} steps: "
          f"{wall:.3f} s; fed batch equal to the PIL-decoded batch: {same}")
    if not same or len(names) != 8 or kinds != ["AVIF"]:
        fail("restore: the dataset's batch differs from the batch of the "
             "committed PIL decodes")
    _check_restore("folder", runs, launches, len(names), steps,
                   sorted(os.listdir(out)) if os.path.isdir(out) else [],
                   sorted(f"{os.path.splitext(n)[0]}{s}.png" for n in names
                          for s in ("", "_degraded")), tag="avif")
    path = os.path.join(data, "avif", "restore_256.avif")
    out_png = os.path.join(work, "phase18_avif", "out.png")
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    fed, runs, wall, launches = _restore_run(
        ["--image", path, "--dataset", "IMAGENET", "--deg", "sr4",
         "--steps", str(steps), "--out", out_png])
    want = pio.load_png(os.path.join(data, "avif", "restore_256_pil.png"))
    want = want[..., :3].astype(np.float32)[None] / 255.0
    same = len(fed) == 1 and fed[0][1].shape == want.shape and bool(
        (fed[0][1] == want).all())
    print(f"[avif] ddnm_restore --image restore_256.avif (256x256, q60), "
          f"sr4, {steps} steps: {wall:.3f} s; fed image equal to its PIL "
          f"decode: {same}")
    if not same:
        fail("restore --image restore_256.avif: the fed image differs from "
             "its committed PIL decode")
    _check_restore("restore_256.avif", runs, launches, 1, steps,
                   sorted(os.listdir(os.path.dirname(out_png))),
                   ["out.png", "out_degraded.png"], tag="avif")

    # (d) the timing fixture: median of 3 host decodes, SHA-256
    sub, stem = AVIF_TIMING
    with open(os.path.join(data, sub, stem + ".avif"), "rb") as fh:
        raw = fh.read()
    with open(os.path.join(data, sub, stem + ".sha256")) as fh:
        digest = fh.read().strip()
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        px = avif.decode_avif(raw)
        times.append(time.perf_counter() - t1)
    got = hashlib.sha256(px.tobytes()).hexdigest()
    print(f"[avif] {stem}.avif ({px.shape[1]}x{px.shape[0]}, 4:2:0): "
          f"host decode {sorted(times)[1]:.3f} s (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in times)}); SHA-256 of the pixels "
          f"{got[:16]}... equal to the committed digest: {got == digest}")
    if got != digest:
        fail(f"{stem}: decoded pixels differ from the committed digest")


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

    # K2 beyond the inference shapes, K5 at the UNet's shapes, K6 (no
    # caller on the main paths: its launches there are 0)
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
    unet_split(unet, dev, gen)
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
    if launches["groupnorm"] != GN_SITES * 100:
        fail(f"K5 launched {launches['groupnorm']} times, not "
             f"{GN_SITES * 100} (every GroupNorm site of 100 forwards)")
    if launches["segment_sum"] != 100:
        fail(f"K3 launched {launches['segment_sum']} times, not 100")
    if launches["raster_binned"] < 3:
        fail(f"K1 launched {launches['raster_binned']} times, not >= 3")
    for t in table:
        if t["name"] != "raster_legacy":
            t["launches"] = launches[t["name"]]
    check_outputs(obj, cfg, "e2e")
    e2e_stages = dict(timer.times)
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
                     "groupnorm": GN_SITES * 100, "winograd_conv3x3": 0,
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
    torch.cuda.empty_cache()
    selfparity_phase(work)

    # ---- 9. w8a8 DDNM: K7 and K8, the recon, the fidelity --------------
    table.extend(check_quant(dev, gen))
    torch.cuda.empty_cache()
    w8a8_recon(ply, work, os.path.join(REPO, "configs", "default.yaml"),
               bf16_views, bf16_inpaint, table)
    torch.cuda.empty_cache()
    w8a8_fidelity_phase(work)

    # ---- 10. the Pipeline's other options ------------------------------
    t10 = time.perf_counter()
    optimize_completion_phase(dev, pipe, ply, work, e2e_stages)
    face_mode_phase(dev, pipe, ply, work)
    del pipe
    torch.cuda.empty_cache()
    tets_phase(dev, cfg, ply_alone, spr_dist)
    print(f"[options] phase 10 {time.perf_counter() - t10:.2f} s")

    # ---- 11. the restore CLI, the operators, the other models, NKSR ----
    t11 = time.perf_counter()
    restore_phase(dev, work, bf16_inpaint)
    torch.cuda.empty_cache()
    operators_phase(dev)
    models_phase(dev, gen, table)
    torch.cuda.empty_cache()
    nksr_phase(dev, ply_alone, work, spr_dist)
    print(f"[restore & nksr] phase 11 {time.perf_counter() - t11:.2f} s")

    # ---- 12. multi-device paths at world size 1, the host tools --------
    t12 = time.perf_counter()
    multidevice_phase(dev, work, bf16_views)
    torch.cuda.empty_cache()
    host_tools_phase(dev, work, bf16_views)
    print(f"[multidevice & host tools] phase 12 "
          f"{time.perf_counter() - t12:.2f} s")

    # ---- 13. image input: WebP and progressive JPEG --------------------
    t13 = time.perf_counter()
    torch.cuda.empty_cache()
    image_input_phase(dev, work)
    print(f"[image input] phase 13 {time.perf_counter() - t13:.2f} s")

    # ---- 14. inputs by content: configs, JPEG variants, GIF, TIFF -------
    t14 = time.perf_counter()
    torch.cuda.empty_cache()
    inputs_phase(dev, work, cfg)
    print(f"[inputs] phase 14 {time.perf_counter() - t14:.2f} s")

    # ---- 15. configs and images the port refused or misread ------------
    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    readers_phase(dev, work)
    print(f"[readers] phase 15 {time.perf_counter() - t15:.2f} s")

    # ---- 16. the rest of PIL's readers ---------------------------------
    t16 = time.perf_counter()
    torch.cuda.empty_cache()
    rest_readers_phase(dev, work)
    print(f"[rest] phase 16 {time.perf_counter() - t16:.2f} s")

    # ---- 17. JPEG 2000 and ZSTD TIFF ------------------------------------
    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    jpeg2000_phase(dev, work)
    print(f"[j2k] phase 17 {time.perf_counter() - t17:.2f} s")

    # ---- 18. AVIF -------------------------------------------------------
    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    avif_phase(dev, work)
    print(f"[avif] phase 18 {time.perf_counter() - t18:.2f} s")

    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
