"""Geometry-quality table over the demo clouds (twin of
cli/geometry_table.py): each reconstruction backend scored against the
input scan.

The reference ships no ground-truth meshes for its demo data, so the scan
itself is the target (the convention of its MeshEvaluator when a point
cloud is all there is, models/POCO/eval/src/eval.py:28-90): sample the
reconstructed surface and report symmetric chamfer-L1, F-score @0.01,
normal consistency and Hausdorff against the input points and their
oriented PCA normals.

    python -m pointdreamer_tpu_torch.cli.geometry_table \\
        --data dataset/demo_data --out geom_table.json [--device cuda] \\
        [--backends SPR hoppe POCO --poco_checkpoint poco.pkl]

Prints a markdown table and writes the JSON.  Backends: SPR (screened
FFT-Poisson), hoppe, NKSR (the biharmonic kernel field,
baselines/nksr.py), POCO (the occupancy network of `--poco_checkpoint`).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def score_mesh(verts, faces, gt_pts, gt_nrm, n_sample=100000,
               device="cuda"):
    from ..eval.metrics import (chamfer_and_fscore, hausdorff,
                                sample_mesh_surface)

    samp, samp_n = sample_mesh_surface(verts, faces, n_sample, seed=0)
    m = chamfer_and_fscore(samp, samp_n, gt_pts, gt_nrm, device=device)
    m.update(hausdorff(samp, gt_pts, device=device))
    m["n_verts"], m["n_faces"] = int(len(verts)), int(len(faces))
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="dataset/demo_data")
    ap.add_argument("--out", default="geom_table.json")
    ap.add_argument("--grid_res", type=int, default=128)
    ap.add_argument("--target_faces", type=int, default=10000)
    ap.add_argument("--backends", nargs="+",
                    default=["SPR", "hoppe", "NKSR"])
    ap.add_argument("--poco_checkpoint", default=None,
                    help="POCO checkpoint (either package's, or the "
                         "reference's checkpoint.pth) for the POCO backend")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import io as pio
    from ..ops.sdf import estimate_oriented_normals
    from ..pipeline.geometry import normalize_points, reconstruct_mesh
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)
    poco_apply = None
    if "POCO" in args.backends:
        if not args.poco_checkpoint:
            raise ValueError("the POCO backend needs --poco_checkpoint")
        from ..models.occupancy import load_poco_field

        poco_apply = load_poco_field(args.poco_checkpoint, device=dev)

    plys = sorted(p for p in os.listdir(args.data) if p.endswith(".ply"))
    results = {}
    for ply in plys:
        name = os.path.splitext(ply)[0]
        xyz, _ = pio.read_ply_xyzrgb(os.path.join(args.data, ply))
        xyz_n, _, _ = normalize_points(xyz)
        xyz_n = xyz_n.astype(np.float32)
        gt_nrm = estimate_oriented_normals(xyz_n, device=dev)
        results[name] = {}
        for backend in args.backends:
            t0 = time.time()
            if backend == "NKSR":
                from ..baselines.nksr import recon_one_shape_NKSR

                v, f, _ = recon_one_shape_NKSR(
                    xyz_n, None, grid_res=args.grid_res,
                    simplify_face_num=args.target_faces, device=dev)
            else:
                v, f = reconstruct_mesh(
                    xyz_n, backend, grid_res=args.grid_res,
                    target_faces=args.target_faces, poco_apply=poco_apply,
                    device=dev)
            m = score_mesh(v, f, xyz_n, gt_nrm, device=dev)
            m["recon_sec"] = round(time.time() - t0, 3)
            results[name][backend] = m
            print(f"{name:14s} {backend:6s} chamfer {m['chamfer_l1']:.5f} "
                  f"f@.01 {m['fscore']:.3f} nc {m['normal_consistency']:.3f}"
                  f" hausdorff {m['hausdorff']:.4f}  {m['recon_sec']}s")

    # markdown table (means over shapes)
    print("\n| backend | chamfer-L1 | F@0.01 | normal-cons | Hausdorff |")
    print("|---|---|---|---|---|")
    for backend in args.backends:
        ms = [results[n][backend] for n in results]
        print(f"| {backend} "
              f"| {np.mean([m['chamfer_l1'] for m in ms]):.5f} "
              f"| {np.mean([m['fscore'] for m in ms]):.3f} "
              f"| {np.mean([m['normal_consistency'] for m in ms]):.3f} "
              f"| {np.mean([m['hausdorff'] for m in ms]):.4f} |")

    with open(args.out, "w") as fo:
        json.dump(results, fo, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
