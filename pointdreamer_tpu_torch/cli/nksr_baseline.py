"""Kernel-field (NKSR-class) reconstruction baseline CLI (twin of
cli/nksr_baseline.py; reference baselines/NKSR.py:144-189):
file-or-directory `--pc_file` input, the `output_baseline/NKSR/<name>/
models/` layout, vertex-coloured `model_normalized.obj` + `.ply`, the
normalized input echoed as `input_pc.ply`, the wall time of each shape
printed.

    python -m pointdreamer_tpu_torch.cli.nksr_baseline \\
        --pc_file dataset/demo_data/clock.ply [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _save_vertex_colored_obj(verts, faces, colors01, path):
    """OBJ with the common vertex-color extension (v x y z r g b) — the
    same encoding pymeshlab emits for the reference's colored mesh."""
    with open(path, "w") as f:
        if colors01 is None:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        else:
            for v, c in zip(verts, np.clip(colors01, 0, 1)):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                        f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for t in faces:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def _save_vertex_colored_ply(verts, faces, colors01, path):
    """Binary-less ascii ply with per-vertex uchar colors, y-up -> z-up
    rotated like the reference's save_ply branch (NKSR.py:181-186)."""
    # z-flip (axisz=-1) then rotate +90 deg about x composes to
    # (x, y, z) -> (x, z, y)
    v = np.stack([verts[:, 0], verts[:, 2], verts[:, 1]], axis=-1)
    c = (np.clip(colors01, 0, 1) * 255).astype(np.uint8) \
        if colors01 is not None else np.full((len(v), 3), 200, np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(v)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for p, col in zip(v, c):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{col[0]} {col[1]} {col[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def main(argv=None):
    ap = argparse.ArgumentParser("NKSR_baseline")
    ap.add_argument("--pc_file", type=str,
                    default="dataset/demo_data/clock.ply",
                    help="path to an input .ply or a directory of them")
    ap.add_argument("--output", type=str, default="output_baseline/NKSR")
    ap.add_argument("--grid_res", type=int, default=128)
    ap.add_argument("--mise_iter", type=int, default=2)
    ap.add_argument("--max_centers", type=int, default=4096)
    ap.add_argument("--simplify_face_num", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import io as pio
    from ..baselines.nksr import recon_one_shape_NKSR
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)

    if args.pc_file.endswith(".ply"):
        pc_files = [args.pc_file]
    else:
        pc_files = [os.path.join(args.pc_file, p)
                    for p in sorted(os.listdir(args.pc_file))
                    if p.endswith(".ply")]

    for pc_file in pc_files:
        name = os.path.basename(pc_file).split(".ply")[0]
        model_dir = os.path.join(args.output, name, "models")
        os.makedirs(model_dir, exist_ok=True)
        obj_file = os.path.join(model_dir, "model_normalized.obj")
        if os.path.exists(obj_file):
            print("skip exist", obj_file)
            continue

        xyz, rgb = pio.read_ply_xyzrgb(pc_file)
        rgb01 = rgb.astype(np.float32) / 255.0
        # reference normalization (NKSR.py:100-104): center to the bbox
        # midpoint, scale by the largest extent
        lo, hi = xyz.min(0), xyz.max(0)
        xyz = (xyz - (hi + lo) / 2.0) / max((hi - lo).max(), 1e-9)
        pio.save_colored_pc_ply(
            xyz, rgb01, os.path.join(args.output, name, "input_pc.ply"))

        t0 = time.time()
        verts, faces, colors = recon_one_shape_NKSR(
            xyz.astype(np.float32), rgb01, grid_res=args.grid_res,
            mise_iter=args.mise_iter, max_centers=args.max_centers,
            simplify_face_num=args.simplify_face_num, device=dev)
        _save_vertex_colored_obj(verts, faces, colors, obj_file)
        _save_vertex_colored_ply(verts, faces, colors,
                                 obj_file.replace(".obj", ".ply"))
        print("time:", round(time.time() - t0, 3), "s",
              f"({len(verts)} verts, {len(faces)} faces)")


if __name__ == "__main__":
    main()
