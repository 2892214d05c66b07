"""End-to-end self-parity acceptance harness (twin of eval/selfparity.py).

With no pretrained diffusion weights, the measurable stand-in for the
reference's texture-fidelity criterion is a synthetic shape whose surface
colour is a known analytic function of position: run the whole pipeline
on a coloured cloud sampled from it, then score the exported atlas
against the analytic field at area-weighted samples of every exported
face (sample -> interpolated UV -> bilinear atlas lookup, against the
colour at the sample's position).  Geometry error counts as colour error,
as in the reference's render-based PSNR.

    python -m pointdreamer_tpu_torch.eval.selfparity [--shape cube]
        [--quick] [--device cuda]
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

from ..synthetic import analytic_color, cube_cloud


def sphere_cloud(n: int = 30000, seed: int = 0,
                 color_fn: Callable = analytic_color):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 0.5).astype(np.float32)
    return pts, color_fn(pts).astype(np.float32)


def _bilinear(atlas: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """uv in [0,1]^2 (v up, the exported OBJ's convention after the load
    flip) -> bilinear RGB."""
    R = atlas.shape[0]
    x = np.clip(uv[:, 0] * R - 0.5, 0.0, R - 1.0)
    y = np.clip(uv[:, 1] * R - 0.5, 0.0, R - 1.0)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, R - 1)
    y1 = np.minimum(y0 + 1, R - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return ((atlas[y0, x0] * (1 - fx) + atlas[y0, x1] * fx) * (1 - fy) +
            (atlas[y1, x0] * (1 - fx) + atlas[y1, x1] * fx) * fy)


def score_exported_mesh(obj_path: str,
                        color_fn: Callable = analytic_color,
                        samples_per_face: int = 6,
                        seed: int = 0) -> Dict[str, float]:
    """Sample the exported textured mesh and PSNR it against color_fn."""
    from .. import io as pio

    m = pio.load_obj(obj_path)
    png = obj_path[:-4] + ".png"
    if not os.path.exists(png):
        png = os.path.join(os.path.dirname(obj_path),
                           "model_normalized.png")
    atlas = pio.load_rgb(png)[::-1]           # undo the export's v-flip
    v, f = m["vertices"], m["faces"]
    uvs, fuv = m["uvs"], m["face_uv_idx"]

    rng = np.random.default_rng(seed)
    F = len(f)
    # area-weighted barycentric samples: the PSNR is a surface integral
    e0 = v[f[:, 1]] - v[f[:, 0]]
    e1 = v[f[:, 2]] - v[f[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e0, e1), axis=1)
    probs = area / max(area.sum(), 1e-12)
    k = max(F * samples_per_face, 20000)
    fid = rng.choice(F, size=k, p=probs)
    a = rng.random(k)
    b = rng.random(k)
    flip = a + b > 1
    a[flip] = 1 - a[flip]
    b[flip] = 1 - b[flip]
    w = np.stack([1 - a - b, a, b], axis=1)
    pos = (v[f[fid]] * w[:, :, None]).sum(1)
    uv = (uvs[fuv[fid]] * w[:, :, None]).sum(1)
    got = _bilinear(atlas, uv)
    want = color_fn(pos)
    mse = float(np.mean((got - want) ** 2))
    return {
        "psnr_db": float(10.0 * np.log10(1.0 / max(mse, 1e-12))),
        "mean_abs_err": float(np.abs(got - want).mean()),
        "n_samples": int(k),
        "n_faces": int(F),
    }


def run_roundtrip(out_dir: str,
                  shape: str = "cube",
                  n_points: int = 30000,
                  color_fn: Callable = analytic_color,
                  overrides: Optional[Dict] = None,
                  seed: int = 0,
                  device="cuda") -> Dict[str, float]:
    """The whole pipeline at the given settings -> metrics dict.

    The defaults are the reference's full resolutions (8 views at 512^2,
    1024^2 atlas, 128^3 grid, nearest inpainting); `overrides` runs a
    reduced version of the same harness (the CPU tests')."""
    from ..config import PipelineConfig
    from ..io import save_colored_pc_ply
    from ..pipeline.pipeline import Pipeline, resolve_device

    dev = resolve_device(device)
    maker = {"cube": cube_cloud, "sphere": sphere_cloud}[shape]
    pts, rgb = maker(n_points, seed, color_fn)
    ply = os.path.join(out_dir, f"selfparity_{shape}.ply")
    os.makedirs(out_dir, exist_ok=True)
    save_colored_pc_ply(pts, rgb, ply)

    kw = dict(
        output_path=os.path.join(out_dir, "out"),
        texture_gen_method="nearest",
        geo_from="SPR",   # FFT-Poisson: a smooth indicator, no spurious
                          # handles at sharp edges (hoppe double-sheets
                          # there at high grid res)
        grid_res=128,
        target_face_num=10000,
        cam_res=512,
        res=256,
        view_num=8,
        xatlas_texture_res=1024,
        edge_dilate_kernels=[21],
        optimize_from="ours",
        point_validation_by_o3d=True,
        complete_unseen_by="neighbor",
        save_input_pc=False,
    )
    kw.update(overrides or {})
    pipe = Pipeline.create(PipelineConfig(**kw), device=dev)
    obj = pipe.recon_one_textured_mesh(ply)
    res = score_exported_mesh(obj, color_fn, seed=seed)
    res["obj_path"] = obj
    return res


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="cube", choices=["cube", "sphere"])
    ap.add_argument("--out", default="selfparity_out")
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--quick", action="store_true",
                    help="reduced resolutions")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    overrides = None
    if args.quick:
        overrides = dict(grid_res=64, cam_res=256, res=128,
                         xatlas_texture_res=256, target_face_num=4000,
                         edge_dilate_kernels=[11])
    print(json.dumps(run_roundtrip(args.out, args.shape, args.points,
                                   overrides=overrides, device=args.device),
                     indent=1))
