"""Stage: write the textured mesh, OBJ + MTL + PNG (twin of
pipeline/export.py): the texture PNG is flipped vertically (v = 0 at the
bottom row, the OBJ convention), plus an RGBA atlas-without-background
image; or, in face mode, one material and PNG a view."""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import io as pio


def save_multi_material_obj(vertices, faces, face_view_ids, face_vertex_uvs,
                            view_images, save_path,
                            name: str = "model_normalized"):
    """The multi-material export of `unproject_by='face'` (reference
    ours_utils.py save-mtl/obj block :418-455): faces grouped by their
    view, each group textured by that view's inpainted image, written as
    `<i>.png` (flipped: vt has v up), `<name>.mtl` and `<name>.obj`.

    face_view_ids [F] int (view per face, < 0 -> view 0);
    face_vertex_uvs [F,3,2] per-corner uv in the assigned view's image;
    view_images [V,res,res,3] float in [0,1] (tensor or array)."""
    os.makedirs(save_path, exist_ok=True)
    v = np.asarray(vertices)
    f = np.asarray(faces, np.int64)
    fv = np.asarray(face_view_ids)
    fv = np.where(fv < 0, 0, fv)
    uvs = np.asarray(face_vertex_uvs)
    imgs = pio.to_uint8(view_images)      # one uint8 device->host copy
    n_views = imgs.shape[0]

    for i in range(n_views):
        pio.save_rgb(imgs[i], os.path.join(save_path, f"{i}.png"),
                     flip_vertical=True)
    with open(os.path.join(save_path, f"{name}.mtl"), "w") as fid:
        for i in range(n_views):
            fid.write(f"newmtl material_{i}\nKd 1 1 1\nKa 0 0 0\n"
                      f"Ks 0.4 0.4 0.4\nNs 10\nillum 2\n"
                      f"map_Kd {i}.png\n\n")
    with open(os.path.join(save_path, f"{name}.obj"), "w") as fid:
        fid.write(f"mtllib {name}.mtl\n")
        for p in v:
            fid.write(f"v {p[0]:f} {p[1]:f} {p[2]:f}\n")
        for vt in uvs.reshape(-1, 2):
            fid.write(f"vt {vt[0]:f} {1.0 - vt[1]:f}\n")
        for i in range(n_views):
            fid.write(f"usemtl material_{i}\n")
            for fi in np.nonzero(fv == i)[0]:
                a = f[fi] + 1
                t = np.array([3 * fi, 3 * fi + 1, 3 * fi + 2]) + 1
                fid.write(f"f {a[0]}/{t[0]} {a[1]}/{t[1]} "
                          f"{a[2]}/{t[2]}\n")
    return os.path.join(save_path, f"{name}.obj")


def save_textured_mesh(vertices, uvs, faces, face_uv_idx, atlas_img, mask,
                       output_root: str, name: str = "model_normalized"):
    """atlas_img [R,R,3] float in [0,1], row 0 = v~0; mask [R,R] bool."""
    models_dir = os.path.join(output_root, "models")
    others_dir = os.path.join(output_root, "others")
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(others_dir, exist_ok=True)
    atlas = pio.to_uint8(atlas_img)       # one uint8 device->host copy
    m = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
         else np.asarray(mask)).astype(bool)

    def write_pngs(atlas=atlas, m=m):
        pio.save_rgb(atlas, os.path.join(models_dir, f"{name}.png"),
                     flip_vertical=True)
        rgba = np.concatenate(
            [atlas, np.where(m, 255, 0).astype(np.uint8)[..., None]], -1)
        pio.save_rgb(rgba, os.path.join(others_dir,
                                        "atlas_wo_background.png"),
                     flip_vertical=True)

    pio.submit_async_io(write_pngs)
    obj_path = os.path.join(models_dir, f"{name}.obj")
    try:
        pio.save_textured_obj(np.asarray(vertices), np.asarray(uvs),
                              np.asarray(faces), np.asarray(face_uv_idx),
                              obj_path)
    finally:
        pio.flush_async_io()
    return obj_path
