"""Poisson surface reconstruction baseline (twin of baselines/spr.py):
the screened Poisson indicator + marching cubes + QEM of
pipeline/geometry.py, in the signature of the reference's
recon_one_shape_SPR (spr.py:26).

    python -m pointdreamer_tpu_torch.baselines.spr <cloud.ply> <out.obj>
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def recon_one_shape_SPR(xyz: np.ndarray, rgb01: Optional[np.ndarray] = None,
                        simplify_face_num: int = 10000,
                        grid_res: int = 128, device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray, None]:
    """Point cloud -> (vertices, faces, None) via Poisson reconstruction."""
    from ..pipeline.geometry import reconstruct_mesh
    from ..pipeline.pipeline import resolve_device

    v, f = reconstruct_mesh(np.asarray(xyz, np.float32), "SPR",
                            grid_res=grid_res, target_faces=simplify_face_num,
                            device=resolve_device(device))
    return v, f, None


def main(pc_file: str, out_obj: str, simplify_face_num: int = 10000,
         device="cuda"):
    """CLI parity with reference baselines/spr.py:77: the mesh is written
    in the cloud's own (un-normalized) coordinates."""
    from .. import io as pio
    from ..pipeline.geometry import normalize_points

    xyz, rgb = pio.read_ply_xyzrgb(pc_file)
    xyz_n, center, scale = normalize_points(xyz)
    v, f, _ = recon_one_shape_SPR(xyz_n, rgb, simplify_face_num,
                                  device=device)
    pio.save_obj(v * scale + center, f, out_obj)


if __name__ == "__main__":
    import sys

    main(sys.argv[1], sys.argv[2])
