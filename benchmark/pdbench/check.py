"""Whether the timed path's outputs are correct: the plain reference
(benchmark/reference) worked out again from the seed, against what the
window's shapes produced.  The core's numbers are here, those of the
configuration's networks in their files (benchmark/networks/<key>.py);
`compared` holds the networks' names, then NAMES.

For every shape of the window, from the draws of `system.shape_plan`:
  raster_px, raster_depth, raster_bary
            every rasterizer call of the shape (K1: project's 8 views
            at 512^2, the atlas bake at 1024^2, optimize's 8 views at
            256^2), a band of a quarter of its rows drawn from the seed,
            against the float64 z-buffer of reference/raster.py on the
            call's own vertices: the share of covered pixels whose face
            differs and is not a nearest face to rounding (a pixel
            centre within 1e-3 px of an edge, or faces that overlap at
            one depth, as the atlas's charts may), and where the faces
            agree the mean depth gap (over the mean depth) and the mean
            barycentric gap;
  segsum_err
            one of optimize's segment sums (K3), the call drawn from the
            seed, every texel of it against float64 index_add over the
            call's own columns: max |gap| / max |ref|.
The rasterizer's vertices and the segment sum's columns are the
program's own state: the reference takes them as they were handed to
the program.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import system

NAMES = ("raster_px", "raster_depth", "raster_bary", "segsum_err")


def read_rgb(path: str) -> np.ndarray:
    """A PNG as PIL reads it -> uint8 [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| of each view, the largest over the views."""
    a, b = a.double(), b.double()
    dims = tuple(range(1, a.dim()))
    return ((a - b).abs().amax(dim=dims)
            / b.abs().amax(dim=dims).clamp(min=1e-30)).max().item()


def unobserved(rec) -> Optional[str]:
    """Why a shape's record cannot be checked by the core, or None."""
    if rec is None:
        return "the shape was not observed"
    if not rec["raster"]:
        return "the rasterizer was not observed"
    if rec["segsum"] is None:
        return "optimize's segment sum was not observed"
    return None


def raster_gaps(got: dict, ref: dict, accepted=None):
    """(raster_px, raster_depth, raster_bary) of one band: the share of
    the reference's covered pixels whose nearest face (or coverage)
    differs and is not `accepted` [V, rows, res] as one to rounding
    (reference.raster.accepts); over the pixels where the faces agree,
    the mean depth gap over the mean depth, and the mean of the three
    barycentrics' summed gap."""
    f_got, f_ref = got["face_id"].long(), ref["face_id"].long()
    cov = f_ref >= 0
    differ = (f_got != f_ref) & ((f_got >= 0) | cov)
    if accepted is not None:
        differ = differ & ~accepted
    px = differ.sum().item() / max(cov.sum().item(), 1)
    same = cov & (f_got == f_ref)
    if not same.any():
        return px, 0.0, 0.0
    z_got, z_ref = got["zbuf"].double()[same], ref["zbuf"].double()[same]
    depth = ((z_got - z_ref).abs().mean()
             / z_ref.abs().mean().clamp(min=1e-30)).item()
    bary = (got["bary"].double()[same] - ref["bary"].double()[same]
            ).abs().sum(-1).mean().item()
    return px, depth, bary


@torch.no_grad()
def readings(records: Dict[int, dict], device, low_dtype=None
             ) -> Dict[str, float]:
    """NAMES over every recorded shape.  `low_dtype` puts the reference in
    a lower precision in the program's place (the control): the
    rasterizer's inputs and the segment sum in `low_dtype`, each against
    the float64 reference."""
    from reference import raster as rraster

    out = dict.fromkeys(NAMES, 0.0)
    for index in sorted(records):
        rec = system.to_device(records[index], device)
        for call in rec["raster"]:
            r0, r1 = call["rows"]
            args = (call["ndc"], call["depth"], call["faces"], call["res"],
                    call["cull"], r0, r1)
            want = rraster.raster(*args)
            if low_dtype is not None:
                got = rraster.raster(call["ndc"].to(low_dtype),
                                     call["depth"].to(low_dtype),
                                     *args[2:])
            else:
                got = call
            ok = rraster.accepts(*args, got["face_id"], want)
            for k, v in zip(("raster_px", "raster_depth", "raster_bary"),
                            raster_gaps(got, want, ok)):
                out[k] = max(out[k], v)
        seg = rec["segsum"]
        want = rraster.segment_sum(seg["contrib"], seg["cum"])
        got = (rraster.segment_sum(seg["contrib"], seg["cum"],
                                   dtype=low_dtype)
               if low_dtype is not None else seg["out"])
        out["segsum_err"] = max(out["segsum_err"],
                                rel_gap(got[None], want[None]))
    return out


def file_faults(out_dir: str, atlas_res: int) -> List[str]:
    """What is missing or malformed among a shape's written mesh files."""
    bad = []
    models = os.path.join(out_dir, "models")
    obj = os.path.join(models, "model_normalized.obj")
    if not os.path.exists(obj):
        return ["model_normalized.obj missing"]
    with open(obj) as f:
        text = f.read()
    if "\nf " not in text or "\nvt " not in text or "mtllib" not in text:
        bad.append("model_normalized.obj has no faces, UVs or material")
    if not os.path.exists(os.path.join(models, "model_normalized.mtl")):
        bad.append("model_normalized.mtl missing")
    png = os.path.join(models, "model_normalized.png")
    try:
        a = read_rgb(png)
        if a.shape[:2] != (atlas_res, atlas_res):
            bad.append(f"atlas {a.shape[:2]}, wanted {atlas_res}^2")
    except (OSError, ValueError) as e:
        bad.append(f"atlas: {e}")
    return bad
