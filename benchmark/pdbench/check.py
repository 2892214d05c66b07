"""Whether the timed path's outputs are correct: the plain reference
(benchmark/reference) worked out again from the seed, against what the
window's shapes produced.

For every shape of the window, at the steps `system.check_steps` drew:
  eps_err   the UNet's noise estimate against the float32 reference
            UNet at the same input and step: the largest over views of
            |eps - eps_ref|_2 / |eps_ref|_2;
  step_err  the sampler's first state against the reference's draw of
            x_T, and the program's next state against the DDNM step
            worked out in float64 from the program's state and noise
            estimate: max |x - x_ref| / max |x_ref|, the largest over
            views;
  views_err the written `<i>_inpainted.png` against the reference's last
            step from the program's last state: the levels by which a
            pixel lies off the reference beyond the 0.5 of rounding.
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
The sampler's input (the sparse views and their mask, made by the
project stage), the rasterizer's vertices and the segment sum's columns
are the program's own state: the reference takes them as they were
handed to the program and follows it step by step from there.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import system
from . import weights as pweights

NAMES = ("eps_err", "step_err", "views_err", "raster_px", "raster_depth",
         "raster_bary", "segsum_err")


def read_rgb(path: str) -> np.ndarray:
    """A PNG as PIL reads it -> uint8 [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| of each view, the largest over the views."""
    a, b = a.double(), b.double()
    dims = tuple(range(1, a.dim()))
    return ((a - b).abs().amax(dim=dims)
            / b.abs().amax(dim=dims).clamp(min=1e-30)).max().item()


def reference_unet(config: dict, seed: int, device, quant: int = 0):
    """The float32 reference UNet with the weights made from `seed`
    (`quant` bits: the control in a lower precision)."""
    from reference import unet as runet

    runet.set_exact_fp32()
    widths = config["unet"]
    model = runet.build(widths, "meta", quant=quant)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(pweights.make(shapes, seed, device), assign=True)
    return model.eval().requires_grad_(False)


def unobserved(rec) -> Optional[str]:
    """Why a shape's record cannot be checked, or None."""
    if rec is None or "img" not in rec:
        return "the sampler was not observed"
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
def readings(config: dict, records: Dict[int, dict], out_dirs: Dict[int, str],
             seed: int, device, quant: int = 0,
             step_dtype=torch.float64,
             low_dtype=None) -> Dict[str, float]:
    """The numbers over every recorded shape.  `quant`, `step_dtype` and
    `low_dtype` put the reference in a lower precision in the program's
    place (the control): its UNet in `quant`-bit, its DDNM step in
    `step_dtype`, the rasterizer's inputs and the segment sum in
    `low_dtype`, each against the float32 / float64 reference."""
    from reference import ddnm as rddnm
    from reference import raster as rraster

    d = config["ddnm"]
    steps, eta = d["steps"], d["eta"]
    ts, a_t, a_next = rddnm.schedule(steps, d["num_timesteps"])
    ref = reference_unet(config, seed, device)
    low = reference_unet(config, seed, device, quant) if quant else None
    out = dict.fromkeys(NAMES, 0.0)
    draws = None
    for index in sorted(records):
        rec = system.to_device(records[index], device)
        x0 = rec["x"][0]
        if draws is None or draws[0].shape != x0.shape:
            draws = rddnm.draws(tuple(x0.shape), steps, d["seed"], device)
        img, mask = rec["img"], rec["mask"]
        if mask.dim() == 3:
            mask = mask[..., None]
        out["step_err"] = max(out["step_err"], _rel(x0, draws[0]))
        for s in rec["plan"]["eps"]:
            t = torch.tensor([float(ts[s])], device=device)
            x = rec["x"][s].float()
            e_ref = ref(x, t)[..., :3].double()
            e_got = (low(x, t)[..., :3].double() if low is not None
                     else rec["eps"][s].double())
            dims = (1, 2, 3)
            e = (torch.linalg.vector_norm(e_got - e_ref, dim=dims)
                 / torch.linalg.vector_norm(e_ref, dim=dims).clamp(
                     min=1e-30))
            out["eps_err"] = max(out["eps_err"], e.max().item())
        mid = rec["plan"]["mid"]
        if mid + 1 in rec["x"]:
            args = (rec["x"][mid], rec["eps"][mid], draws[mid + 1], img,
                    mask, float(a_t[mid]), float(a_next[mid]), eta)
            want = rddnm.step(*args)
            got = (rddnm.step(*args, dtype=step_dtype)
                   if step_dtype != torch.float64 else rec["x"][mid + 1])
            out["step_err"] = max(out["step_err"], _rel(got, want))
        last = steps - 1
        args = (rec["x"][last], rec["eps"][last], draws[last + 1], img,
                mask, float(a_t[last]), float(a_next[last]), eta)
        want = rddnm.image(rddnm.step(*args)) * 255.0
        if step_dtype != torch.float64:
            got = torch.floor(
                rddnm.image(rddnm.step(*args, dtype=step_dtype)).double()
                * 255.0 + 0.5)
        else:
            got = torch.as_tensor(np.stack([
                read_rgb(os.path.join(out_dirs[index], "others",
                                      f"{i}_inpainted.png"))
                for i in range(want.shape[0])]), device=device).double()
        out["views_err"] = max(out["views_err"], (
            (got - want).abs() - 0.5).clamp(min=0).max().item())
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
        out["segsum_err"] = max(out["segsum_err"], _rel(got[None],
                                                        want[None]))
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
