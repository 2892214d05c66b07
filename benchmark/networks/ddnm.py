"""The ADM UNet under DDNM: the network of a configuration with a `ddnm`
key (its widths under `unet`, its precision under `precision`).

A network file holds all that is particular to one of the port's
networks, and the harness finds it by a top-level key of the
configuration file (benchmark/README.md, "Files, found by name"):

    build(config, cfg, seed, device) -> dict    the Pipeline's fields
    warmup(pipe, config), opened(pipe, config)  before the warm-up shapes;
                                                when the window opens
    observe(pipe, observer, config) -> close    hooks into the shape's
                                                record (`observer.part`)
    unobserved(part) -> str | None              why a shape cannot be
                                                checked
    NAMES, readings(config, parts, out_dirs, seed, device, control)
                                                the numbers compared
    counts(config) -> dict                      call shapes (`run.counts`)
    least_s(run) -> float | None                the profiled shape's work
                                                at the card's peaks

Here: the UNet's weights made on the card from the seed, `quantize_unet_`
for w8a8, bf16 compute, the `DDNMInpainter`; a warm-up of a few sampler
steps (all of them where the static calibration needs them); the
sampler's input and, at the steps `plan` draws, the UNet's input and
noise estimate; the readings against the float32 reference UNet and
DDNM's step in float64:

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

The sampler's input (the sparse views and their mask, made by the
project stage) is the program's own state: the reference takes it as it
was handed to the program and follows the sampler step by step from
there.  `control` {'unet_bits', 'step_dtype'} puts the reference in a
lower precision in the program's place: its UNet in `unet_bits`-bit,
its DDNM step in `step_dtype` (benchmark/control.py).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from pdbench import check, system
from pdbench import weights as pweights

# the key the harness finds this file by: its name
KEY = os.path.splitext(os.path.basename(__file__))[0]
NAMES = ("eps_err", "step_err", "views_err")
# the warm-up meets every shape and kernel of the sampler in a few steps
WARMUP_STEPS = 2


def unet_kwargs(widths: dict) -> dict:
    """The port's UNetModel arguments for a configuration's widths."""
    return dict(
        model_channels=widths["model_channels"],
        out_channels=widths["out_channels"],
        num_res_blocks=widths["num_res_blocks"],
        channel_mult=tuple(widths["channel_mult"]),
        attention_ds=tuple(widths["image_size"] // r
                           for r in widths["attention_resolutions"]),
        num_head_channels=widths["num_head_channels"],
        use_scale_shift_norm=widths["use_scale_shift_norm"],
        resblock_updown=widths["resblock_updown"],
        in_channels=widths["in_channels"])


def param_shapes(widths: dict) -> Dict[str, torch.Size]:
    """name -> shape of the reference UNet's state dict, in order."""
    from reference import unet as runet

    return {k: v.shape for k, v in
            runet.build(widths, "meta").state_dict().items()}


def build(config: dict, cfg, seed: int, device) -> dict:
    """The `inpainter`: the port's UNet holding the weights made from
    `seed`, under the configured DDNM sampler."""
    from pointdreamer_tpu_torch.models.diffusion import (DDNMInpainter,
                                                         quantize_unet_)
    from pointdreamer_tpu_torch.models.diffusion.unet import UNetModel

    widths = config["unet"]
    with torch.device("meta"):
        model = UNetModel(**unet_kwargs(widths))
    model = model.to_empty(device=device)
    sd = pweights.make(param_shapes(widths), seed, device)
    model.load_state_dict(sd)
    del sd
    if cfg.ddnm_quant_int8:
        quantize_unet_(model)
    # a w8a8 model's float work around its int8 sites is bf16 too
    model.set_compute_dtype(torch.bfloat16)
    model = model.eval().requires_grad_(False)
    d = config[KEY]
    return {"inpainter": DDNMInpainter(
        model, t_sampling=d["steps"], eta=d["eta"], seed=d["seed"],
        static_calib=cfg.ddnm_quant_int8 and cfg.ddnm_quant_static)}


def warmup(pipe, config: dict) -> None:
    """A few sampler steps a warm-up shape; a w8a8 model's static
    calibration needs all of them."""
    inp = pipe.inpainter
    if not inp.static_calib:
        inp.t_sampling = min(config[KEY]["steps"], WARMUP_STEPS)


def opened(pipe, config: dict) -> None:
    pipe.inpainter.t_sampling = config[KEY]["steps"]


def plan(seed: int, index: int, steps: int) -> dict:
    """The sampler steps the check reads of shape `index`, drawn from the
    seed: the UNet's noise estimate at the first, one drawn and the last
    step; its input x also after the drawn one (for the DDNM update)."""
    rng = np.random.default_rng([seed, index, 7])
    mid = int(rng.integers(1, max(steps - 1, 2)))
    mid = min(mid, steps - 2) if steps > 2 else 0
    eps = sorted({0, mid, steps - 1})
    xs = sorted(set(eps) | {mid + 1} - {steps})
    return {"eps": eps, "x": xs, "mid": mid}


def observe(pipe, observer, config: dict):
    """The sampler's known image and mask and, at the planned steps, the
    UNet's input x and noise estimate (its first three channels); each
    forward's host range to `observer.log_forward`.  Returns the function
    that removes the hooks."""
    inp = pipe.inpainter
    local = threading.local()
    orig = inp.inpaint

    def make(index: int) -> dict:
        return {"plan": plan(observer.seed, index, config[KEY]["steps"]),
                "x": {}, "eps": {}}

    def inpaint(masked_imgs, masks, generator=None):
        local.step, local.rec = 0, observer.part(KEY, make)
        if local.rec is not None:
            local.rec["img"] = masked_imgs.detach().clone()
            local.rec["mask"] = masks.detach().clone()
        try:
            return orig(masked_imgs, masks, generator)
        finally:
            local.rec = None

    def pre(module, args):
        local.t0 = time.time_ns()

    def post(module, args, out):
        rec = getattr(local, "rec", None)
        if rec is not None:
            s = getattr(local, "step", 0)
            if s in rec["plan"]["x"]:
                rec["x"][s] = args[0].detach().clone()
            if s in rec["plan"]["eps"]:
                rec["eps"][s] = out[..., :3].detach().float().clone()
            local.step = s + 1
        observer.log_forward(KEY, local.t0, time.time_ns())

    inp.inpaint = inpaint
    hooks = [inp.model.register_forward_pre_hook(pre),
             inp.model.register_forward_hook(post)]

    def close() -> None:
        for h in hooks:
            h.remove()
        inp.__dict__.pop("inpaint", None)

    return close


def unobserved(part) -> Optional[str]:
    """Why a shape's sampler record cannot be checked, or None."""
    if part is None or "img" not in part:
        return "the sampler was not observed"
    return None


def eps_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref|_2 / |ref|_2 of each view (the first dimension), the
    largest: a view gone wrong reads its own error, whatever the others'
    norms."""
    dims = tuple(range(1, ref.dim()))
    e = (torch.linalg.vector_norm(got - ref, dim=dims)
         / torch.linalg.vector_norm(ref, dim=dims).clamp(min=1e-30))
    return e.max().item()


def reference_unet(config: dict, seed: int, device, quant: int = 0):
    """The float32 reference UNet with the weights made from `seed`
    (`quant` bits: the control in a lower precision)."""
    from reference import unet as runet

    runet.set_exact_fp32()
    model = runet.build(config["unet"], "meta", quant=quant)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(pweights.make(shapes, seed, device), assign=True)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def readings(config: dict, parts: Dict[int, dict], out_dirs: Dict[int, str],
             seed: int, device, control: Optional[dict] = None
             ) -> Dict[str, float]:
    """NAMES over every recorded shape (`parts`: shape index -> this
    network's part of its record)."""
    from reference import ddnm as rddnm

    control = control or {}
    quant = control.get("unet_bits", 0)
    step_dtype = getattr(torch, control.get("step_dtype", "float64"))
    d = config[KEY]
    steps, eta = d["steps"], d["eta"]
    ts, a_t, a_next = rddnm.schedule(steps, d["num_timesteps"])
    ref = reference_unet(config, seed, device)
    low = reference_unet(config, seed, device, quant) if quant else None
    out = dict.fromkeys(NAMES, 0.0)
    draws = None
    for index in sorted(parts):
        rec = system.to_device(parts[index], device)
        x0 = rec["x"][0]
        if draws is None or draws[0].shape != x0.shape:
            draws = rddnm.draws(tuple(x0.shape), steps, d["seed"], device)
        img, mask = rec["img"], rec["mask"]
        if mask.dim() == 3:
            mask = mask[..., None]
        out["step_err"] = max(out["step_err"], check.rel_gap(x0, draws[0]))
        for s in rec["plan"]["eps"]:
            t = torch.tensor([float(ts[s])], device=device)
            x = rec["x"][s].float()
            e_ref = ref(x, t)[..., :3].double()
            e_got = (low(x, t)[..., :3].double() if low is not None
                     else rec["eps"][s].double())
            out["eps_err"] = max(out["eps_err"], eps_gap(e_got, e_ref))
        mid = rec["plan"]["mid"]
        if mid + 1 in rec["x"]:
            args = (rec["x"][mid], rec["eps"][mid], draws[mid + 1], img,
                    mask, float(a_t[mid]), float(a_next[mid]), eta)
            want = rddnm.step(*args)
            got = (rddnm.step(*args, dtype=step_dtype)
                   if step_dtype != torch.float64 else rec["x"][mid + 1])
            out["step_err"] = max(out["step_err"], check.rel_gap(got, want))
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
                check.read_rgb(os.path.join(out_dirs[index], "others",
                                            f"{i}_inpainted.png"))
                for i in range(want.shape[0])]), device=device).double()
        out["views_err"] = max(out["views_err"], (
            (got - want).abs() - 0.5).clamp(min=0).max().item())
    return out


def counts(config: dict) -> Dict[str, object]:
    """Call shapes of one UNet forward at the sampler's batch, from the
    reference run on the meta device (benchmark/reference/flops.py)."""
    from reference import flops

    p = config["pipeline"]
    return flops.forward_calls(config["unet"], p.get("view_num", 8),
                               p.get("res", 256))


def least_s(run) -> Optional[float]:
    """The least time of the UNet forwards (of every client) that ran
    within the profiled shape: the int8 sites at the int8 peak when the
    configuration runs w8a8, every other operation at the bf16 peak."""
    n = ((run.profiled or {}).get("forwards") or {}).get(KEY, 0)
    if not n:
        return None
    m, peak = run.counts[KEY], run.peaks
    if run.cell.config["precision"]["unet"] == "w8a8":
        least = (m["site_ops"] / peak["int8_ops_per_s"]
                 + m["float_ops"] / peak["bf16_ops_per_s"])
    else:
        least = (m["site_ops"] + m["float_ops"]) / peak["bf16_ops_per_s"]
    return least * n
