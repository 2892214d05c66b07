"""The system under test: the port's `Pipeline`, built from a
configuration file with the benchmark's own weights, and what the harness
observes of it.

The harness reads from the program only what it exposes: the stage
spans of its `StageTimer`, kernel names in the profiler's trace, and,
through hooks, the UNet's inputs and outputs at the steps the check
compares, each forward's host time, and the rasterizer's and the
segment sum's inputs and outputs.  It changes nothing the
program computes; its warm-up runs the sampler for a few steps only
(`DDNMInpainter.t_sampling`, put back before the window)."""
from __future__ import annotations

import contextlib
import importlib
import logging
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import weights as pweights

# modules the pipeline imports lazily on its host threads (unwrap, hulls,
# geometry): imported here first, in one thread, since two threads that
# import one module at once can fail with a _DeadlockError
PRELOAD = ("scipy.sparse", "scipy.sparse.linalg", "scipy.sparse.csgraph",
           "scipy.spatial", "scipy.ndimage", "scipy.fft",
           "pointdreamer_tpu_torch.ops.splat")

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


def build(config: dict, out_dir: str, seed: int, device) -> object:
    """The port's Pipeline for `config`, writing under `out_dir`, its UNet
    holding the weights made from `seed`."""
    from pointdreamer_tpu_torch.camera import make_camera_rig
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.log import get_logger
    from pointdreamer_tpu_torch.models.diffusion import (DDNMInpainter,
                                                         quantize_unet_)
    from pointdreamer_tpu_torch.models.diffusion.unet import UNetModel
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    for name in PRELOAD:
        importlib.import_module(name)
    dev = torch.device(device)
    cfg = load_config(dict(config["pipeline"], output_path=out_dir),
                      strict=True)
    logger = get_logger()
    logger.setLevel(logging.WARNING)
    widths = config["unet"]
    with torch.device("meta"):
        model = UNetModel(**unet_kwargs(widths))
    model = model.to_empty(device=dev)
    sd = pweights.make(param_shapes(widths), seed, dev)
    model.load_state_dict(sd)
    del sd
    if cfg.ddnm_quant_int8:
        quantize_unet_(model)
    # a w8a8 model's float work around its int8 sites is bf16 too
    model.set_compute_dtype(torch.bfloat16)
    model = model.eval().requires_grad_(False)
    d = config["ddnm"]
    inpainter = DDNMInpainter(model, t_sampling=d["steps"], eta=d["eta"],
                              seed=d["seed"],
                              static_calib=cfg.ddnm_quant_int8
                              and cfg.ddnm_quant_static)
    rig = make_camera_rig(cfg.view_num, cfg.cam_distance, cfg.cam_res,
                          cfg.cam_fov_deg, cfg.camera_distribution,
                          device=dev)
    return Pipeline(cfg=cfg, device=dev, rig=rig, inpainter=inpainter,
                    logger=logger)


def check_steps(seed: int, index: int, steps: int, iters: int = 1):
    """What the check reads of shape `index`, drawn from the seed: the
    UNet's noise estimate at the first, one drawn and the last sampler
    step, its input x also after the drawn one (for the DDNM update);
    where each raster call's band of rows starts (a fraction of the
    free range); which of the `iters` segment sums of optimize."""
    rng = np.random.default_rng([seed, index, 7])
    mid = int(rng.integers(1, max(steps - 1, 2)))
    mid = min(mid, steps - 2) if steps > 2 else 0
    eps = sorted({0, mid, steps - 1})
    xs = sorted(set(eps) | {mid + 1} - {steps})
    return {"eps": eps, "x": xs, "mid": mid,
            "bands": rng.random(4).tolist(),
            "segsum": int(rng.integers(0, max(iters, 1)))}


# a raster call's band: a quarter of its rows
RASTER_BAND = 4


def _band(n: int, parts: int, u: float):
    """[start, end) of n // parts of n, starting at fraction u of the
    free range."""
    width = max(n // parts, 1)
    start = min(int(u * (n - width + 1)), n - width)
    return start, start + width


def to_device(obj, device):
    """A record's tensors moved to `device`, its other values kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    return obj


class Observer:
    """Hooks on the program, for the shape each client thread has
    declared (`begin_shape`): the sampler's known image and mask and, at
    the planned steps, the UNet's input x and noise estimate (its first
    three channels); every call of the rasterizer (K1: project, the
    atlas bake, optimize) with its inputs and a band of its outputs; one
    segment sum of optimize (K3) with its inputs and output.  A shape's
    record moves to the host when the shape ends (`end_shape`), so that
    records do not pile up on the card.  While `forward_log` is a list,
    each forward appends (thread ident, host start ns, host end ns)."""

    def __init__(self, inpainter, seed: int, steps: int, iters: int = 1):
        from pointdreamer_tpu_torch.ops import raster as orast
        from pointdreamer_tpu_torch.pipeline import optimize as popt

        self.seed, self.steps, self.iters = seed, steps, iters
        self.local = threading.local()
        self.records: Dict[int, dict] = {}
        self.capture = False
        self.forward_log = None
        self._orig = inpainter.inpaint
        inpainter.inpaint = self._inpaint
        self._hooks = [
            inpainter.model.register_forward_pre_hook(self._pre),
            inpainter.model.register_forward_hook(self._post)]
        self._inpainter = inpainter
        self._modules = {"raster": (orast, "rasterize_binned",
                                    orast.rasterize_binned),
                         "segsum": (popt, "segment_sum", popt.segment_sum)}
        orast.rasterize_binned = self._rasterize
        popt.segment_sum = self._segment_sum

    def begin_shape(self, index: Optional[int]) -> None:
        rec = None
        if self.capture and index is not None:
            rec = self.records[index] = {
                "plan": check_steps(self.seed, index, self.steps,
                                    self.iters),
                "x": {}, "eps": {}, "raster": [], "segsum": None,
                "segsum_calls": 0}
        self.local.shape_rec = rec

    def end_shape(self) -> None:
        """The current shape's record to the host."""
        rec = getattr(self.local, "shape_rec", None)
        if rec is not None:
            rec.update(to_device(
                {k: v for k, v in rec.items() if k != "plan"}, "cpu"))
        self.local.shape_rec = None

    def _shape(self) -> Optional[dict]:
        return getattr(self.local, "shape_rec", None)

    def _inpaint(self, masked_imgs, masks, generator=None):
        st = self.local
        st.step, st.rec = 0, self._shape()
        if st.rec is not None:
            st.rec["img"] = masked_imgs.detach().clone()
            st.rec["mask"] = masks.detach().clone()
        try:
            return self._orig(masked_imgs, masks, generator)
        finally:
            st.rec = None

    def _rasterize(self, verts_ndc, verts_depth, faces, res,
                   cull_backface=False):
        out = self._modules["raster"][2](verts_ndc, verts_depth, faces, res,
                                         cull_backface)
        rec = self._shape()
        if rec is not None:
            bands = rec["plan"]["bands"]
            r0, r1 = _band(res, RASTER_BAND,
                           bands[len(rec["raster"]) % len(bands)])
            rec["raster"].append({
                "ndc": verts_ndc.detach().clone(),
                "depth": verts_depth.detach().clone(),
                "faces": faces.detach().clone(), "res": int(res),
                "cull": bool(cull_backface), "rows": (r0, r1),
                "face_id": out.face_id[:, r0:r1].clone(),
                "zbuf": out.zbuf[:, r0:r1].clone(),
                "bary": out.bary[:, r0:r1].clone()})
        return out

    def _segment_sum(self, contrib, cum_bounds):
        out = self._modules["segsum"][2](contrib, cum_bounds)
        rec = self._shape()
        if rec is not None:
            if rec["segsum_calls"] == rec["plan"]["segsum"]:
                rec["segsum"] = {"contrib": contrib.detach().clone(),
                                 "cum": cum_bounds.detach().clone(),
                                 "out": out.clone()}
            rec["segsum_calls"] += 1
        return out

    def _pre(self, module, args):
        self.local.t0 = time.time_ns()

    def _post(self, module, args, out):
        st = self.local
        rec = getattr(st, "rec", None)
        if rec is not None:
            s = getattr(st, "step", 0)
            if s in rec["plan"]["x"]:
                rec["x"][s] = args[0].detach().clone()
            if s in rec["plan"]["eps"]:
                rec["eps"][s] = out[..., :3].detach().float().clone()
            st.step = s + 1
        log = self.forward_log
        if log is not None:
            log.append((threading.get_ident(), st.t0, time.time_ns()))

    def close(self) -> None:
        """Removes the hooks and lets go of the program's objects."""
        for h in self._hooks:
            h.remove()
        for mod, name, orig in self._modules.values():
            setattr(mod, name, orig)
        self._inpainter.__dict__.pop("inpaint", None)
        self._inpainter = self._orig = None


def stage_timer(index: int, sink: Optional[list]):
    """A StageTimer (device-synchronised stages, as the pipeline's own);
    with a `sink`, each stage also appends (index, name, host start ns,
    host end ns) to it."""
    from pointdreamer_tpu_torch.log import StageTimer

    if sink is None:
        return StageTimer(None, sync=True)

    class LoggedTimer(StageTimer):
        @contextlib.contextmanager
        def stage(self, name: str):
            t0 = time.time_ns()
            try:
                with StageTimer.stage(self, name) as d:
                    yield d
            finally:
                sink.append((index, name, t0, time.time_ns()))

    return LoggedTimer(None, sync=True)
