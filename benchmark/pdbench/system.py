"""The system under test: the port's `Pipeline`, built from a
configuration file, its networks' fields filled by the configuration's
network files (`benchmark/networks/<key>.py`), and what the harness
observes of it.

The harness reads from the program only what it exposes: the stage
spans of its `StageTimer`, kernel names in the profiler's trace, and,
through hooks, the rasterizer's and the segment sum's inputs and outputs
here and whatever a network's own hooks record (`Observer.part`).  It
changes nothing the program computes."""
from __future__ import annotations

import contextlib
import importlib
import logging
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# modules the pipeline imports lazily on its host threads (unwrap, hulls,
# geometry): imported here first, in one thread, since two threads that
# import one module at once can fail with a _DeadlockError
PRELOAD = ("scipy.sparse", "scipy.sparse.linalg", "scipy.sparse.csgraph",
           "scipy.spatial", "scipy.ndimage", "scipy.fft",
           "pointdreamer_tpu_torch.ops.splat")

def build(config: dict, out_dir: str, seed: int, device,
          networks: dict) -> object:
    """The port's Pipeline for `config`, writing under `out_dir`, with the
    fields each of `networks` ({key: network module}) builds from `seed`."""
    from pointdreamer_tpu_torch.camera import make_camera_rig
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.log import get_logger
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    for name in PRELOAD:
        importlib.import_module(name)
    dev = torch.device(device)
    cfg = load_config(dict(config["pipeline"], output_path=out_dir),
                      strict=True)
    logger = get_logger()
    logger.setLevel(logging.WARNING)
    fields = {}
    for net in networks.values():
        fields.update(net.build(config, cfg, seed, dev))
    rig = make_camera_rig(cfg.view_num, cfg.cam_distance, cfg.cam_res,
                          cfg.cam_fov_deg, cfg.camera_distribution,
                          device=dev)
    return Pipeline(cfg=cfg, device=dev, rig=rig, logger=logger, **fields)


def shape_plan(seed: int, index: int, iters: int = 1) -> dict:
    """What the core check reads of shape `index`, drawn from the seed:
    where each raster call's band of rows starts (a fraction of the free
    range), and which of the `iters` segment sums of optimize."""
    rng = np.random.default_rng([seed, index, 11])
    return {"bands": rng.random(4).tolist(),
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
    declared (`begin_shape`): every call of the rasterizer (K1: project,
    the atlas bake, optimize) with its inputs and a band of its outputs;
    one segment sum of optimize (K3) with its inputs and output.  A
    network's hooks (`observe` of its file) keep their own part of the
    shape's record (`part`) and log their forwards (`log_forward`).  A
    shape's record moves to the host when the shape ends (`end_shape`),
    so that records do not pile up on the card.  While `forward_log` is a
    list, each logged forward appends (network key, thread ident, host
    start ns, host end ns)."""

    def __init__(self, seed: int, iters: int = 1):
        from pointdreamer_tpu_torch.ops import raster as orast
        from pointdreamer_tpu_torch.pipeline import optimize as popt

        self.seed, self.iters = seed, iters
        self.local = threading.local()
        self.records: Dict[int, dict] = {}
        self.capture = False
        self.forward_log = None
        self._modules = {"raster": (orast, "rasterize_binned",
                                    orast.rasterize_binned),
                         "segsum": (popt, "segment_sum", popt.segment_sum)}
        orast.rasterize_binned = self._rasterize
        popt.segment_sum = self._segment_sum

    def begin_shape(self, index: Optional[int]) -> None:
        rec = None
        if self.capture and index is not None:
            rec = self.records[index] = {
                "index": index,
                "plan": shape_plan(self.seed, index, self.iters),
                "raster": [], "segsum": None, "segsum_calls": 0}
        self.local.shape_rec = rec

    def end_shape(self) -> None:
        """The current shape's record to the host."""
        rec = getattr(self.local, "shape_rec", None)
        if rec is not None:
            rec.update(to_device(rec, "cpu"))
        self.local.shape_rec = None

    def _shape(self) -> Optional[dict]:
        return getattr(self.local, "shape_rec", None)

    def part(self, key: str, make: Callable[[int], dict]) -> Optional[dict]:
        """Network `key`'s part of this thread's shape record, made by
        `make(index)` on first use; None where no shape is recorded (the
        warm-up, or outside the window)."""
        rec = self._shape()
        if rec is None:
            return None
        if key not in rec:
            rec[key] = make(rec["index"])
        return rec[key]

    def log_forward(self, key: str, t0: int, t1: int) -> None:
        """One forward of network `key`, host ns, while the profiled shape
        runs."""
        log = self.forward_log
        if log is not None:
            log.append((key, threading.get_ident(), t0, t1))

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

    def close(self) -> None:
        """Removes the rasterizer and segment-sum hooks."""
        for mod, name, orig in self._modules.values():
            setattr(mod, name, orig)


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
