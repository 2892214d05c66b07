"""One run of one cell: set-up, the measured window, the check, one JSON
line.  See benchmark/README.md."""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "pointdreamer_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc build is at <root>/build/pointdreamer_tpu_torch already)."""
    cache = os.path.join(root, "build", "benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"


def clocks() -> str:
    """The card's SM clock, power draw and temperature now (stderr
    only: a slower clock explains a slower run)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        name, limit = [s.strip() for s in out.split(",")]
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}


@dataclass
class Run:
    """What the metric readers read."""
    cell: object
    setup_s: float
    window: object
    counts: Dict[str, dict]           # network key -> its `counts(config)`
    peaks: Dict[str, float]
    trace: object
    peak_window_bytes: Optional[int]
    profiled: Optional[dict] = None   # index, wall_s, forwards {key: n}

    def plain_shapes(self):
        """The window's shapes without the profiled one, unless it is the
        only one."""
        p = self.profiled["index"] if self.profiled else None
        rest = [r for r in self.window.shapes if r.index != p]
        return rest or list(self.window.shapes)


def load_peaks(root: str) -> Dict[str, float]:
    with open(os.path.join(root, "benchmark", "roofline", "peaks.json")) as f:
        return {k: v for k, v in json.load(f).items()
                if isinstance(v, (int, float))}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: str, work: str, log=print,
             control: Optional[dict] = None) -> dict:
    """Set up, measure, check; returns the result line's object.
    `control` {'low_dtype': the core's, <network key>: that network's
    control settings}: also the readings of the reference put in the
    program's place in those precisions, under 'control'
    (benchmark/control.py)."""
    import torch

    from . import check, clouds, loop, spec, system
    from . import trace as ptrace

    t_import = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        log("card: {name}, power limit {power_limit}".format(**card()))
    traffic, config, nets = cell.traffic, cell.config, cell.networks
    clients = int(traffic["clients"])
    n_clouds = clients * (math.ceil(seconds / traffic["min_shape_s"]) + 2)
    paths: Dict[int, str] = {}

    def cloud_path(i: int) -> str:
        if i not in paths:
            xyz, rgb = clouds.cloud(seed, i, traffic["points"],
                                    traffic["parts"], traffic["kinds"])
            paths[i] = os.path.join(work, "in", f"c{i:07d}.ply")
            clouds.write_ply(paths[i], xyz, rgb)
        return paths[i]

    warm_base = 10_000_000
    for i in range(n_clouds):
        cloud_path(i)
    for i in range(clients * traffic["warmup_shapes"]):
        cloud_path(warm_base + i)

    marks = {"clouds": time.perf_counter()}
    if trace and cuda:
        ptrace.init_profiler()
    pipe = system.build(config, os.path.join(work, "out"), seed, device,
                        nets)
    obs = system.Observer(seed, pipe.cfg.optimize_iters)
    closers = [net.observe(pipe, obs, config) for net in nets.values()]
    stage_log = [] if trace else None
    prof = ptrace.Profiler(0, obs, stage_log) if trace else None
    for net in nets.values():
        net.warmup(pipe, config)
    marks["build"] = time.perf_counter()
    state = {}

    def opened():
        sync()
        for net in nets.values():
            net.opened(pipe, config)
        obs.capture = True
        if cuda:
            state["setup_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        now = time.perf_counter()
        state["setup_s"] = now - t_start
        if cuda:
            state["clocks"] = clocks()
        log("setup_s {:.3f}: imports {:.3f}, clouds {:.3f}, build {:.3f}, "
            "warm-up {:.3f}".format(
                now - t_start, t_import - t_start,
                marks["clouds"] - t_import, marks["build"] - marks["clouds"],
                now - marks["build"]))
        if cuda:
            log(f"at the window: {state['clocks']}")

    win = loop.run(pipe, obs, clients, seconds, cloud_path,
                   lambda k: warm_base + k, traffic["warmup_shapes"], opened,
                   prof.around if prof else (lambda i, go: go()),
                   stage_log)
    sync()
    if cuda:
        log(f"after the window: {clocks()}")
    for r in win.shapes:
        log(f"shape {r.index}: client {r.client}, {r.start:.3f}-{r.end:.3f}"
            " s; " + ", ".join(f"{k} {v:.3f}" for k, v in r.stages.items()))
    peak = torch.cuda.max_memory_allocated() if cuda else None
    run_peak = max(peak, state["setup_peak"]) if cuda else 0
    obs.capture = False
    for w in win.warmup:
        if w.error:
            raise RuntimeError(f"warm-up shape failed:\n{w.error}")

    def unobserved(rec):
        return check.unobserved(rec) or next(filter(None, (
            net.unobserved(rec.get(key)) for key, net in nets.items())),
            None)

    failed = []
    for r in win.shapes:
        why = r.error or "; ".join(check.file_faults(
            r.out_dir, pipe.cfg.xatlas_texture_res)) or None
        if why is None:
            why = unobserved(obs.records.get(r.index))
        if why:
            failed.append((r.index, why))
    records = {r.index: obs.records[r.index] for r in win.shapes
               if unobserved(obs.records.get(r.index)) is None}
    out_dirs = {r.index: r.out_dir for r in win.shapes}
    for close in reversed(closers):
        close()
    obs.close()
    del pipe, obs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    if prof is not None:
        prof.finish()
        tr = prof.trace
        if tr is not None:
            log(f"trace: profiler stop {prof.stop_s:.3f} s, events read in "
                f"{time.perf_counter() - t0:.3f} s; {len(tr.dev)} device "
                f"events, {int((tr.launch[:, 0] >= 0).sum())} with their "
                f"launch; forwards "
                f"{ {k: len(v) for k, v in tr.forwards.items()} }; marker "
                f"thread {tr.tid}, clock offset {tr.offset_ns} ns; launching "
                f"threads {dict(zip(*np.unique(tr.launch[:, 0], return_counts=True)))}")
    run = Run(cell, state["setup_s"], win,
              {key: net.counts(config) for key, net in nets.items()},
              load_peaks(root), prof.trace if prof else None, peak,
              prof.profiled if prof else None)
    metrics, missing = spec.read_metrics(
        cell.per_layer if trace else cell.end_to_end, run, root)
    if missing:
        log(f"metrics of this cell that read nothing: {missing}")

    def readings(ctl: dict) -> Dict[str, float]:
        """Each network's numbers on its part of the records, then the
        core's on the rest; `ctl`: the control's settings."""
        out = {}
        for key, net in nets.items():
            out.update(net.readings(
                config, {i: rec[key] for i, rec in records.items()},
                out_dirs, seed, device, ctl.get(key)))
        core = {i: {k: v for k, v in rec.items() if k not in nets}
                for i, rec in records.items()}
        low = ctl.get("low_dtype")
        out.update(check.readings(core, device,
                                  low and getattr(torch, low)))
        return out

    t0 = time.perf_counter()
    numbers = readings({})
    log(f"check: {len(records)} shapes in {time.perf_counter() - t0:.3f} s")
    low = readings(control) if control else None
    limits = config["check"]
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in cell.compared}
    ok = (not failed and len(records) == len(win.shapes) > 0
          and all(numbers[k] <= limits[k] for k in cell.compared))
    for i, why in failed:
        log(f"shape {i} failed: {why}")
    out = {"correct": bool(ok), "attempted": len(win.shapes),
           "failed": len(failed), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": int(run_peak)}}
    if trace and prof and prof.trace is not None and len(prof.trace.dev):
        tid, lo, hi = prof.trace.shape()
        busy, _ = ptrace.busy_in(prof.trace, lo, hi)
        out["device"]["busy_s"] = busy
        out["device"]["window_s"] = (hi - lo) * 1e-9
        out["breakdown"] = {"device_ops": ptrace.device_ops(prof.trace),
                            "idle_gaps": ptrace.idle_gaps(prof.trace)}
    if missing:
        out["missing"] = missing
    if low is not None:
        out["control"] = low
    out["compared"] = compared
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    from . import spec

    ap = argparse.ArgumentParser(description="One run of one benchmark "
                                 "cell of pointdreamer_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec.ROOT
    set_cache_dirs(root)
    if not os.path.isdir(os.path.join(root, "pointdreamer_tpu_torch")):
        print("pointdreamer_tpu_torch is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    cell = spec.load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="pdbench-") as work:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_start, root, work,
                       log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (the benchmark runs the "
              "port alone)", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
