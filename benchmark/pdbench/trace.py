"""One shape under torch.profiler, kept as plain arrays, and the
reductions the per-layer readers make of it.

Only device activity is traced: each device event (kernel, copy, set)
and the CUDA runtime call that launched it, which gives the launching
thread and the host time of the launch.  The harness keeps its own
ranges on the host clock (the profiled shape, its stages, its networks'
forwards) and moves them onto the trace's clock by two marker kernels
launched at known host times."""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Trace:
    """Device events of the profiled shape and the harness's host ranges
    on the trace's clock (ns)."""
    names: List[str]                 # device event names
    dev: np.ndarray                  # [n, 3] int64: start, end, name index
    launch: np.ndarray               # [n, 2] int64: thread, host time of
    #                                  the launch (-1, -1 where unknown)
    tid: int                         # the profiled shape's thread, as
    #                                  the trace names it (-1: unknown)
    lo: int                          # the profiled shape's start and end
    hi: int
    stages: List[Tuple[str, int, int]] = field(default_factory=list)
    forwards: Dict[str, List[Tuple[int, int]]] = field(
        default_factory=dict)        # by network key: of every client,
    #                                  within the shape
    offset_ns: int = 0               # trace clock minus host clock

    def shape(self) -> Tuple[int, int, int]:
        """(thread, start ns, end ns) of the profiled shape."""
        return self.tid, self.lo, self.hi


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _ns(ev, which: str) -> int:
    f = getattr(ev, which + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, which + "_us")() * 1000)


def from_profile(prof, host: dict) -> Trace:
    """The device events of a finished `torch.profiler.profile` (device
    activity only), each tied to its launch (the CUDA runtime call with
    its correlation id: thread and host time), and the harness's host
    ranges `host` {markers: [ns], shape: (t0, t1), stages: [(name, t0,
    t1)], forwards: {key: [(t0, t1)]}} moved onto the trace's clock by
    the marker kernels launched at known host times."""
    from torch.autograd import DeviceType

    names, idx, dev, corrs = [], {}, [], []
    launches: Dict[int, Tuple[int, int]] = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        if ev.device_type() == DeviceType.CPU:
            if RUNTIME.match(name):
                launches[ev.correlation_id()] = (ev.start_thread_id(), start)
            continue
        if ev.is_user_annotation():
            continue
        end = start + int(ev.duration_ns()) if hasattr(ev, "duration_ns") \
            else _ns(ev, "end")
        if name not in idx:
            idx[name] = len(names)
            names.append(name)
        dev.append((start, end, idx[name]))
        corrs.append(ev.correlation_id())
    dev = np.array(dev, np.int64).reshape(-1, 3)
    launch = np.array([launches.get(c, (-1, -1)) for c in corrs],
                      np.int64).reshape(-1, 2)
    # each marker kernel's launch is matched with the host marker nearest
    # to it: the two clocks differ by far less than the shape between
    marks = [i for i, n in enumerate(names) if MARKER in n]
    sel = np.flatnonzero(np.isin(dev[:, 2], marks) & (launch[:, 1] >= 0))
    tid, offset = -1, 0
    if len(sel):
        want = np.array(host["markers"], np.int64)
        got = launch[sel, 1]
        near = np.abs(got[:, None] - want[None, :]).argmin(1)
        offset = int(np.median(got - want[near]))
        tid = int(launch[sel[0], 0])
    t0, t1 = host["shape"]
    return Trace(names, dev, launch, tid, t0 + offset, t1 + offset,
                 [(n, a + offset, b + offset) for n, a, b in host["stages"]],
                 {k: [(a + offset, b + offset) for a, b in iv]
                  for k, iv in host["forwards"].items()},
                 offset)


def union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end] intervals of [n, 2] intervals, in order."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.r_[last[1:] - 1, len(iv) - 1]]
    return np.stack([starts, stops], 1)


def busy_in(tr: Trace, lo: int, hi: int) -> Tuple[float, np.ndarray]:
    """(seconds some device event ran within [lo, hi], the merged busy
    intervals clipped to it)."""
    iv = np.clip(tr.dev[:, :2], lo, hi)
    iv = union(iv[iv[:, 1] > iv[:, 0]])
    return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9, iv


def idle_gaps(tr: Trace, top: int = 10) -> List[List]:
    """The longest gaps with no device event inside the profiled shape,
    each named by the innermost stage its thread had open at the gap's
    middle."""
    _, lo, hi = tr.shape()
    _, iv = busy_in(tr, lo, hi)
    edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    out = []
    for s, e in sorted(gaps.tolist(), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        inner = [(b - a, n) for n, a, b in tr.stages if a <= mid <= b]
        out.append([min(inner)[1] if inner else "between stages",
                    (e - s) * 1e-9])
    return out


def device_ops(tr: Trace, top: int = 10) -> List[List]:
    """Device time by event name within the profiled shape, largest
    first."""
    _, lo, hi = tr.shape()
    iv = np.clip(tr.dev[:, :2], lo, hi)
    dur = (iv[:, 1] - iv[:, 0]).clip(min=0)
    tot = np.bincount(tr.dev[:, 2], weights=dur, minlength=len(tr.names))
    order = np.argsort(-tot)[:top]
    return [[tr.names[i][:120], float(tot[i]) * 1e-9] for i in order
            if tot[i] > 0]


def kernel_time(tr: Trace, pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the device events whose name matches
    `pattern`, within the profiled shape."""
    _, lo, hi = tr.shape()
    rx = re.compile(pattern)
    ids = [i for i, n in enumerate(tr.names) if rx.search(n)]
    sel = np.isin(tr.dev[:, 2], ids) & (tr.dev[:, 0] >= lo) \
        & (tr.dev[:, 1] <= hi)
    d = tr.dev[sel]
    return float((d[:, 1] - d[:, 0]).sum()) * 1e-9, int(sel.sum())


def forward_device_s(tr: Trace, forwards) -> Optional[float]:
    """Mean device seconds of a forward: the device events launched while
    one of `forwards` [(start, end)] (of some client, on the trace's
    clock) ran, over those forwards.  With two clients, a launch of one
    client's other stages during the other's forward counts too (a small
    share)."""
    if not forwards or not len(tr.dev):
        return None
    iv = union(np.array(forwards, np.int64))
    at = tr.launch[:, 1]
    k = np.searchsorted(iv[:, 0], at, side="right") - 1
    inside = (at >= 0) & (k >= 0) & (at <= iv[np.clip(k, 0, None), 1])
    total = float((tr.dev[inside, 1] - tr.dev[inside, 0]).sum()) * 1e-9
    return total / len(forwards) if total > 0 else None


def init_profiler() -> None:
    """Starts and stops the profiler once in this (the main) thread, so
    the device tracer is set up before a client thread profiles."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def marker() -> int:
    """Launches a short marker kernel and returns the host time (ns) just
    before its launch; the trace's copy of the launch gives the offset
    between the two clocks."""
    t = time.time_ns()
    torch.cuda._sleep(1000)
    return t


class Profiler:
    """Wraps one shape of the window in torch.profiler's device activity
    (kernels, copies, sets and the runtime calls that launched them; no
    host-op recording, which would slow the host); `finish` reads the
    events into a `Trace` once the window has closed.  The harness's own
    ranges are host times: the shape's, its thread's stages (from the
    stage timer) and the networks' forwards (from the observer).
    `profiled`: the shape's index, its wall seconds and, by network key,
    the forwards of any client that ran within it (for `mfu`)."""

    def __init__(self, index: int, observer, stage_log: list):
        self.index, self.observer, self.stage_log = index, observer, stage_log
        self.trace: Optional[Trace] = None
        self.profiled: Optional[dict] = None
        self.stop_s = 0.0
        self._prof = None
        self._host = None

    def around(self, index: int, go) -> None:
        if index != self.index or not torch.cuda.is_available():
            go()
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        self.observer.forward_log = []
        marks = [marker()]
        torch.cuda.synchronize()
        t0 = time.time_ns()
        try:
            go()
            torch.cuda.synchronize()
        finally:
            t1 = time.time_ns()
            marks.append(marker())
            torch.cuda.synchronize()
            log, self.observer.forward_log = self.observer.forward_log, None
            prof.stop()
            self.stop_s = (time.time_ns() - t1) * 1e-9
        self._prof = prof
        inside: Dict[str, List[Tuple[int, int]]] = {}
        for key, _, a, b in log:
            if t0 <= a and b <= t1:
                inside.setdefault(key, []).append((a, b))
        self._host = {
            "markers": marks, "shape": (t0, t1),
            "stages": [(n, a, b) for i, n, a, b in self.stage_log
                       if i == index],
            "forwards": inside}
        self.profiled = {"index": index, "wall_s": (t1 - t0) * 1e-9,
                         "forwards": {k: len(v) for k, v in inside.items()}}

    def finish(self) -> None:
        if self._prof is not None:
            self.trace = from_profile(self._prof, self._host)
            self._prof = None
