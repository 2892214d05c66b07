"""The port's own spans (`pointdreamer_tpu_torch.log.INTERVALS`: each span
that ended while the profiler recorded, of every client) moved onto the
device trace's clock, and what the readers make of them beside the
trace.  A program that keeps no span log gives None, as a run with no
trace does."""
from __future__ import annotations

import importlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from . import trace as ptrace


class Span(NamedTuple):
    shape: str
    name: str
    parent: Optional[str]
    thread: int                      # the Python thread ident
    t0: int                          # ns on the trace's clock
    t1: int


def shape_name(index: int) -> str:
    """The name `loop.py` gives shape `index`."""
    return f"s{index:07d}"


def logged(run) -> Optional[List[Span]]:
    """Every span the program logged while the profiler recorded (of any
    shape, so of every client), on the trace's clock; None without a
    trace or a span log."""
    tr = run.trace
    if tr is None or not run.profiled:
        return None
    try:
        log = importlib.import_module("pointdreamer_tpu_torch.log")
    except ImportError:
        return None
    intervals = getattr(log, "INTERVALS", None)
    if intervals is None:
        return None
    off = tr.offset_ns
    return [Span(s, n, p, th, a + off, b + off)
            for s, n, p, th, a, b in list(intervals)] or None


def profiled(run) -> Optional[List[Span]]:
    """The profiled shape's own spans on the trace's clock, or None."""
    want = shape_name(run.profiled["index"]) if run.profiled else None
    out = [s for s in logged(run) or () if s.shape == want]
    return out or None


def within_shape(run) -> Optional[List[Span]]:
    """The spans of any client that began and ended within the profiled
    shape, or None."""
    if run.trace is None:
        return None
    _, lo, hi = run.trace.shape()
    out = [s for s in logged(run) or () if lo <= s.t0 and s.t1 <= hi]
    return out or None


def named(spans: Optional[List[Span]], name: str) -> np.ndarray:
    """[n, 2] start, end of the spans called `name`, in order."""
    iv = [(s.t0, s.t1) for s in spans or () if s.name == name]
    return np.array(sorted(iv), np.int64).reshape(-1, 2)


def idle_share(tr, lo: int, hi: int) -> Optional[float]:
    """Percent of [lo, hi] in which no device event of any thread ran."""
    if hi <= lo:
        return None
    busy, _ = ptrace.busy_in(tr, lo, hi)
    return 100.0 * (1.0 - busy / ((hi - lo) * 1e-9))


def _idle(tr, lo: int, hi: int) -> np.ndarray:
    """[n, 2] the idle intervals of [lo, hi]."""
    _, iv = ptrace.busy_in(tr, lo, hi)
    edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def _upto(iv: np.ndarray, t: np.ndarray) -> np.ndarray:
    """ns of the sorted disjoint intervals `iv` [n, 2] before each time of
    `t`."""
    if not len(iv):
        return np.zeros(len(t), np.int64)
    lens = iv[:, 1] - iv[:, 0]
    before = np.concatenate([[0], np.cumsum(lens)])
    k = np.searchsorted(iv[:, 0], t, side="right") - 1
    kk = np.clip(k, 0, None)
    part = np.clip(t - iv[kk, 0], 0, lens[kk])
    return np.where(k >= 0, before[kk] + part, 0)


def _within(iv: np.ndarray, of: np.ndarray) -> int:
    """ns of the sorted disjoint intervals `iv` inside the intervals
    `of` [m, 2] (merged first)."""
    of = ptrace.union(of)
    if not len(of):
        return 0
    return int((_upto(iv, of[:, 1]) - _upto(iv, of[:, 0])).sum())


def idle_by_span(tr, spans: List[Span]) -> Dict[str, float]:
    """Idle device seconds of the profiled shape by the innermost span its
    own thread (the thread of its top-level stages) had open, all of it:
    the keys are span names and 'between stages'; the values add up to
    the shape's idle seconds."""
    _, lo, hi = tr.shape()
    idle = _idle(tr, lo, hi)
    top = [s for s in spans if s.parent is None and "." not in s.name]
    own = [s for s in spans if top and s.thread == top[0].thread]
    # elementary pieces between every span edge; each goes to the
    # shortest span open over it (spans of one thread nest)
    cuts = np.unique(np.clip(np.array(
        [lo, hi] + [t for s in own for t in (s.t0, s.t1)], np.int64),
        lo, hi))
    secs = np.diff(_upto(idle, cuts)) * 1e-9
    out: Dict[str, float] = {}
    for a, b, x in zip(cuts[:-1].tolist(), cuts[1:].tolist(),
                       secs.tolist()):
        if x <= 0:
            continue
        inner = [(s.t1 - s.t0, s.name) for s in own
                 if s.t0 <= a and b <= s.t1]
        key = min(inner)[1] if inner else "between stages"
        out[key] = out.get(key, 0.0) + x
    return out


def sampler_idle_split(tr, spans: List[Span], beside: str = "unwrap.thread"
                       ) -> Optional[Dict[str, float]]:
    """The sampler's idle share (percent) while a `beside` span is open and
    while none is, with the seconds of each part: how much the io thread's
    host work holds the launch-bound sampler back."""
    steps = named(spans, "inpaint.step")
    if not len(steps):
        return None
    lo, hi = int(steps[:, 0].min()), int(steps[:, 1].max())
    other = np.clip(named(spans, beside), lo, hi)
    other = ptrace.union(other[other[:, 1] > other[:, 0]])
    idle = _idle(tr, lo, hi)
    during = int((other[:, 1] - other[:, 0]).sum())
    idle_during = _within(idle, other)
    idle_all = _within(idle, np.array([[lo, hi]], np.int64))
    rest = (hi - lo) - during
    return {"open_s": during * 1e-9, "closed_s": rest * 1e-9,
            "idle_open": 100.0 * idle_during / during if during else None,
            "idle_closed": (100.0 * (idle_all - idle_during) / rest
                            if rest else None)}
