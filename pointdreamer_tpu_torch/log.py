"""Logging, per-stage wall-clock timing and the spans inside a stage
(twin of core/log.py).

A `StageTimer` keeps one shape's seconds by name.  `stage(name)` times a
part of the pipeline; with `sync=True` it ends with
`torch.cuda.synchronize()`, timed on its own as `<name>.sync`, so the
time of asynchronous device work lands in the stage that queued it.
Inside a stage, `span(name)` (this module's, or a timer's from another
thread) times a part of it on the host alone: no sync, nothing that
waits for the card.  Names inside a stage are dotted (`inpaint.step`),
so the undotted names and `total()` are the top-level stages alone.

Spans nest per thread: opening a stage or a timer's span makes that
timer the thread's current one until it closes, and the innermost open
span is the parent of the next.  While a torch.profiler session records,
each finished span is also appended to `INTERVALS` as (shape, name,
parent, thread ident, start ns, end ns) on `time.time_ns()`'s clock, to
be set beside the device trace."""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

# (shape, name, parent, thread ident, start ns, end ns) of the spans that
# ended while a profiler recorded; the newest are kept
INTERVALS: Deque[Tuple[str, str, Optional[str], int, int, int]] = \
    collections.deque(maxlen=1 << 16)
_open = threading.local()        # .stack: [(timer, name)] of open spans


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str):
    """A host-only span `name` under this thread's current timer (the
    timer of its innermost open stage or span); nothing with none, as
    when the sampler is called outside a pipeline."""
    stack = getattr(_open, "stack", None)
    if not stack:
        return contextlib.nullcontext()
    return stack[-1][0].span(name)


def get_logger(log_file: Optional[str] = None,
               name: str = "pointdreamer_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s",
                            datefmt="%H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class StageTimer:
    """Accumulates named stage and span timings for one pipeline run of
    the shape `shape`."""

    def __init__(self, logger=None, sync: bool = True):
        self.logger = logger
        self.sync = sync
        self.shape = ""
        self.times: Dict[str, float] = {}
        self.order: List[str] = []

    def _add(self, name: str, seconds: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds
        if name not in self.order:
            self.order.append(name)

    def _begin(self, name: str) -> Tuple[Optional[str], int]:
        stack = _stack()
        parent = stack[-1][1] if stack else None
        stack.append((self, name))
        return parent, time.time_ns()

    def _end(self, name: str, parent: Optional[str], t0: int) -> float:
        t1 = time.time_ns()
        _stack().pop()
        dt = (t1 - t0) * 1e-9
        self._add(name, dt)
        if torch.autograd.profiler._is_profiler_enabled:
            INTERVALS.append((self.shape, name, parent,
                              threading.get_ident(), t0, t1))
        return dt

    @contextlib.contextmanager
    def span(self, name: str, cpu: bool = False):
        """A host-only span `name` in this thread (the io thread's own,
        for one); with `cpu`, the thread's CPU seconds in it are added
        as `<name>_cpu`."""
        c0 = time.thread_time() if cpu else 0.0
        parent, t0 = self._begin(name)
        try:
            yield
        finally:
            self._end(name, parent, t0)
            if cpu:
                self._add(name + "_cpu", time.thread_time() - c0)

    @contextlib.contextmanager
    def stage(self, name: str):
        parent, t0 = self._begin(name)
        try:
            yield {}
        finally:
            if self.sync and torch.cuda.is_available() \
                    and torch.cuda.is_initialized():
                with self.span(name + ".sync"):
                    torch.cuda.synchronize()
            dt = self._end(name, parent, t0)
            if self.logger:
                self.logger.info(f"{name}: {dt:.3f} s")

    def total(self) -> float:
        """Sum of the top-level stages ('a.b' is a part of stage 'a')."""
        return sum(v for k, v in self.times.items() if "." not in k)

    def report(self) -> str:
        lines = [f"  {k}: {self.times[k]:.3f} s" for k in self.order]
        lines.append(f"  total: {self.total():.3f} s")
        return "\n".join(lines)
