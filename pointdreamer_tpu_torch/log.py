"""Logging + per-stage wall-clock timing (twin of core/log.py).

With `sync=True` a stage ends with `torch.cuda.synchronize()` so the time
of asynchronous device work lands in the stage that queued it."""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional

import torch


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
    """Accumulates named stage timings for one pipeline run."""

    def __init__(self, logger=None, sync: bool = True):
        self.logger = logger
        self.sync = sync
        self.times: Dict[str, float] = {}
        self.order: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield {}
        finally:
            if self.sync and torch.cuda.is_available() \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if name not in self.order:
                self.order.append(name)
            if self.logger:
                self.logger.info(f"{name}: {dt:.3f} s")

    def record(self, name: str, seconds: float):
        """Adds a time measured elsewhere (a host thread's own wall or CPU
        time) under `name`, with no device sync."""
        self.times[name] = self.times.get(name, 0.0) + seconds
        if name not in self.order:
            self.order.append(name)
        if self.logger:
            self.logger.info(f"{name}: {seconds:.3f} s")

    def total(self) -> float:
        """Sum of the top-level stages ('a.b' is a part of stage 'a')."""
        return sum(v for k, v in self.times.items() if "." not in k)

    def report(self) -> str:
        lines = [f"  {k}: {self.times[k]:.3f} s" for k in self.order]
        lines.append(f"  total: {self.total():.3f} s")
        return "\n".join(lines)
