"""The closed loop: `clients` threads share one Pipeline; each takes the
next cloud when its last shape is done, and starts shapes until
`seconds` have passed since the window opened.  The window closes when
every shape started in it is done, so it always holds whole shapes.

Each client warms up on shapes of its own, in its own thread, before the
window opens (per-thread library handles are made there)."""
from __future__ import annotations

import os
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import system


@dataclass
class ShapeRun:
    index: int
    client: int
    start: float             # seconds since the window opened
    end: float
    stages: Dict[str, float]
    out_dir: str
    error: Optional[str] = None


@dataclass
class Window:
    opened: float = 0.0      # perf_counter at the window's start
    seconds: float = 0.0     # opening to the last shape's end
    shapes: List[ShapeRun] = field(default_factory=list)
    warmup: List[ShapeRun] = field(default_factory=list)


def run(pipe, observer, clients: int, seconds: float,
        cloud_path: Callable[[int], str], warmup_index: Callable[[int], int],
        warmups: int, opened: Callable[[], None],
        around_shape: Callable[[int, Callable[[], None]], None],
        stage_log: Optional[list] = None) -> Window:
    """Warm up, call `opened()`, run the window, return what it did.
    `cloud_path(i)` is the .ply of shape i; `around_shape(i, go)` runs
    `go()` (the profiled shape is wrapped in the profiler there).  With a
    `stage_log`, the window's shapes log their stages into it."""
    win = Window()
    lock = threading.Lock()
    ready = threading.Barrier(clients + 1)
    start = threading.Event()
    counter = [0]

    def one(index: int, client: int, warm: bool) -> ShapeRun:
        timer = system.stage_timer(index, None if warm else stage_log)
        name = f"s{index:07d}"
        observer.begin_shape(None if warm else index)
        t0 = time.perf_counter()
        err = None
        try:
            if warm:
                pipe.recon_one_textured_mesh(cloud_path(index), name, timer)
            else:
                around_shape(index, lambda: pipe.recon_one_textured_mesh(
                    cloud_path(index), name, timer))
        except Exception:
            err = traceback.format_exc()
        t1 = time.perf_counter()
        observer.end_shape()
        return ShapeRun(index, client, t0 - win.opened, t1 - win.opened,
                        dict(timer.times),
                        os.path.join(pipe.cfg.output_path, name), err)

    errors = []

    def client(c: int) -> None:
        try:
            for k in range(warmups):
                r = one(warmup_index(c * warmups + k), c, True)
                with lock:
                    win.warmup.append(r)
        except BaseException as e:       # reported by the main thread
            errors.append(e)
        ready.wait()
        start.wait()
        while not errors:
            with lock:
                if time.perf_counter() - win.opened >= seconds:
                    return
                i = counter[0]
                counter[0] += 1
            r = one(i, c, False)
            with lock:
                win.shapes.append(r)

    threads = [threading.Thread(target=client, args=(c,),
                                name=f"pdbench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    ready.wait()
    if errors:
        start.set()
        for t in threads:
            t.join()
        raise errors[0]
    opened()
    win.opened = time.perf_counter()
    start.set()
    for t in threads:
        t.join()
    win.seconds = time.perf_counter() - win.opened
    win.shapes.sort(key=lambda r: r.index)
    return win
