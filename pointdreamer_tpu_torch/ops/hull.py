"""ctypes binding for the port's copy of the C++ HPR quickhull
(csrc/host/hull.cpp; twin of pointdreamer_tpu/native/hull.py).

Built with g++ at first use into the git-ignored build directory.  A
failed build raises: the port does not switch to another hull on its
own.  Views the C++ code flags as degenerate (return code != 0) are
recomputed by the caller with scipy's qhull, which is part of the
algorithm."""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..kernels import build_host

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def build() -> str:
    return build_host("hull.cpp")


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.hpr_visibility.restype = ctypes.c_int
            lib.hpr_visibility.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
            _LIB = lib
    return _LIB


def hpr_visibility(points: np.ndarray, eyes: np.ndarray,
                   radius_param: float = 100.0):
    """Katz spherical flip + quickhull.  Returns ([V, N] bool, [V] return
    codes; nonzero views must be recomputed)."""
    pts = np.ascontiguousarray(points, np.float64)
    ey = np.ascontiguousarray(eyes, np.float64)
    n, v = len(pts), len(ey)
    vis = np.zeros((v, n), np.uint8)
    rc = np.zeros(v, np.int32)
    _load().hpr_visibility(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        ey.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), v,
        float(radius_param),
        vis.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return vis.astype(bool), rc
