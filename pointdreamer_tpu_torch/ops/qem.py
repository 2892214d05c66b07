"""ctypes binding for the port's copy of the C++ quadric-error edge
collapse (csrc/host/qem.cpp; twin of pointdreamer_tpu/native/qem.py).

Built with g++ at first use into the git-ignored build directory.  A
failed build raises: the port has no other decimation to fall back on."""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from ..kernels import build_host

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def build() -> str:
    return build_host("qem.cpp")


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.qem_simplify.restype = ctypes.c_int
            lib.qem_simplify.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
            _LIB = lib
    return _LIB


def simplify(vertices: np.ndarray, faces: np.ndarray,
             target_faces: int) -> Tuple[np.ndarray, np.ndarray]:
    """QEM edge collapse to ~target_faces.  Returns (verts, faces)."""
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    if len(f) <= target_faces:
        return v, f
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv = ctypes.c_int(0)
    nf = ctypes.c_int(0)
    rc = _load().qem_simplify(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        int(target_faces),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(nv),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError(f"qem_simplify failed rc={rc}")
    return out_v[: nv.value].copy(), out_f[: nf.value].copy()
