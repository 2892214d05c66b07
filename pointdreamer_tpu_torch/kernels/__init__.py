"""Build and bind the port's hand-written Hopper kernels.

The CUDA sources under `pointdreamer_tpu_torch/csrc/*.cu` (and the
headers they share: the tensor-core helpers `csrc/tc.cuh`, the face
binning of K1 and K4 `csrc/raster_bin.cuh`) have a plain C interface.
At first use they are compiled with `nvcc` for `sm_90a` (one process per
source, all started together), linked into one shared library in the
git-ignored build directory `<repo>/build/pointdreamer_tpu_torch/`, and
loaded with ctypes.  Nothing here runs at import time.  `sass_mma_counts`
counts the tensor-core instructions of each kernel in the built library.

Each wrapper (ops/raster.py for K1 and K4, models/diffusion/attention.py,
pipeline/optimize.py, kernels/groupnorm.py, kernels/winograd.py,
kernels/quant.py for K7 and K8) adds one
to its entry of `LAUNCHES` (`count_launch`, under a lock: shapes run on
several threads) where it launches its kernel, and nowhere else.  `build_host` compiles the host C++ libraries (csrc/host/*.cpp) with
g++ into the same directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "pointdreamer_tpu_torch")
SOURCES = ("raster.cu", "raster_legacy.cu", "attention.cu", "segsum.cu",
           "groupnorm.cu", "winograd.cu", "quant.cu")
HEADERS = ("tc.cuh", "raster_bin.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# H100 SXM data-sheet peaks (dense, 700 W), from which chip_smoke.py and
# profile_unet.py work out the least time a kernel or a forward could take
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12        # tensor-core bf16
INT8_OPS_PER_S = 1979e12       # tensor-core int8
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores

LAUNCHES: Dict[str, int] = {"raster_binned": 0, "raster_legacy": 0,
                            "attention_qkv": 0, "segment_sum": 0,
                            "groupnorm": 0, "winograd_conv3x3": 0,
                            "quantize_act": 0, "int8_conv": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pd_bin_pixel_boxes": [_P, _I, _I, _I, _I, _P, _P, _P],
    "pd_bin_xy_boxes": [_P, _I, _I, _I, _I, _P, _P, _P],
    "pd_raster_tiles": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "pd_raster_legacy": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "pd_attention_qkv": [_P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "pd_segment_sum": [_P, _P, ctypes.c_int64, _I, _I, _I, _P, _P],
    "pd_groupnorm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, ctypes.c_float, _P],
    "pd_groupnorm_limits": [_P],
    "pd_groupnorm_max_clusters": [_I, _I, _I],
    "pd_winograd_conv3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pd_quantize_act": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "pd_int8_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P],
}


_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built where the CUDA toolkit is installed")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile every source (in parallel) and link one .so; returns its
    path.  Reuses a library built from the same sources and flags.  What
    `-Xptxas -v` says of each kernel (registers, shared memory, spills) is
    kept beside it in `<so>.ptxas.txt`."""
    out = os.path.join(BUILD_DIR, f"libpd_kernels_{_source_hash()}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs, objs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 os.path.join(CSRC, name), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed, logs = [], []
        for name, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            logs.append(f"== {name}\n{log}")
            if p.returncode:
                failed.append(f"{name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], *objs, "-o", so],
                       check=True)
        with open(out + ".ptxas.txt", "w") as f:
            f.write("\n".join(logs))
        os.replace(so, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


MMA_OPCODES = ("HMMA", "HGMMA", "IMMA", "IGMMA")


def mma_counts(sass: str) -> Dict[str, int]:
    """Tensor-core instructions (HMMA, HGMMA, and the int8 IMMA, IGMMA) in
    each function of a `cuobjdump -sass` listing, by the function's
    (mangled) name."""
    counts: Dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        head = line.strip()
        if head.startswith("Function : "):
            name = head[len("Function : "):].strip()
            counts.setdefault(name, 0)
        elif name is not None and any(op in line for op in MMA_OPCODES):
            counts[name] += 1
    return counts


def sass_mma_counts(path: str) -> Dict[str, int]:
    """`mma_counts` of the built library at `path` (cuobjdump from the
    toolkit that holds nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    return mma_counts(sass)


def build_host(source: str) -> str:
    """Compile the host C++ library csrc/host/<source> with g++ into
    BUILD_DIR/libpd_<stem>.so (rebuilt when the source is newer); returns
    its path.  A failed build raises."""
    src = os.path.join(CSRC, "host", source)
    out = os.path.join(BUILD_DIR,
                       f"libpd_{os.path.splitext(source)[0]}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", src,
                        "-o", tmp], check=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


# PyTorch's own raw-stream query (what its generated kernel launchers
# call): an int, without building a Stream object for every launch
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device: torch.device) -> int:
    if _RAW_STREAM is not None and device.index is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda_tensor(t: torch.Tensor, name: str, dtype,
                        ndim: Optional[int] = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
