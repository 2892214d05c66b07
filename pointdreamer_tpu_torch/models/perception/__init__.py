"""Perception feature extractors for the evaluation protocol (twin of
models/perception/__init__.py): the two pretrained networks the
reference's evaluation relies on (data/run_evaluation.py:141-215,
utils/metric_utils/inception.py).

- ``VGG16Features`` / ``LPIPS``: lpips.LPIPS(net='vgg').
- ``InceptionV3Features``: torchvision inception_v3 pool3 features (FID).

Weights are the published torch files (convert.py maps them).  Both
loaders compute in fp32 with TF32 off inside their own call (cuDNN would
otherwise run fp32 convolutions in TF32), and put the caller's TF32
settings back after it.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .inception import InceptionV3Features
from .vgg import LPIPS, VGG16Features

# the TF32 switches are process-wide: calls from several threads (shapes in
# flight in pipeline/batch.py) take turns, so each restores what it found
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def _fp32_exact():
    """No TF32 in cuDNN convolutions or cuBLAS matmuls inside the block;
    the caller's settings come back after it."""
    with _TF32_LOCK:
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved


def _load_torch_state_dict(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _images(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def load_inception_features(ckpt_path: str, batch: int = 32,
                            device="cuda"):
    """torchvision inception_v3 state dict -> callable embedding images
    [N,H,W,3] in [0,1] (numpy or tensor) to pool3 features [N,2048]
    (numpy): the FID embedding of reference
    utils/metric_utils/inception.py."""
    from ...pipeline.pipeline import resolve_device
    from .convert import convert_inception_state_dict

    dev = resolve_device(device)
    model = InceptionV3Features()
    model.load_state_dict(convert_inception_state_dict(
        _load_torch_state_dict(ckpt_path)))
    model = model.to(dev).eval()

    def feats(images):
        x = _images(images, dev)
        with _fp32_exact():
            out = [model(x[s:s + batch]).cpu().numpy()
                   for s in range(0, len(x), batch)]
        return np.concatenate(out, 0)

    return feats


def load_lpips(vgg_ckpt_path: str, lpips_ckpt_path: str, batch: int = 16,
               device="cuda"):
    """torchvision vgg16 + lpips vgg.pth lin heads -> callable lpips(a, b)
    over images [N,H,W,3] in [0,1] -> [N] distances (numpy); the inputs
    go in as x*2-1 (reference run_evaluation.py:141-160)."""
    from ...pipeline.pipeline import resolve_device
    from .convert import convert_lpips_state_dict

    dev = resolve_device(device)
    model = LPIPS()
    model.load_state_dict(convert_lpips_state_dict(
        _load_torch_state_dict(vgg_ckpt_path),
        _load_torch_state_dict(lpips_ckpt_path)))
    model = model.to(dev).eval()

    def dist(a, b):
        a = _images(a, dev) * 2.0 - 1.0
        b = _images(b, dev) * 2.0 - 1.0
        with _fp32_exact():
            out = [model(a[s:s + batch], b[s:s + batch]).cpu().numpy()
                   for s in range(0, len(a), batch)]
        return np.concatenate(out, 0)

    return dist


__all__ = ["InceptionV3Features", "LPIPS", "VGG16Features",
           "load_inception_features", "load_lpips"]
