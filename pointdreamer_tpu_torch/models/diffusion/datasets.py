"""Image-folder datasets of the standalone DDNM restoration CLI (twin of
models/diffusion/datasets.py; reference models/DDNM/datasets/__init__.py
get_dataset, center_crop_arr, Crop, data_transform /
inverse_data_transform).

Every dataset is a folder of images on disk, preprocessed with the
reference's crop and resize semantics as PIL computes them, here on uint8
numpy arrays (`ops/resample.py`, bit-equal to PIL's 8-bit resampling):

- ImageNet / LSUN / OOD: center_crop_arr (guided-diffusion's BOX halving,
  BICUBIC scale, centre crop), datasets/__init__.py:29-44;
- CelebA: the fixed (cx = 89, cy = 121) 128^2 face crop, then BICUBIC,
  :64-71;
- CIFAR10: BILINEAR to the square, :49-50.

Images are read through the port's `io.load_rgb_uint8`, which tells the
format of each file of IMG_EXTS by its content, as PIL does, and decodes
it to the pixels PIL's convert("RGB") gives.  Batches come out NHWC float32 in [0,1].
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ... import io as pio
from ...ops.resample import crop_uint8, resize_uint8

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".ppm")

# CelebA face-crop box (reference datasets/__init__.py:64-69)
_CELEBA_CX, _CELEBA_CY = 89, 121


def _size(arr: np.ndarray) -> Tuple[int, int]:
    return arr.shape[1], arr.shape[0]            # PIL's (width, height)


def center_crop_arr(arr: np.ndarray, image_size: int = 256) -> np.ndarray:
    """openai/guided-diffusion preprocessing (reference :29-44) of a uint8
    [H, W, 3] image."""
    while min(*_size(arr)) >= 2 * image_size:
        arr = resize_uint8(arr, tuple(x // 2 for x in _size(arr)), "box")
    scale = image_size / min(*_size(arr))
    arr = resize_uint8(arr, tuple(round(x * scale) for x in _size(arr)),
                       "bicubic")
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy:cy + image_size, cx:cx + image_size]


def celeba_crop_arr(arr: np.ndarray, image_size: int = 256) -> np.ndarray:
    """The fixed 128^2 face crop, then a resize (reference :64-71)."""
    x1, x2 = _CELEBA_CY - 64, _CELEBA_CY + 64
    y1, y2 = _CELEBA_CX - 64, _CELEBA_CX + 64
    arr = crop_uint8(arr, (y1, x1, y2, x2))
    return resize_uint8(arr, (image_size, image_size), "bicubic")


def resize_arr(arr: np.ndarray, image_size: int = 256) -> np.ndarray:
    """transforms.Resize to the square (reference :49-50)."""
    return resize_uint8(arr, (image_size, image_size), "bilinear")


_PREPROC = {
    "IMAGENET": center_crop_arr,
    "LSUN": center_crop_arr,
    "OOD": center_crop_arr,
    "CELEBA": celeba_crop_arr,
    "CIFAR10": resize_arr,
}


def list_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTS):
                out.append(os.path.join(dirpath, f))
    return out


class ImageFolderDataset:
    """Folder-of-images dataset with the reference's preprocessing; `kind`
    picks the crop (an unknown kind takes center_crop_arr)."""

    def __init__(self, root: str, image_size: int = 256,
                 kind: str = "IMAGENET", limit: Optional[int] = None):
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"dataset root {root!r} does not exist; DDNM datasets are "
                "folders of images here")
        self.files = list_images(root)
        if limit:
            self.files = self.files[:limit]
        if not self.files:
            raise FileNotFoundError(f"no images under {root!r}")
        self.image_size = image_size
        self.preproc = _PREPROC.get(kind.upper(), center_crop_arr)

    def __len__(self) -> int:
        return len(self.files)

    def crop_uint8(self, i: int) -> np.ndarray:
        """The i-th image, preprocessed: uint8 [S, S, 3]."""
        return self.preproc(pio.load_rgb_uint8(self.files[i]),
                            self.image_size)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.crop_uint8(i).astype(np.float32) / 255.0

    def batches(self, batch_size: int) -> Iterator[Tuple[List[str],
                                                         np.ndarray]]:
        """(filenames, [B,H,W,3] float32 in [0,1]); the last batch may be
        short."""
        for s in range(0, len(self), batch_size):
            idx = range(s, min(s + batch_size, len(self)))
            yield ([self.files[i] for i in idx],
                   np.stack([self[i] for i in idx]))


def get_dataset(name: str, root: str, image_size: int = 256,
                limit: Optional[int] = None) -> ImageFolderDataset:
    """Reference get_dataset (:47-201) on the folder layout; `name` in
    {IMAGENET, CELEBA, LSUN, OOD, CIFAR10, ...}."""
    return ImageFolderDataset(root, image_size, kind=name, limit=limit)


def data_transform(x: np.ndarray) -> np.ndarray:
    """[0,1] -> [-1,1] (rescaled=True, reference :208-223)."""
    return 2.0 * x - 1.0


def inverse_data_transform(x: np.ndarray) -> np.ndarray:
    """[-1,1] -> clipped [0,1] (reference :225-236)."""
    return np.clip((x + 1.0) / 2.0, 0.0, 1.0)
