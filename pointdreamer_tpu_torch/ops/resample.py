"""PIL's separable resampling of 8-bit images, in numpy.

`resize_uint8(img, (w, h), filt)` computes what `PIL.Image.resize(size,
resample)` gives for an RGB image (Pillow's libImaging/Resample.c):

- each filter's support (BOX 0.5, BILINEAR 1, BICUBIC 2 with a = -0.5) is
  scaled by the downscale factor, when it is above 1;
- the weights of each output pixel are normalised in double precision,
  then turned into fixed point with 22 fractional bits (rounded away from
  zero);
- the horizontal pass runs first, then the vertical one, each summing in
  integers from a bias of one half and shifting back, with a clip to
  uint8 between the two passes.

A pass runs only on an axis whose size changes, as in PIL.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _box(x):
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


FILTERS = {"box": (_box, 0.5), "bilinear": (_bilinear, 1.0),
           "bicubic": (_bicubic, 2.0)}


def coefficients(in_size: int, out_size: int, filt: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(xmin [out], fixed-point weights [out, ksize] int64) of one axis
    (Resample.c precompute_coeffs + normalize_coeffs_8bpc)."""
    fn, support = FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; negatives are clamped to 0
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    live = x[None, :] < xmax[:, None]
    w = fn((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
           * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):                 # the C loop's summation order
        ww = ww + w[:, j]
    nz = ww != 0.0
    w = np.where(nz[:, None], w / np.where(nz, ww, 1.0)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, filt: str, axis: int) -> np.ndarray:
    """One 8bpc pass along `axis` (1: horizontal, 0: vertical) of uint8
    [H, W, C]."""
    in_size = img.shape[axis]
    xmin, k = coefficients(in_size, out_size, filt)
    src = np.moveaxis(img, axis, 0).astype(np.int64)        # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += src[idx] * k[:, j, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_uint8(img: np.ndarray, size: Tuple[int, int],
                 filt: str) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [h, w, C] for size = (w, h), PIL's order;
    `filt` one of 'box', 'bilinear', 'bicubic'."""
    w, h = size
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = _pass(out, w, filt, 1)
    if out.shape[0] != h:
        out = _pass(out, h, filt, 0)
    return out


def crop_uint8(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """PIL's `Image.crop((left, upper, right, lower))`: pixels outside the
    image are black."""
    left, upper, right, lower = box
    h, w = img.shape[:2]
    out = np.zeros((lower - upper, right - left) + img.shape[2:], np.uint8)
    y0, y1 = max(upper, 0), min(lower, h)
    x0, x1 = max(left, 0), min(right, w)
    if y0 < y1 and x0 < x1:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out
