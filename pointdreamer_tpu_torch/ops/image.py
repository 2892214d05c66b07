"""Batched 2D image ops (twin of ops/image.py).

scharr_edges, dilate, erode, morph_close, bilateral_filter,
inner_edge_mask, the jump-flooding nearest_fill,
pullpush_fill, rescale_about_center, bilinear_sample, and
`resize_linear` / `scale_and_translate_linear`: the same weight matrices
as jax.image's triangle kernel (compute_weight_mat), contracted in fp32.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Edges / morphology
# --------------------------------------------------------------------------

def scharr_edges(gray: torch.Tensor) -> torch.Tensor:
    """(|gx| + |gy|) / 2 of the Scharr kernels, zero-padded; [..., H, W]."""
    kx = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0],
                       [-3.0, 0.0, 3.0]], device=gray.device)
    k = torch.stack([kx, kx.T])[:, None]                  # [2,1,3,3]
    h, w = gray.shape[-2:]
    x = gray.reshape(-1, 1, h, w).float()
    out = F.conv2d(x, k, padding=1)
    edges = (out[:, 0].abs() + out[:, 1].abs()) / 2.0
    return edges.reshape(gray.shape)


def dilate(binary: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Square-kernel dilation with reflect padding; [..., H, W] -> float."""
    x = binary.float()
    if kernel_size <= 1:
        return x
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    h, w = x.shape[-2:]
    x4 = F.pad(x.reshape(-1, 1, h, w), (lo, hi, lo, hi), mode="reflect")
    y = F.max_pool2d(x4, kernel_size, stride=1)
    return y.reshape(binary.shape)


def erode(binary: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Square-kernel erosion (the dual of `dilate`); [..., H, W] -> float."""
    if kernel_size <= 1:
        return binary.float()
    return 1.0 - dilate(1.0 - binary.float(), kernel_size)


def morph_close(binary: torch.Tensor, kernel_size: int = 7) -> torch.Tensor:
    """Morphological closing (dilate, then erode): fills holes smaller than
    the kernel in a mask; [..., H, W] -> float."""
    return erode(dilate(binary, kernel_size), kernel_size)


def bilateral_filter(img: torch.Tensor, ksize: int,
                     sigma_color: float | None = None,
                     sigma_space: float | None = None) -> torch.Tensor:
    """Edge-preserving bilateral filter of img [..., H, W, C] in [0, 1],
    reflect-padded, on img's device: each of the ksize^2 window offsets is
    a shifted view, weighted by exp(-d^2 / 2 sigma_space^2) and
    exp(-(nb - x)^2 / 2 sigma_color^2) (sigma_space 0.15 ksize + 0.35 and
    sigma_color = sigma_space by default)."""
    if sigma_space is None:
        sigma_space = 0.15 * ksize + 0.35
    if sigma_color is None:
        sigma_color = sigma_space
    pad = (ksize - 1) // 2
    x = img.float()
    h, w, c = x.shape[-3:]
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    xp = F.pad(x4, (pad, pad, pad, pad), mode="reflect").permute(
        0, 2, 3, 1).reshape(x.shape[:-3] + (h + 2 * pad, w + 2 * pad, c))
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    inv2s = 1.0 / (2.0 * sigma_space ** 2)
    inv2c = 1.0 / (2.0 * sigma_color ** 2)
    for dy in range(ksize):
        for dx in range(ksize):
            nb = xp[..., dy:dy + h, dx:dx + w, :]
            ws = float(np.float32(np.exp(-((dy - pad) ** 2 + (dx - pad) ** 2)
                                         * inv2s)))
            wgt = ws * torch.exp(-((nb - x) ** 2) * inv2c)
            num = num + wgt * nb
            den = den + wgt
    return num / torch.clamp(den, min=1e-12)


def inner_edge_mask(foreground: torch.Tensor) -> torch.Tensor:
    """Foreground pixels next to background: dilate(~fg) & fg."""
    fg = foreground.bool()
    return (dilate((~fg).float(), 3) > 0.5) & fg


# --------------------------------------------------------------------------
# Jump-flooding nearest fill
# --------------------------------------------------------------------------

def _jfa_steps(res: int):
    steps = [1]
    s = 1
    while s < res:
        s *= 2
    s //= 2
    while s >= 1:
        steps.append(s)
        s //= 2
    return steps + [2, 1]


def _shift(a: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[..., r, c] = a[..., r - dy, c - dx] (fill outside)."""
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    rs, rd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else \
        (slice(-dy, h), slice(0, h + dy))
    cs, cd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else \
        (slice(-dx, w), slice(0, w + dx))
    out[..., rd, cd] = a[..., rs, cs]
    return out


def nearest_fill(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fill invalid pixels with the value of the nearest valid pixel by
    jump flooding.  values [..., H, W, C], valid [..., H, W] bool."""
    h, w = valid.shape[-2:]
    dev = valid.device
    rows = torch.arange(h, device=dev, dtype=torch.int64)[:, None]
    cols = torch.arange(w, device=dev, dtype=torch.int64)[None, :]
    big = 2 * (h * h + w * w) + 1
    src_r = torch.where(valid, rows, -1)
    src_c = torch.where(valid, cols, -1)

    def dist2(sr, sc):
        d = (rows - sr) ** 2 + (cols - sc) ** 2
        return torch.where(sr >= 0, d, big)

    for s in _jfa_steps(max(h, w)):
        best_d = dist2(src_r, src_c)
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                cand_r = _shift(src_r, dy, dx, -1)
                cand_c = _shift(src_c, dy, dx, -1)
                cand_d = dist2(cand_r, cand_c)
                take = cand_d < best_d
                src_r = torch.where(take, cand_r, src_r)
                src_c = torch.where(take, cand_c, src_c)
                best_d = torch.where(take, cand_d, best_d)
    src_r = src_r.clamp(0, h - 1)
    src_c = src_c.clamp(0, w - 1)
    lead = values.shape[:-3]
    flat = values.reshape(-1, h * w, values.shape[-1])
    idx = (src_r * w + src_c).reshape(-1, h * w)
    filled = torch.gather(flat, 1,
                          idx[..., None].expand(-1, -1, flat.shape[-1]))
    filled = filled.reshape(values.shape)
    return torch.where(valid[..., None], values, filled)


# --------------------------------------------------------------------------
# jax.image-compatible linear resampling
# --------------------------------------------------------------------------

def _weight_mat(in_size: int, out_size: int, scale, translation,
                antialias: bool, device) -> torch.Tensor:
    """jax.image.scale.compute_weight_mat with the triangle kernel, fp32:
    [in_size, out_size]."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32,
                                  device=device)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - translation * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    x = x / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def scale_and_translate_linear(img: torch.Tensor, out_hw: Sequence[int],
                               scale, translation,
                               antialias: bool) -> torch.Tensor:
    """jax.image.scale_and_translate(method='linear') over the two
    trailing spatial dims of [..., H, W] (fp32; rows contracted first)."""
    h, w = img.shape[-2:]
    wh = _weight_mat(h, out_hw[0], scale[0], translation[0], antialias,
                     img.device)
    ww = _weight_mat(w, out_hw[1], scale[1], translation[1], antialias,
                     img.device)
    x = img.float()
    y = torch.einsum("...hw,hH->...Hw", x, wh)
    return torch.einsum("...Hw,wW->...HW", y, ww)


def resize_linear(img: torch.Tensor, out_hw: Sequence[int],
                  antialias: bool = True) -> torch.Tensor:
    """jax.image.resize(method='linear') of [..., H, W]; dims whose size
    does not change are left untouched, as jax does."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    x = img.float()
    if oh != h:
        wh = _weight_mat(h, oh, oh / h, 0.0, antialias, img.device)
        x = torch.einsum("...hw,hH->...Hw", x, wh)
    if ow != w:
        ww = _weight_mat(w, ow, ow / w, 0.0, antialias, img.device)
        x = torch.einsum("...Hw,wW->...HW", x, ww)
    return x


def resize_linear_hwc(img: torch.Tensor, out_hw: Sequence[int],
                      antialias: bool = True) -> torch.Tensor:
    """resize_linear for channel-last [..., H, W, C] images."""
    x = img.movedim(-1, -3)
    return resize_linear(x, out_hw, antialias).movedim(-3, -1)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img [H,W,C] at continuous uv [...,2] in [0,1] (u -> col,
    v -> row), bilinear, clamped borders -> [..., C]."""
    h, w = img.shape[:2]
    x = (uv[..., 0] * w - 0.5).clamp(0.0, w - 1.0)
    y = (uv[..., 1] * h - 0.5).clamp(0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    c00, c01 = img[y0, x0], img[y0, x1]
    c10, c11 = img[y1, x0], img[y1, x1]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def rescale_about_center(img: torch.Tensor, scale) -> torch.Tensor:
    """Scale [..., H, W] about its centre by `scale` (<= 1 shrinks), shape
    unchanged, zero background: scale_and_translate linear, no
    antialias, translation (1 - s) * size / 2 as in the JAX package."""
    h, w = img.shape[-2:]
    s = torch.as_tensor(scale, dtype=torch.float32, device=img.device)
    th = (1 - s) * h / 2.0
    tw = (1 - s) * w / 2.0
    return scale_and_translate_linear(img, (h, w), (s, s), (th, tw),
                                      antialias=False)


# --------------------------------------------------------------------------
# Pull-push scattered-data interpolation ('linear' inpainting)
# --------------------------------------------------------------------------

def pullpush_fill(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """values [H,W,C], valid [H,W] -> smooth fill of the invalid pixels."""
    h, w = valid.shape
    levels = 1
    while (1 << levels) < max(h, w):
        levels += 1
    wgt = valid.float()[..., None]
    val = values * wgt
    pyr_v, pyr_w = [val], [wgt]
    for _ in range(levels):
        v, wg = pyr_v[-1], pyr_w[-1]
        hh, ww = v.shape[0], v.shape[1]
        ph, pw = hh % 2, ww % 2
        if ph or pw:
            v = F.pad(v, (0, 0, 0, pw, 0, ph))
            wg = F.pad(wg, (0, 0, 0, pw, 0, ph))
        v = v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2, -1).sum((1, 3))
        wg = wg.reshape(wg.shape[0] // 2, 2, wg.shape[1] // 2, 2,
                        -1).sum((1, 3))
        pyr_v.append(v)
        pyr_w.append(wg)
        if v.shape[0] <= 1 and v.shape[1] <= 1:
            break
    coarse = pyr_v[-1] / pyr_w[-1].clamp(min=1e-8)
    for lvl in range(len(pyr_v) - 2, -1, -1):
        v, wg = pyr_v[lvl], pyr_w[lvl]
        up = resize_linear_hwc(coarse, (v.shape[0], v.shape[1]))
        a = wg.clamp(0.0, 1.0)
        coarse = a * (v / wg.clamp(min=1e-8)) + (1.0 - a) * up
    return torch.where(valid[..., None], values, coarse)

