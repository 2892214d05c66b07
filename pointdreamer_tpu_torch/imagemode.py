"""A decoded image in its PIL mode, and PIL's conversions from each mode.

The decoders (`io.py`, `jpeg.py`, `gif.py`, `tiff.py`, `webp.py`) return
what `Image.open` holds: the mode and its pixels.  `to_rgb` and `to_rgba`
are PIL 12.1's `convert("RGB")` / `convert("RGBA")` from each mode, bit for
bit; `natural` is the array `io.load_image` returns (uint8 [H, W, C], C = 1
grey, 2 grey + alpha, 3 RGB, 4 RGBA).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class NotThisFormat(Exception):
    """A header check failed where PIL's `_open` raises one of the
    exceptions (SyntaxError, IndexError, TypeError, KeyError, EOFError,
    struct.error) that send `Image.open` on to its next plugin; any other
    error in a header commits the file to that plugin, and it fails."""


class ModeImage(NamedTuple):
    """Pixels in a PIL mode: "1" and "L" [H, W] uint8 ("1" holds 0 / 255),
    "I;16", "I;16L" and "I;16B" [H, W] uint16 (the values; the byte order
    is the mode's name only), "I" [H, W] int32, "F" [H, W] float32, "LA",
    "RGB", "RGBA", "RGBa" (alpha premultiplied), "CMYK" and "YCbCr"
    [H, W, C] uint8, "P" [H, W] uint8 indices into `palette` [256, 3]
    uint8 (RGB) or [256, 4] (an RGBA palette, as a TGA colour map of 16 or
    32 bits gives), "PA" [H, W, 2] (index, alpha) with an RGB `palette`.
    `transparency` is the index ("P") or grey level ("L") that
    `convert("RGBA")` makes transparent, or None."""
    mode: str
    pixels: np.ndarray
    palette: Optional[np.ndarray] = None
    transparency: Optional[int] = None


# integer modes whose convert("L") clips at 0 and 255
_WIDE = ("I;16", "I;16L", "I;16B", "I")
# the palette of a "P" image whose file brings none: PIL converts it black
BLACK_PALETTE = np.zeros((256, 3), np.uint8)


def of_array(a: np.ndarray) -> ModeImage:
    """A uint8 [H, W, C] array (C 1..4) as the mode it holds."""
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[a.shape[-1]]
    return ModeImage(mode, a[..., 0] if mode == "L" else a)


def step_table(first: int, base: int, digits: str) -> np.ndarray:
    """A lookup table held as its first value and its steps, each `base`
    plus one digit (the colour tables read off Pillow's C converters)."""
    steps = base + np.frombuffer(digits.encode(), np.uint8).astype(
        np.int64) - 48
    return first + np.concatenate([[0], np.cumsum(steps)])


# tables that give ConvertYCbCr.c's YCbCr -> RGB for all 2^24 inputs
# (checked against PIL over every one): red and blue as its tables
# shifted right by its SCALE of 6 bits, green before the shift (its two
# tables up to a split of their sum) (`step_table`)
_YCC_STEPS = {
    "R_Cr": (-180, 1,
        "010100101001010010101001010010100101001010010100101001010010"
        "100101001010010100101001010010100101001010010100101001010100"
        "101001010010100101001010010100101001010010100101001010010100"
        "101001010010100101001010010100101001010010101001010010100101"
        "001010010100101"),
    "G_Cb": (2819, -23,
        "021020210202012020120202101020120202102021020210202102020120"
        "201202011020201202012020210202102021020210202011020210202012"
        "020120202111111111111111111101111111111111111111111111111111"
        "111111110111111111111111111111111111111111111111011111111111"
        "111111111111111"),
    "G_Cr": (5851, -46,
        "100010010001001001000100100010010010001001001000100100010010"
        "010001001000100100100010010001001001000100100100010010001001"
        "001000101100010010010001001000100100100010010010001001000100"
        "100100010010001001001000100100010010010001001001000100100010"
        "010010001001000"),
    "B_Cb": (-227, 1,
        "011110111011110111011101111011101110111101110111101110111011"
        "110111011110111011101111011101111011101110111101110111011110"
        "111011110111011101111011101110111101110111101110111011110111"
        "011110111011101111011101110111101110111101110111011110111011"
        "110111011101111"),
}
_R_CR, _G_CB, _G_CR, _B_CB = (step_table(*_YCC_STEPS[k])
                              for k in ("R_Cr", "G_Cb", "G_Cr", "B_Cb"))


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB: uint8 [..., 3] YCbCr -> RGB,
    R = Y + R_Cr[Cr], G = Y + (G_Cb[Cb] + G_Cr[Cr]) >> 6, B = Y +
    B_Cb[Cb], each clamped to 0..255."""
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    rgb = np.stack([y + _R_CR[cr], y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + _B_CB[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb: each channel (255 - K) - X (255 - K) / 255, the
    division rounded as its MULDIV255 rounds it."""
    x = cmyk.astype(np.int64)
    nk = 255 - x[..., 3:]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's rgba2rgbA ("RGBa" -> "RGBA"): each colour 255 c / a,
    truncated and clipped, where 0 < a < 255; unchanged elsewhere."""
    x = rgba.astype(np.int64)
    a = x[..., 3:]
    div = np.minimum(255 * x[..., :3] // np.maximum(a, 1), 255)
    rgb = np.where((a == 0) | (a == 255), x[..., :3], div)
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _grey(img: ModeImage) -> np.ndarray:
    p = img.pixels
    if img.mode in _WIDE:
        return np.clip(p, 0, 255).astype(np.uint8)
    if img.mode == "F":
        # Pillow's f2l: 0 at or below 0 (and for NaN), 255 at or above
        # 255, else truncated
        with np.errstate(invalid="ignore"):
            v = np.where(p >= 255, 255, np.where(p > 0, p, 0))
        return np.nan_to_num(v).astype(np.uint8)
    return p[..., 0] if img.mode == "LA" else p


def to_rgb(img: ModeImage) -> np.ndarray:
    """PIL's `convert("RGB")`: uint8 [H, W, 3]."""
    m, p = img.mode, img.pixels
    if m in ("1", "L", "F", "LA") or m in _WIDE:
        out = np.repeat(_grey(img)[..., None], 3, -1)
    elif m == "RGB":
        out = p
    elif m == "RGBA":
        out = p[..., :3]
    elif m == "RGBa":
        out = unpremultiply(p)[..., :3]
    elif m == "CMYK":
        out = cmyk_to_rgb(p)
    elif m == "YCbCr":
        out = ycbcr_to_rgb(p)
    elif m == "P":
        out = img.palette[p][..., :3]
    elif m == "PA":
        out = img.palette[p[..., 0]][..., :3]
    else:
        raise ValueError(f"no conversion from mode {m!r}")
    return np.ascontiguousarray(out)


def to_rgba(img: ModeImage) -> np.ndarray:
    """PIL's `convert("RGBA")`: uint8 [H, W, 4]; a "P" or "L" image's
    `transparency` becomes alpha 0, every other pixel of a mode without
    alpha is opaque."""
    m, p = img.mode, img.pixels
    if m == "RGBA":
        return np.ascontiguousarray(p)
    if m == "RGBa":
        return unpremultiply(p)
    if m == "P" and img.palette.shape[-1] == 4:
        return np.ascontiguousarray(img.palette[p])
    if m in ("LA", "PA"):
        alpha = p[..., 1]
    elif img.transparency is not None and m in ("P", "L"):
        alpha = np.where(p == img.transparency, 0, 255).astype(np.uint8)
    else:
        alpha = np.full(p.shape[:2], 255, np.uint8)
    return np.ascontiguousarray(np.concatenate([to_rgb(img),
                                                alpha[..., None]], -1))


def natural(img: ModeImage) -> np.ndarray:
    """The uint8 [H, W, C] array `io.load_image` returns: "1", "L" and
    "I;16" (clipped at 255) as grey [H, W, 1], grey + alpha where "L" has
    a transparent level; "I" and "F" clipped to grey as convert("L") clips
    them; "LA", "RGB" and "RGBA" as they are; "RGBa" un-premultiplied;
    "CMYK" as RGB; "P" through its palette, RGBA when it has a transparent
    index or an RGBA palette; "PA" as RGBA."""
    m = img.mode
    if m == "L" and img.transparency is not None:
        return to_rgba(img)[..., [0, 3]]
    if m in ("1", "L", "F") or m in _WIDE:
        return np.ascontiguousarray(_grey(img)[..., None])
    if m in ("LA", "RGB", "RGBA"):
        return img.pixels
    if m in ("RGBa", "PA") or (m == "P" and (img.transparency is not None
                                             or img.palette.shape[-1] == 4)):
        return to_rgba(img)
    return to_rgb(img)
