"""Kodak PhotoCD (PCD) decoding, as PIL 12.1's PcdImagePlugin reads it:
the 768 x 512 base image at byte 96 x 2048, "RGB".

The file is a PCD when the 1539 bytes at 2048 begin "PCD_"; their last
byte's two low bits rotate the image by 90 (1) or 270 (3) degrees
counter-clockwise, as PIL rotates it after decoding.  PcdDecode.c reads
the base image two rows at a time: two rows of 768 Y, then 384 C1 and 384
C2 shared by both rows, and each pixel goes through the PhotoYCC to RGB
conversion of Pillow's UnpackYCC.c: R = L[Y] + CR[C2], G = L[Y] + GR[C2]
+ GB[C1], B = L[Y] + CB[C1], each clamped to 0..255.  Its five tables
are below as a first value and their steps, read off PIL over all 2^24
inputs (GR and GB up to a constant moved between them, which their sum
does not see).

PCD has no signature: PIL tries it on every file no earlier plugin took.
"""
from __future__ import annotations

import numpy as np

from .imagemode import ModeImage, NotThisFormat, step_table

# UnpackYCC.c's tables (`imagemode.step_table`)
_STEPS = {
    "L": (0, 1,
        "010010100100100100101001001001001010010010010010100100100101"
        "001001001001010010010010010100100100100101001001001001010010"
        "010010100100100100101001001001001010010010010010100100100101"
        "001001001001010010010010010100100100100101001001001010010010"
        "010010100100100"),
    "CR": (-249, 1,
        "111110111101111101111101111011111011110111110111110111101111"
        "101111011111011111011110111110111101111101111101111011111011"
        "110111110111110101101111101111101111011111011110111110111110"
        "111101111101111011111011111011110111110111101111101111101111"
        "011111011110111"),
    "CB": (-345, 1,
        "112111211112111121112111121112111121112111121111211121111211"
        "121111211112111211112111211112111121112111121112111121112111"
        "121111211121111211121111211112111210112111211112111121112111"
        "121112111121111211121111211121111211121111211112111211112111"
        "211112111121112"),
    "GR": (127, -1,
        "000000100000000000001000000000000010000000000001000000000000"
        "010000000000000100000000000010000000000000100000000000001000"
        "000000000010000001000001000000000000010000000000000100000000"
        "000001000000000000100000000000001000000000000010000000000001"
        "000000000000010"),
    "GB": (67, -1,
        "101011010101101010110101011010101011010101101010110101011010"
        "101101010110101011010101101010110101011010101101010110101010"
        "110101011010101101010110101011010101111010110101011010101101"
        "010110101011010101011010101101010110101011010101101010110101"
        "011010101101010"),
}


_L, _CR, _CB, _GR, _GB = (step_table(*_STEPS[k])
                           for k in ("L", "CR", "CB", "GR", "GB"))
_W, _H = 768, 512


def ycc_to_rgb(y: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """PhotoYCC (uint8 Y, C1, C2) -> uint8 RGB [..., 3], as Pillow's
    "YCC;P" unpacker converts it."""
    lv = _L[y]
    rgb = np.stack([lv + _CR[c2], lv + _GR[c2] + _GB[c1], lv + _CB[c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def probe(data: bytes) -> int:
    """PcdImageFile._open: the orientation bits."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:
        raise NotThisFormat("not a PCD file")
    return s[1538] & 3


def decode_pcd(data: bytes) -> ModeImage:
    """PCD bytes -> the base image, "RGB" (768 x 512, or 512 x 768 when
    rotated)."""
    orient = probe(data)
    off = 96 * 2048
    chunk = 3 * _W
    need = (_H // 2) * chunk
    if len(data) - off < need:
        raise OSError("PCD: image file is truncated")
    blk = np.frombuffer(data, np.uint8, need, off).reshape(_H // 2, chunk)
    y = blk[:, :2 * _W].reshape(_H, _W)
    half = np.arange(_W) // 2
    c1 = np.repeat(blk[:, 2 * _W:2 * _W + _W // 2][:, half], 2, 0)
    c2 = np.repeat(blk[:, 2 * _W + _W // 2:][:, half], 2, 0)
    rgb = ycc_to_rgb(y.astype(np.int64), c1.astype(np.int64),
                     c2.astype(np.int64))
    if orient == 1:
        rgb = np.rot90(rgb, 1)
    elif orient == 3:
        rgb = np.rot90(rgb, 3)
    return ModeImage("RGB", np.ascontiguousarray(rgb))
