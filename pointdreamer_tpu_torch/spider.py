"""SPIDER 2-D image decoding, as PIL 12.1's SpiderImagePlugin reads it:
mode "F" from 32-bit floats, big-endian where the header reads as a valid
SPIDER header that way, else little-endian.

SPIDER has no signature: PIL tries every file no earlier plugin took as
a header of 27 floats (its words 1, 2, 5, 12, 13, 22 and 23 integers,
iform 1 among the forms it knows, labbyt = labrec x lenbyt), and a file
that fails goes on to the next plugin (`NotThisFormat`).  A stack's first
image follows the stack header and its own image header.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    return math.isfinite(f) and f == int(f)


def _header_len(t) -> int:
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def probe(data: bytes):
    """SpiderImageFile._open: (byte order, width, height, data offset)."""
    if len(data) < 108:
        raise NotThisFormat("not a SPIDER file")
    for order in (">", "<"):
        t = struct.unpack_from(order + "27f", data)
        hdrlen = _header_len(t)
        if hdrlen:
            break
    else:
        raise NotThisFormat("not a valid SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a SPIDER 2-D image")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    elif istack == 0 and imgnumber > 0:
        raise AttributeError("SPIDER: an image inside a stack, opened "
                             "alone (PIL 12.1 fails on it)")
    else:
        raise NotThisFormat("SPIDER: inconsistent stack header values")
    if w <= 0 or ht <= 0:
        raise NotThisFormat("SPIDER: empty image")
    return order, w, ht, offset


def decode_spider(data: bytes) -> ModeImage:
    """SPIDER bytes -> mode "F" pixels."""
    order, w, h, offset = probe(data)
    if len(data) - offset < 4 * w * h:
        raise ValueError("SPIDER: image file is truncated")
    px = np.frombuffer(data, order + "f4", w * h, offset).reshape(h, w)
    return ModeImage("F", px.astype(np.float32))
