"""QOI ("Quite OK Image") decoding, as PIL 12.1's QoiImagePlugin decodes
it: "RGB" for 3 channels, "RGBA" otherwise; the six operations (RGB,
RGBA, INDEX into the 64-entry hash of seen pixels, DIFF, LUMA, RUN) from
the previous pixel (0, 0, 0, 255); a RUN repeats it without touching the
index.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage


def accepts(data: bytes) -> bool:
    return data.startswith(b"qoif")


def decode_qoi(data: bytes) -> ModeImage:
    """QOI bytes -> "RGB" or "RGBA" pixels."""
    if not accepts(data) or len(data) < 14:
        raise ValueError("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    bands = 3 if data[12] == 3 else 4
    n = w * h
    out = bytearray()
    seen = {}
    prev = (0, 0, 0, 255)
    pos, end = 14, len(data)
    count = 0
    while count < n:
        if pos >= end:
            raise ValueError("QOI: image data is truncated")
        b = data[pos]
        pos += 1
        if b == 0xFE:
            value = (data[pos], data[pos + 1], data[pos + 2], prev[3])
            pos += 3
        elif b == 0xFF:
            value = tuple(data[pos:pos + 4])
            pos += 4
        else:
            op = b >> 6
            if op == 0:
                value = seen.get(b & 0x3F, (0, 0, 0, 0))
            elif op == 1:
                value = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                         (prev[1] + ((b >> 2) & 3) - 2) % 256,
                         (prev[2] + (b & 3) - 2) % 256, prev[3])
            elif op == 2:
                b2 = data[pos]
                pos += 1
                dg = (b & 0x3F) - 32
                value = ((prev[0] + dg + (b2 >> 4) - 8) % 256,
                         (prev[1] + dg) % 256,
                         (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
            else:
                run = (b & 0x3F) + 1
                out += bytes(prev[:bands]) * run
                count += run
                continue
        prev = value
        seen[(value[0] * 3 + value[1] * 5 + value[2] * 7
              + value[3] * 11) % 64] = value
        out += bytes(value[:bands])
        count += 1
    px = np.frombuffer(bytes(out[:n * bands]), np.uint8).reshape(h, w, bands)
    return ModeImage("RGB" if bands == 3 else "RGBA", px.copy())
