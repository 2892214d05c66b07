"""Windows Paint (MSP) decoding, as PIL 12.1's MspImagePlugin reads it:
mode "1" (a set bit is white); version 1 ("DanM") raw rows, version 2
("LinS") a row-length map and run-length rows (a zero byte: a count and a
byte to repeat; else that many literal bytes), an empty row white.  The
header's 16 words must XOR to zero."""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage


def accepts(data: bytes) -> bool:
    return data.startswith((b"DanM", b"LinS"))


def header_ok(data: bytes) -> bool:
    if not accepts(data) or len(data) < 32:
        return False
    check = 0
    for v in struct.unpack_from("<16H", data):
        check ^= v
    return check == 0


def decode_msp(data: bytes) -> ModeImage:
    """MSP bytes -> mode "1" pixels (0 / 255)."""
    if not header_ok(data):
        raise ValueError("not an MSP file (or a bad header checksum)")
    w, h = struct.unpack_from("<HH", data, 4)
    stride = (w + 7) // 8
    if data.startswith(b"DanM"):
        raw = data[32:32 + h * stride]
        if len(raw) < h * stride:
            raise ValueError("MSP: image data is truncated")
    else:
        rowmap = struct.unpack_from(f"<{h}H", data, 32)
        pos = 32 + 2 * h
        out = bytearray()
        for y, n in enumerate(rowmap):
            if n == 0:
                out += b"\xff" * stride
                continue
            row = data[pos:pos + n]
            pos += n
            if len(row) != n:
                raise ValueError(f"MSP: row {y} is truncated")
            i = 0
            while i < n:
                t = row[i]
                i += 1
                if t == 0:
                    if i + 2 > n:
                        raise ValueError(f"MSP: row {y} is corrupted")
                    out += row[i + 1:i + 2] * row[i]
                    i += 2
                else:
                    out += row[i:i + t]
                    i += t
        raw = bytes(out)
        if len(raw) < h * stride:
            raise ValueError("MSP: image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * stride).reshape(h, stride)
    return ModeImage("1", np.unpackbits(rows, axis=1)[:, :w] * 255)
