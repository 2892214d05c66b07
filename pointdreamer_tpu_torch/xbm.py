"""X11 bitmap (XBM) decoding, as PIL 12.1's XbmImagePlugin reads it: the
`#define ..._width` / `_height` header (an optional hot spot), then after
the last `_bits[]` of the first 512 bytes every `x` and the two characters
after it as one hex byte (XbmDecode.c; a non-hex digit counts 0), rows of
(width + 7) // 8 bytes, least significant bit first; mode "1", a set bit
white (255)."""
from __future__ import annotations

import re

import numpy as np

from .imagemode import ModeImage

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = {c: int(chr(c), 16) for c in b"0123456789abcdefABCDEF"}


def accepts(data: bytes) -> bool:
    """Whether XbmImagePlugin opens the file: it starts with `#define` and
    its first 512 bytes hold the width, height and `_bits[]` header."""
    return data.lstrip().startswith(b"#define") and bool(
        _HEAD.match(data[:512]))


def decode_xbm(data: bytes) -> ModeImage:
    """XBM bytes -> mode "1" pixels (0 / 255)."""
    if not accepts(data):
        raise ValueError("not an XBM file")
    m = _HEAD.match(data[:512])
    w, h = int(m.group("width")), int(m.group("height"))
    stride = (w + 7) // 8
    need = h * stride
    out = bytearray()
    pos = m.end()
    while len(out) < need:
        pos = data.find(b"x", pos)
        if pos < 0 or pos + 3 > len(data):
            raise ValueError("XBM: image data is truncated")
        out.append((_HEX.get(data[pos + 1], 0) << 4)
                   | _HEX.get(data[pos + 2], 0))
        pos += 3
    rows = np.frombuffer(bytes(out), np.uint8).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return ModeImage("1", bits * 255)
