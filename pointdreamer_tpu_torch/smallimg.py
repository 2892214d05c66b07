"""PIL 12.1's small raster plugins, each read as its plugin reads it.

- GBR (GIMP brush): a big-endian header (size >= 20, version 1 or 2,
  "GIMP" after it in version 2), depth 1 "L" or 4 "RGBA", the pixels
  after the header;
- MCIDAS (McIdas area file): the 256-byte area directory (64 big-endian
  words); word 11 the bytes a sample: 1 "L", 2 "I;16B", 4 "I" (big-endian
  signed); rows `prefix + width x bytes x bands` apart from word 34 +
  word 15 (the last row needs no prefix after it);
- PIXAR: a 512-byte header whose channel/depth words (14, 2) make "RGB"
  (any other leaves PIL without a mode, and the file goes on to the next
  plugin), the pixels at 1024;
- XVTHUMB (XV thumbnail, "P7 332"): comment lines, "width height", then
  "P" bytes through the 3-3-2 palette.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat


def _pixels(data: bytes, offset: int, w: int, h: int, c: int,
            kind: str) -> np.ndarray:
    n = w * h * c
    if offset < 0 or len(data) - offset < n:
        raise ValueError(f"{kind}: not enough image data")
    px = np.frombuffer(data, np.uint8, n, offset).reshape(h, w, c)
    return px[..., 0].copy() if c == 1 else px.copy()


# ---------------------------------------------------------------------------
# GBR

def gbr_accepts(data: bytes) -> bool:
    if len(data) < 8:
        return False
    size, version = struct.unpack_from(">II", data)
    return size >= 20 and version in (1, 2)


def gbr_probe(data: bytes):
    """GbrImageFile._open: (mode, width, height, depth, data offset)."""
    if len(data) < 20:
        raise NotThisFormat("not a GIMP brush")
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or w == 0 or h == 0 or \
            depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush (or an unsupported one)")
    if version == 1:
        start = 20
        comment = size - 20
    else:
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise NotThisFormat("not a GIMP brush, bad magic number")
        start = 28
        comment = size - 28
    offset = start + comment if comment >= 0 else len(data)
    return ("L" if depth == 1 else "RGBA"), w, h, depth, offset


def decode_gbr(data: bytes) -> ModeImage:
    mode, w, h, depth, offset = gbr_probe(data)
    return ModeImage(mode, _pixels(data, offset, w, h, depth, "GBR"))


# ---------------------------------------------------------------------------
# MCIDAS

def mcidas_accepts(data: bytes) -> bool:
    return data[:8] == b"\x00\x00\x00\x00\x00\x00\x00\x04"


def mcidas_probe(data: bytes):
    """McIdasImageFile._open: (mode, dtype, width, height, offset,
    stride)."""
    if not mcidas_accepts(data) or len(data) < 256:
        raise NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack_from(">64i", data)
    kinds = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}
    if w[11] not in kinds:
        raise NotThisFormat("unsupported McIdas format")
    mode, dt = kinds[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise NotThisFormat("McIdas: empty image")
    return mode, dt, width, height, w[34] + w[15], \
        w[15] + w[10] * w[11] * w[14]


def decode_mcidas(data: bytes) -> ModeImage:
    mode, dt, w, h, offset, stride = mcidas_probe(data)
    rowbytes = w * np.dtype(dt).itemsize
    if stride < rowbytes or offset < 0:
        raise ValueError("McIdas: a line prefix that overlaps the line")
    # RawDecode.c skips the padding between lines, not after the last
    if len(data) < offset + (h - 1) * stride + rowbytes:
        raise ValueError("McIdas: image file is truncated")
    buf = data[offset:offset + h * stride].ljust(h * stride, b"\0")
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride)[:, :rowbytes]
    px = np.frombuffer(np.ascontiguousarray(rows).tobytes(), dt).reshape(
        h, w)
    out = {"L": np.uint8, "I;16B": np.uint16, "I": np.int32}[mode]
    return ModeImage(mode, px.astype(out))


# ---------------------------------------------------------------------------
# PIXAR

def pixar_accepts(data: bytes) -> bool:
    return data[:4] == b"\x80\xe8\x00\x00"


def pixar_probe(data: bytes):
    if not pixar_accepts(data) or len(data) < 428:
        raise NotThisFormat("not a PIXAR file")
    h, w = struct.unpack_from("<HH", data, 416)
    if struct.unpack_from("<HH", data, 424) != (14, 2) or w <= 0 or h <= 0:
        raise NotThisFormat("PIXAR: not a mode PIL 12.1 opens")
    return w, h


def decode_pixar(data: bytes) -> ModeImage:
    w, h = pixar_probe(data)
    return ModeImage("RGB", _pixels(data, 1024, w, h, 3, "PIXAR"))


# ---------------------------------------------------------------------------
# XVTHUMB

_XV_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                        for r in range(8) for g in range(8)
                        for b in range(4)], np.uint8)


def xv_accepts(data: bytes) -> bool:
    return data[:6] == b"P7 332"


def _line(data: bytes, pos: int):
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def xv_probe(data: bytes):
    """XVThumbImageFile._open: (width, height, data offset)."""
    if not xv_accepts(data):
        raise NotThisFormat("not an XV thumbnail file")
    _, pos = _line(data, 6)
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise NotThisFormat("unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    w, h = int(w), int(h)
    if w <= 0 or h <= 0:
        raise NotThisFormat("XV thumbnail: empty image")
    return w, h, pos


def decode_xv(data: bytes) -> ModeImage:
    w, h, pos = xv_probe(data)
    return ModeImage("P", _pixels(data, pos, w, h, 1, "XV thumbnail"),
                     _XV_PALETTE)
