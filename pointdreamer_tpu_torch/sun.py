"""Sun raster (SUN) decoding, as PIL 12.1's SunImagePlugin reads it.

- depth 1 "1" (a set bit black), 4 "L" (x 17), 8 "L", 24 "RGB" (BGR
  unless the type is 3, RGB), 32 "RGB" (BGRX / RGBX); a colour map of
  type 1 (planar R, G, B, at most 1024 bytes) turns "L" into "P" (4 or 8
  bit indices; a short map leaves its other entries black); PIL fails to
  load a colour map with the other depths, and so does the port;
- types 0, 1, 3, 4, 5: raw rows padded to 16 bits; type 2: SunRleDecode.c
  (0x80 0 is a literal 0x80, 0x80 n v a run of n + 1 v, which carries on
  into the next rows; other bytes literal) over unpadded rows.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat


def accepts(data: bytes) -> bool:
    return data[:4] == b"\x59\xa6\x6a\x95"


def probe(data: bytes):
    """SunImageFile._open: (mode, raw mode, width, height, depth, type,
    palette, data offset)."""
    if not accepts(data) or len(data) < 32:
        raise NotThisFormat("not a SUN raster file")
    _, w, h, depth, _, kind, maptype, maplen = struct.unpack_from(">8I",
                                                                  data)
    raw = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
           24: ("RGB", "RGB" if kind == 3 else "BGR"),
           32: ("RGB", "RGBX" if kind == 3 else "BGRX")}.get(depth)
    if raw is None:
        raise NotThisFormat(f"SUN: unsupported depth {depth}")
    mode, rawmode = raw
    offset = 32
    palette = None
    if maplen:
        if maplen > 1024:
            raise NotThisFormat("SUN: unsupported colour map length")
        if maptype != 1:
            raise NotThisFormat("SUN: unsupported colour map type")
        table = data[32:32 + maplen]
        offset += maplen
        n = len(table) // 3
        palette = np.zeros((256, 3), np.uint8)
        planes = np.frombuffer(table, np.uint8, 3 * n).reshape(3, n).T
        palette[:min(n, 256)] = planes[:256]
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if kind not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"SUN: unsupported file type {kind}")
    if w <= 0 or h <= 0:
        raise NotThisFormat("SUN: empty image")
    return mode, rawmode, w, h, depth, kind, palette, offset


def _rle(data: bytes, pos: int, rows: int, rowbytes: int) -> bytes:
    """SunRleDecode.c: runs continue across rows."""
    need = rows * rowbytes
    out = bytearray()
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise OSError("SUN: image file is truncated")
        b = data[pos]
        if b == 0x80:
            if pos + 1 >= n:
                raise OSError("SUN: image file is truncated")
            count = data[pos + 1]
            if count == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= n:
                    raise OSError("SUN: image file is truncated")
                out += data[pos + 2:pos + 3] * (count + 1)
                pos += 3
        else:
            out.append(b)
            pos += 1
    return bytes(out[:need])


def decode_sun(data: bytes) -> ModeImage:
    """SUN raster bytes -> the image in PIL's mode (module docstring)."""
    mode, rawmode, w, h, depth, kind, palette, offset = probe(data)
    if palette is not None and mode != "P":
        raise ValueError(f"SUN: a colour map at depth {depth}, which PIL "
                         "12.1 fails to load (its palette on mode "
                         f"{mode!r})")
    rowbytes = (w * depth + 7) // 8
    if kind == 2:
        rows = np.frombuffer(_rle(data, offset, h, rowbytes),
                             np.uint8).reshape(h, rowbytes)
    else:
        stride = (w * depth + 15) // 16 * 2
        if len(data) - offset < stride * (h - 1) + rowbytes:
            raise OSError("SUN: image file is truncated")
        buf = data[offset:offset + stride * h].ljust(stride * h, b"\0")
        rows = np.frombuffer(buf, np.uint8).reshape(h, stride)[:, :rowbytes]
    if depth == 1:
        return ModeImage("1", (1 - np.unpackbits(rows, axis=1)[:, :w]) * 255)
    if depth == 4:
        v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        if mode == "P":
            return ModeImage("P", np.ascontiguousarray(v), palette)
        return ModeImage("L", (v * 17).astype(np.uint8))
    if depth == 8:
        v = np.ascontiguousarray(rows[:, :w])
        return ModeImage("P", v, palette) if mode == "P" else \
            ModeImage("L", v)
    c = depth // 8
    px = rows[:, :w * c].reshape(h, w, c)
    order = [0, 1, 2] if rawmode.startswith("RGB") else [2, 1, 0]
    return ModeImage("RGB", np.ascontiguousarray(px[..., order]))
