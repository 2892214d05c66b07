"""Truevision TGA decoding in numpy, as PIL 12.1's TgaImagePlugin reads it.

- image types 1 / 9 (colour-mapped, "P"; the map at 16 bits, 5-5-5 with
  its top bit as inverted alpha, which makes an RGBA palette, or at 24
  bits), 2 / 10 (true colour: 16 bits "RGBA" 5-5-5 + inverted alpha bit,
  24 "RGB", 32 "RGBA") and 3 / 11 (grey: 1 bit "1", 8 "L", 16 "LA"),
  types 9 to 11 run-length encoded (runs and literal packets carry on
  across rows);
- the origin bits: rows bottom-up unless bit 5 is set, mirrored left to
  right where bit 4 is set;
- a colour map's first index (entries below it black).

TGA has no signature: `header_ok` is the check TgaImagePlugin makes
before it accepts a file, and PIL tries TGA after every plugin that has
one.  What PIL cannot decode raises: a 32-bit colour map, 1-bit RLE, and
the depths it has no raw mode for.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage

# (image type & 7, depth) -> mode
_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
          (2, 16): "RGBA", (2, 24): "RGB", (2, 32): "RGBA"}


def header_ok(data: bytes) -> bool:
    """Whether TgaImagePlugin opens the file: colour map type 0 or 1, a
    positive size, depth 1, 8, 16, 24 or 32, image type 1-3 or 9-11, and
    a colour map of 16, 24 or 32 bits where there is one."""
    if len(data) < 18:
        return False
    cmap, kind, depth = data[1], data[2], data[16]
    w, h = struct.unpack_from("<HH", data, 12)
    return (cmap in (0, 1) and w > 0 and h > 0
            and depth in (1, 8, 16, 24, 32) and kind in (1, 2, 3, 9, 10, 11)
            and (not cmap or data[7] in (16, 24, 32)))


def _bgra15(v: np.ndarray) -> np.ndarray:
    """Pillow's "BGRA;15Z": 5-5-5 channels scaled by 255 // 31 steps
    (c * 255 / 31, truncated), alpha 0 where the top bit is set."""
    v = v.astype(np.int64)
    rgb = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    a = np.where(v & 0x8000, 0, 255)
    return np.stack(rgb + [a], -1).astype(np.uint8)


def _rle(data: bytes, pos: int, n: int, bpp: int) -> bytes:
    """TgaRleDecode: packets of a run of one pixel or a literal of up to
    128 pixels, read as one stream across rows."""
    out = bytearray()
    while len(out) < n:
        if pos >= len(data):
            raise ValueError("TGA: RLE data ends before the image is full")
        head = data[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos + 1:pos + 1 + bpp]
            if len(px) < bpp:
                raise ValueError("TGA: RLE data ends inside a run")
            out += px * count
            pos += 1 + bpp
        else:
            lit = data[pos + 1:pos + 1 + count * bpp]
            if len(lit) < count * bpp:
                raise ValueError("TGA: RLE data ends inside a literal")
            out += lit
            pos += 1 + count * bpp
    return bytes(out[:n])


def decode_tga(data: bytes) -> ModeImage:
    """TGA bytes -> the image in PIL's mode (see the module docstring)."""
    if not header_ok(data):
        raise ValueError("not a TGA file")
    id_len, cmap, kind = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    mode = _MODES.get((kind & 7, depth))
    if mode is None or (mode == "P" and not cmap):
        raise NotImplementedError(
            f"TGA: image type {kind} at {depth} bits, which PIL 12.1 does "
            "not decode")
    pos = 18 + id_len
    palette = None
    if cmap:
        start, size = struct.unpack_from("<HH", data, 3)
        mapdepth = data[7]
        if mapdepth == 32:
            raise NotImplementedError("TGA: a 32-bit colour map, which PIL "
                                      "12.1 refuses (raw mode BGRA)")
        nb = 2 if mapdepth == 16 else 3
        raw = data[pos:pos + nb * size]
        pos += nb * size
        if mapdepth == 16:
            entries = _bgra15(np.frombuffer(raw[:len(raw) // 2 * 2], "<u2"))
            fill = (0, 0, 0, 255)
        else:
            entries = np.frombuffer(raw[:len(raw) // 3 * 3], np.uint8
                                    ).reshape(-1, 3)[:, ::-1]
            fill = (0, 0, 0)
        palette = np.tile(np.array(fill, np.uint8), (256, 1))
        k = min(256 - start, len(entries)) if start < 256 else 0
        palette[:start] = 0 if mapdepth == 24 else (0, 0, 0, 255)
        palette[start:start + k] = entries[:k]
    if depth == 1:
        if kind & 8:
            raise NotImplementedError("TGA: 1-bit RLE, which PIL 12.1 "
                                      "cannot decode")
        stride = (w + 7) // 8
        rows = np.frombuffer(data, np.uint8, h * stride, pos).reshape(h,
                                                                     stride)
        px = np.unpackbits(rows, axis=1)[:, :w] * 255
    else:
        bpp = depth // 8
        n = w * h * bpp
        buf = _rle(data, pos, n, bpp) if kind & 8 else data[pos:pos + n]
        if len(buf) < n:
            raise ValueError("TGA: image data is truncated")
        a = np.frombuffer(buf, np.uint8).reshape(h, w, bpp)
        if mode == "RGBA" and depth == 16:
            px = _bgra15(a[..., 0].astype(np.int64)
                         | (a[..., 1].astype(np.int64) << 8))
        elif mode in ("RGB", "RGBA"):
            px = a[..., [2, 1, 0, 3][:bpp]]
        elif mode == "LA":
            px = a
        else:
            px = a[..., 0]
    if not flags & 0x20:
        px = px[::-1]
    if flags & 0x10:
        px = px[:, ::-1]
    px = np.ascontiguousarray(px)
    if mode == "P":
        return ModeImage("P", px, palette)
    return ModeImage(mode, px)
