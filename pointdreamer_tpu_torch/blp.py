"""Blizzard Mipmap (BLP) decoding, as PIL 12.1's BlpImagePlugin reads it:
the first mipmap, "RGBA" where the header's alpha flag (BLP1) or alpha
depth (BLP2) is non-zero, else "RGB".

- BLP1 JPEG (compression 0): the shared JPEG header and the mipmap's bytes
  joined and decoded by `jpeg.py`, converted to RGB and then read back as
  BGR (red and blue swap, as PIL's raw mode "BGR" swaps them; a CMYK
  stream is taken un-inverted);
- BLP1 palette (compression 1, encoding 4 or 5; the indices follow the
  palette) and BLP2 palette (encoding 1; the indices at the mipmap's
  offset): each index looked up in the 256-entry BGRA palette, its alpha
  taken from the palette whatever the alpha depth;
- BLP2 DXT1 / DXT3 / DXT5 (encoding 2, alpha encoding 0 / 1 / 7) through
  BlpImagePlugin's own block decoders (`bcn.decode_blp_dxt`).

PIL hands each decoder's bytes to its raw decoder for the image's mode, so
the bytes are read as rows of the image's width whatever the rows they
were made in (block rows of a width that is not a multiple of 4, RGBA
bytes under an "RGB" header); fewer bytes than the image needs raise.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bcn
from .imagemode import ModeImage, NotThisFormat, to_rgb


def accepts(data: bytes) -> bool:
    return data[:4] in (b"BLP1", b"BLP2")


def probe(data: bytes):
    """BlpImageFile._open: (version, compression, encoding, alpha, alpha
    encoding, width, height)."""
    if not accepts(data):
        raise NotThisFormat("not a BLP file")
    try:
        comp, = struct.unpack_from("<i", data, 4)
        if data[:4] == b"BLP1":
            alpha = struct.unpack_from("<I", data, 8)[0] != 0
            w, h, enc = struct.unpack_from("<IIi", data, 12)
            struct.unpack_from("<i", data, 24)
            aenc = 0
        else:
            enc, adepth, aenc = struct.unpack_from("<bbb", data, 8)
            alpha = adepth != 0
            w, h = struct.unpack_from("<II", data, 12)
    except struct.error as e:
        raise NotThisFormat(f"BLP: truncated header ({e})") from e
    if w <= 0 or h <= 0:
        raise NotThisFormat("BLP: empty image")
    return data[:4], comp, enc, alpha, aenc, w, h


def _palette(data: bytes, pos: int) -> np.ndarray:
    n = min(256, (len(data) - pos) // 4)
    return np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)


def _safe(data: bytes, pos: int, n: int) -> bytes:
    if n <= 0:
        return b""
    chunk = data[pos:pos + n]
    if len(chunk) < n:
        raise OSError("BLP: truncated file read")
    return chunk


def _indexed(data: bytes, pos: int, n: int, pal: np.ndarray,
             alpha: bool) -> bytes:
    idx = np.frombuffer(_safe(data, pos, n), np.uint8)
    if len(idx) and idx.max() >= len(pal):
        raise IndexError("BLP: a palette index past the palette's end")
    bgra = pal[idx.astype(np.int64)]
    return bgra[:, [2, 1, 0, 3] if alpha else [2, 1, 0]].tobytes()


def _as_raw(raw: bytes, mode: str, w: int, h: int) -> ModeImage:
    c = len(mode)
    if len(raw) < w * h * c:
        raise ValueError("BLP: not enough image data")
    px = np.frombuffer(raw, np.uint8, w * h * c).reshape(h, w, c).copy()
    return ModeImage(mode, px)


def decode_blp(data: bytes) -> ModeImage:
    """BLP bytes -> "RGB" or "RGBA" pixels (see the module docstring)."""
    magic, comp, enc, alpha, aenc, w, h = probe(data)
    mode = "RGBA" if alpha else "RGB"
    base = 28 if magic == b"BLP1" else 20
    try:
        offsets = struct.unpack_from("<16I", data, base)
        lengths = struct.unpack_from("<16I", data, base + 64)
    except struct.error as e:
        raise OSError("BLP: truncated file") from e
    pos = base + 128
    if magic == b"BLP1":
        if comp == 0:
            from .jpeg import decode_jpeg_image

            size, = struct.unpack_from("<I", data, pos)
            head = _safe(data, pos + 4, size)
            pos += 4 + size
            pos = max(pos, offsets[0])
            img = decode_jpeg_image(head + _safe(data, pos, lengths[0]))
            if img.mode == "CMYK":            # read as "CMYK", not "CMYK;I"
                img = ModeImage("CMYK", 255 - img.pixels)
            rgb = to_rgb(img)
            bgr = rgb[..., ::-1]
            if alpha:
                bgr = np.concatenate([bgr, np.full(bgr.shape[:2] + (1,), 255,
                                                   np.uint8)], -1)
            return _as_raw(np.ascontiguousarray(bgr).tobytes(), mode, w, h)
        if comp == 1 and enc in (4, 5):
            pal = _palette(data, pos)
            raw = _indexed(data, pos + 4 * len(pal), lengths[0], pal, alpha)
            return _as_raw(raw, mode, w, h)
        raise NotImplementedError(f"BLP1: unsupported compression {comp} / "
                                  f"encoding {enc} (PIL 12.1 refuses it)")
    pal = _palette(data, pos)
    if comp != 1:
        raise NotImplementedError(f"BLP2: unknown compression {comp} (PIL "
                                  "12.1 refuses it)")
    if enc == 1:
        raw = _indexed(data, offsets[0], lengths[0], pal, alpha)
    elif enc == 2:
        if aenc not in (0, 1, 7):
            raise NotImplementedError(f"BLP2: unsupported alpha encoding "
                                      f"{aenc} (PIL 12.1 refuses it)")
        bh = (h + 3) // 4
        line = (w + 3) // 4 * (8 if aenc == 0 else 16)
        _safe(data, offsets[0], bh * line)
        raw = bcn.decode_blp_dxt(data, offsets[0], w, h, aenc, alpha)
    else:
        raise NotImplementedError(f"BLP2: unknown encoding {enc} (PIL 12.1 "
                                  "refuses it)")
    return _as_raw(raw, mode, w, h)
