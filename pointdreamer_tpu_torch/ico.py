"""Windows icons, cursors and bare bitmaps (ICO, CUR, DIB), as PIL 12.1's
IcoImagePlugin, CurImagePlugin and BmpImagePlugin's DibImageFile read them.

- DIB: a BMP's info header with no file header (`io.decode_bmp` after a
  synthesised one; the pixels follow the header, its bit-field masks and
  its palette);
- ICO: the entry PIL picks (the largest, and of those the lowest colour
  depth: its directory sorted by depth, then stably by area), a PNG or a
  DIB of twice the height: the first half is the image, made "RGBA" with
  the alpha of a 32-bit DIB's fourth bytes, or else with the AND mask that
  ends the entry (1 bits transparent), both bottom-up;
- CUR: the first entry, or a later one wider and taller, its DIB of twice
  the height read as the image without a mask (a 32-bit DIB at offset 22
  keeps its alpha, as PIL's BMP reader keeps it there).
"""
from __future__ import annotations

import math
import struct

import numpy as np

from .imagemode import ModeImage, of_array

_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def dib_accepts(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] in \
        _DIB_HEADERS


def ico_accepts(data: bytes) -> bool:
    return data.startswith(b"\0\0\1\0")


def cur_accepts(data: bytes) -> bool:
    """CurImagePlugin's prefix and a cursor to read (it raises TypeError
    on none, and PIL goes on to the next plugin)."""
    return data.startswith(b"\0\0\2\0") and len(data) >= 22 and \
        struct.unpack_from("<H", data, 4)[0] > 0


def _as_bmp(dib: bytes, half: bool = False):
    """(a BMP file of the DIB at the start of `dib`, the DIB's pixel
    offset): the offset PIL's reader finds (after the header, a 40-byte
    header's bit-field masks and the palette), the height halved with
    `half`."""
    hsize, = struct.unpack_from("<I", dib)
    dib = bytearray(dib)
    if hsize == 12:
        bits, = struct.unpack_from("<H", dib, 10)
        comp, colors, pad = 0, 0, 3
        if half:
            h, = struct.unpack_from("<H", dib, 6)
            struct.pack_into("<H", dib, 6, h // 2)
    else:
        bits, comp = struct.unpack_from("<HI", dib, 14)
        colors, = struct.unpack_from("<I", dib, 32)
        pad = 4
        if half:
            raw, = struct.unpack_from("<I", dib, 8)
            if dib[11] == 0xFF:                          # top-down
                struct.pack_into("<I", dib, 8, 2 ** 32 - (2 ** 32 - raw) // 2)
            else:
                struct.pack_into("<I", dib, 8, raw // 2)
    off = hsize + (12 if comp == 3 and hsize == 40 else 0)
    if bits <= 8:
        off += pad * (colors or 1 << bits)
    return b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0,
                               14 + off) + bytes(dib), off


def decode_dib(data: bytes) -> ModeImage:
    """A bare DIB (a BMP without its file header) -> RGB or RGBA pixels."""
    from .io import decode_bmp

    bmp, _ = _as_bmp(data)
    return of_array(decode_bmp(bmp))


def _entries(data: bytes):
    n, = struct.unpack_from("<H", data, 4)
    out = []
    for i in range(n):
        e = data[6 + 16 * i:22 + 16 * i]
        if len(e) < 16:
            raise ValueError("ICO: the directory is truncated")
        w, h, ncol = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack_from("<HII", e, 6)
        depth = bpp or (ncol and math.ceil(math.log(ncol, 2))) or 256
        out.append(dict(w=w, h=h, bpp=bpp, size=size, offset=offset,
                        depth=depth, raw=e))
    return out


def decode_ico(data: bytes) -> ModeImage:
    """ICO bytes -> the entry PIL picks (see the module docstring)."""
    from .io import _PNG_SIG, decode_bmp, decode_png

    if not ico_accepts(data):
        raise ValueError("not an ICO file")
    entries = sorted(_entries(data), key=lambda e: e["depth"])
    entries = sorted(entries, key=lambda e: e["w"] * e["h"], reverse=True)
    if not entries:
        raise ValueError("ICO: no images")
    e = entries[0]
    body = data[e["offset"]:]
    if body[:8] == _PNG_SIG:
        return of_array(decode_png(body))
    bmp, off = _as_bmp(body, half=True)
    rgb = decode_bmp(bmp)[..., :3]
    h, w = rgb.shape[:2]
    if e["bpp"] == 32:
        start = e["offset"] + off
        a = np.frombuffer(data, np.uint8, w * h * 4, start)[3::4]
        alpha = a.reshape(h, w)[::-1]
    else:
        stride = -(-w // 32) * 4
        start = e["offset"] + e["size"] - stride * h
        rows = np.frombuffer(data, np.uint8, stride * h, start).reshape(
            h, stride)[::-1]
        alpha = np.where(np.unpackbits(rows, axis=1)[:, :w], 0, 255)
    return ModeImage("RGBA", np.concatenate(
        [rgb, alpha[..., None].astype(np.uint8)], -1))


def decode_cur(data: bytes) -> ModeImage:
    """CUR bytes -> the cursor PIL picks (see the module docstring)."""
    from .io import decode_bmp

    if not cur_accepts(data):
        raise ValueError("not a CUR file")
    n, = struct.unpack_from("<H", data, 4)
    m = None
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if m is None or (s[0] > m[0] and s[1] > m[1]):
            m = s
    at, = struct.unpack_from("<I", m, 12)
    bmp, _ = _as_bmp(data[at:], half=True)
    return of_array(decode_bmp(bmp, raw_alpha=at == 22))
