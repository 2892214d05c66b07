"""Autodesk FLI / FLC decoding, as PIL 12.1's FliImagePlugin reads it:
the first frame, mode "P".

The palette is a grey ramp unless the first frame chunk (after an
optional prefix chunk) holds a COLOR_256 (type 4, 8-bit) or COLOR_64
(type 11, 6-bit, shifted left 2) chunk before any other it cannot skip:
packets of (skip, count or 0 for 256) entries.  The frame at byte 128 is
decoded as FliDecode.c decodes it, onto a black (index 0) image: BLACK
(13), COPY (16), BRUN (15: per row a packet count byte, then runs of a
byte, or literals where the count is negative), LC (12: a start row and
a row count, per row packets of a skip, then a literal count or a
negative run count) and SS2 (7: word runs, line skips and the odd last
byte); colour and stamp chunks are skipped, any other chunk or data
running past the frame is an error.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat


def accepts(data: bytes) -> bool:
    if len(data) < 16:
        return False
    magic, = struct.unpack_from("<H", data, 4)
    flags, = struct.unpack_from("<H", data, 14)
    return magic in (0xAF11, 0xAF12) and flags in (0, 3)


def _palette(data: bytes, pos: int, shift: int, pal: list) -> None:
    count, = struct.unpack_from("<H", data, pos)
    pos += 2
    i = 0
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += 2
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            pal[i] = tuple((s[k + c] << shift) & 255 for c in range(3))
            i += 1


def probe(data: bytes):
    """FliImageFile._open: (width, height, palette [256, 3])."""
    s = data[:128]
    if not (accepts(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise NotThisFormat("not an FLI/FLC file")
    w, h = struct.unpack_from("<HH", data, 8)
    pal = [(a, a, a) for a in range(256)]
    try:
        pos = 128
        s = data[pos:pos + 16]
        if struct.unpack_from("<H", s, 4)[0] == 0xF100:
            pos = 128 + struct.unpack_from("<I", s)[0]
            s = data[pos:pos + 16]
        pos += 16
        if struct.unpack_from("<H", s, 4)[0] == 0xF1FA:
            chunk = None
            for _ in range(struct.unpack_from("<H", s, 6)[0]):
                if chunk is not None:
                    pos += chunk - 6
                s = data[pos:pos + 6]
                pos += len(s)
                kind = struct.unpack_from("<H", s, 4)[0]
                if kind in (4, 11):
                    _palette(data, pos, 2 if kind == 11 else 0, pal)
                    break
                chunk = struct.unpack_from("<I", s)[0]
                if not chunk:
                    break
        if len(data) < 132:
            raise EOFError("FLI: missing frame size")
    except (struct.error, IndexError, TypeError, EOFError) as e:
        raise NotThisFormat(f"FLI: {e}") from e
    if w <= 0 or h <= 0:
        raise NotThisFormat("FLI: empty image")
    return w, h, np.array(pal, np.uint8)


def _u16(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8)


def _frame(buf: bytes, w: int, h: int) -> np.ndarray:
    """FliDecode.c on one frame buffer."""
    img = np.zeros((h, w), np.uint8)
    size, = struct.unpack_from("<I", buf)
    if len(buf) + len(buf) % 2 < size:
        raise OSError("FLI: image file is truncated")
    if len(buf) < 8:
        raise OSError("FLI: frame overrun")
    if _u16(buf, 4) != 0xF1FA:
        raise OSError("FLI: not a frame chunk (decoder error)")
    chunks = _u16(buf, 6)
    ptr = 16
    end = len(buf)

    def oob(d, k):
        if d + k > end:
            raise OSError("FLI: chunk data past the frame (overrun)")

    for _ in range(chunks):
        if end - ptr < 10:
            raise OSError("FLI: frame overrun")
        d = ptr + 6
        kind = _u16(buf, ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:                                     # SS2
            lines = _u16(buf, d)
            d += 2
            y = l = 0
            while l < lines and y < h:
                row = y
                oob(d, 2)
                packets = _u16(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise OSError("FLI: SS2 skips past the image")
                        row = y
                    else:
                        img[row, w - 1] = packets & 0xFF
                    oob(d, 2)
                    packets = _u16(buf, d)
                    d += 2
                x = p = 0
                while p < packets:
                    oob(d, 2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        oob(d, 4)
                        i = 256 - buf[d + 1]
                        if x + 2 * i > w:
                            break
                        img[row, x:x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, d + 2), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > w:
                            break
                        oob(d, 2 + i)
                        img[row, x:x + i] = np.frombuffer(buf, np.uint8, i,
                                                          d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l += 1
                y += 1
            if l < lines:
                raise OSError("FLI: SS2 overrun")
        elif kind == 12:                                    # LC
            y = _u16(buf, d)
            ymax = y + _u16(buf, d + 2)
            d += 4
            while y < ymax and y < h:
                oob(d, 1)
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    oob(d, 2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > w:
                            break
                        oob(d, 3)
                        img[y, x:x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > w:
                            break
                        oob(d, 2 + i)
                        img[y, x:x + i] = np.frombuffer(buf, np.uint8, i,
                                                        d + 2)
                        d += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise OSError("FLI: LC overrun")
        elif kind == 13:                                    # BLACK
            img[:] = 0
        elif kind == 15:                                    # BRUN
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    oob(d, 2)
                    if buf[d] & 0x80:
                        i = 256 - buf[d]
                        if x + i > w:
                            break
                        oob(d, i + 1)
                        img[y, x:x + i] = np.frombuffer(buf, np.uint8, i,
                                                        d + 1)
                        d += i + 1
                    else:
                        i = buf[d]
                        if x + i > w:
                            break
                        img[y, x:x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != w:
                    raise OSError("FLI: BRUN overrun")
        elif kind == 16:                                    # COPY
            if d + w * h > end:
                raise OSError("FLI: image file is truncated (COPY)")
            img[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
        else:
            raise OSError(f"FLI: unknown chunk type {kind}")
        advance, = struct.unpack_from("<i", buf, ptr)
        if advance == 0:
            raise OSError("FLI: a chunk of size 0")
        if advance < 0 or advance > end - ptr:
            raise OSError("FLI: chunk size overrun")
        ptr += advance
    return img


def decode_fli(data: bytes) -> ModeImage:
    """FLI / FLC bytes -> the first frame, "P" with its palette."""
    w, h, pal = probe(data)
    size, = struct.unpack_from("<I", data, 128)
    return ModeImage("P", _frame(data[128:128 + size], w, h), pal)
