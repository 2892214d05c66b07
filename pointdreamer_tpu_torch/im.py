"""IFUNC Image Memory (IM) and IM Tools (IMT) decoding, as PIL 12.1's
ImImagePlugin and ImtImagePlugin read them.

IM: a text header of "Key: value" lines (each under 101 bytes, ended by
LF or CR LF) up to a 0x1A byte, then an optional 768-byte lookup table
(planar R, G, B) and the pixels, rows bottom-up.  "Image type" picks the
mode and raw mode from PIL's table (`_OPEN`): "1", "L", "P" (2 or 4
bits), "RGB" (line-planar "RGB;L", pixel-interleaved, or the three G, R,
B planes of "RGB3"/"RYB3"), "LA", "RGBA", "RGBX", "CMYK", "I" (32-bit
signed), "I;16" / "I;16L" / "I;16B", "YCbCr", and "F" from unsigned or signed
8/16/32-bit integers, 32-bit floats or any width from 2 to 31 bits
(BitDecode.c, least significant bit first, a row padded to a byte).  A
lookup table that is not grey turns "L" into "P" and "LA" / "PA" into
"PA" with it as the palette; a grey one changes nothing.  PIL has no raw
mode for "RLB image", "RYB image" and "PA image" and fails to load them;
so does the port.

IM has no signature: PIL runs its header parser on every file no earlier
plugin took, so a parse failure sends the file on (`NotThisFormat`).

IMT: "width n" / "height n" / "pixel n8" lines up to a form feed, then
"L" bytes.
"""
from __future__ import annotations

import re

import numpy as np

from .imagemode import BLACK_PALETTE, ModeImage, NotThisFormat

_COMMENT, _FRAMES, _LUT = "Comment", "File size (no of images)", "Lut"
_SCALE, _SIZE, _MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
_TAGS = {_COMMENT, "Date", "Digitalization equipment", _FRAMES, _LUT,
         "Name", _SCALE, _SIZE, _MODE}


def _open_table():
    """ImImagePlugin.OPEN: "Image type" -> (mode, raw mode)."""
    t = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
         "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
         "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
         "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
         "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
         "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
         "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
         "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
         "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
         "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
         "YCC image": ("YCbCr", "YCbCr;L")}
    for i in ("8", "8S", "16", "16S", "32", "32F"):
        t[f"L {i} image"] = t[f"L*{i} image"] = ("F", f"F;{i}")
    for i in ("16", "16L", "16B"):
        t[f"L {i} image"] = t[f"L*{i} image"] = (f"I;{i}", f"I;{i}")
    t["L 32S image"] = t["L*32S image"] = ("I", "I;32S")
    for j in range(2, 33):
        t[f"L*{j} image"] = ("F", f"F;{j}")
    return t


_OPEN = _open_table()
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# raw mode -> (bits a pixel, planes a row or None, sample dtype)
_RAW = {"1": (1, None, None), "L": (8, None, "u1"), "P;2": (2, None, None),
        "P;4": (4, None, None), "RGB": (24, None, "u1"),
        "RGB;L": (24, 3, "u1"), "LA;L": (16, 2, "u1"),
        "PA;L": (16, 2, "u1"), "RGBA;L": (32, 4, "u1"),
        "RGBX;L": (32, 4, "u1"), "CMYK;L": (32, 4, "u1"),
        "YCbCr;L": (24, 3, "u1"),
        "I;32": (32, None, "<i4"), "I;32S": (32, None, "<i4"),
        "I;16": (16, None, "<u2"), "I;16L": (16, None, "<u2"),
        "I;16B": (16, None, ">u2"), "F;8": (8, None, "u1"),
        "F;8S": (8, None, "i1"), "F;16": (16, None, "<u2"),
        "F;16S": (16, None, "<i2"), "F;32": (32, None, "<u4"),
        "F;32F": (32, None, "<f4"), "P": (8, None, "u1")}
_MODES = {m for m, _ in _OPEN.values()}


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def probe(data: bytes):
    """ImImageFile._open: (info, mode, raw mode, palette, data offset)."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {_MODE: "L", _SIZE: (512, 512), _FRAMES: 1}
    rawmode = "L"
    n = 0
    pos = 0
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise NotThisFormat("IM: syntax error in the header")
        k = m.group(1).decode("latin-1", "replace")
        v = m.group(2).decode("latin-1", "replace")
        if k in (_FRAMES, _SCALE, _SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == _MODE and v in _OPEN:
            v, rawmode = _OPEN[v]
        info[k] = v
        if k in _TAGS:
            n += 1
    if not n:
        raise NotThisFormat("not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += 1
    if not s:
        raise NotThisFormat("IM: file truncated")
    mode = info[_MODE]
    if mode not in _MODES:
        raise ValueError(f"IM: unknown image type {mode!r}")
    size = info[_SIZE]
    if not isinstance(size, tuple) or len(size) != 2:
        raise NotThisFormat("IM: no image size")
    palette = None
    if _LUT in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            raise NotThisFormat("IM: lookup table cut short")
        t = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = (t[0] == t[1]).all() and (t[1] == t[2]).all()
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = t.T.copy()
    w, h = size
    if not isinstance(w, int) or not isinstance(h, int) or w <= 0 or h <= 0:
        raise NotThisFormat("IM: empty image")
    return info, mode, rawmode, palette, pos


def _bits(data: bytes, pos: int, w: int, h: int, bits: int) -> np.ndarray:
    """BitDecode.c with fill 3 (least significant bit first), a row
    padded to a byte (its bit count reset, the buffer kept), bottom-up."""
    out = np.zeros((h, w), np.float32)
    mask = (1 << bits) - 1
    y, x, buf, cnt = h - 1, 0, 0, 0
    for byte in data[pos:]:
        buf |= byte << cnt
        cnt += 8
        while cnt >= bits:
            v = buf & mask
            buf = byte >> (8 - (cnt - bits)) if cnt > 32 else buf >> bits
            cnt -= bits
            out[y, x] = v
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out
                x, cnt = 0, 0
    raise ValueError("IM: image file is truncated")


def _rows(data: bytes, pos: int, w: int, h: int, bits: int) -> np.ndarray:
    stride = (w * bits + 7) // 8
    if len(data) - pos < stride * h:
        raise ValueError("IM: image file is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
    return rows[::-1]


def decode_im(data: bytes) -> ModeImage:
    """IM bytes -> the image in PIL's mode (see the module docstring)."""
    info, mode, rawmode, palette, pos = probe(data)
    w, h = info[_SIZE]
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and \
            int(rawmode[2:]) not in (8, 16, 32):
        return ModeImage("F", _bits(data, pos, w, h, int(rawmode[2:])))
    if rawmode in ("RGB;T", "RYB;T"):
        n = w * h
        if len(data) - pos < 3 * n:
            raise ValueError("IM: image file is truncated")
        g, r, b = (np.frombuffer(data, np.uint8, n, pos + k * n).reshape(
            h, w)[::-1] for k in range(3))
        return ModeImage("RGB", np.ascontiguousarray(np.stack([r, g, b],
                                                              -1)))
    if rawmode not in _RAW or (rawmode == "PA;L" and mode != "PA"):
        raise ValueError(f"IM: PIL 12.1 has no raw mode {rawmode!r} for "
                         f"mode {mode!r}")
    bits, planes, dt = _RAW[rawmode]
    rows = _rows(data, pos, w, h, bits)
    if bits < 8:
        v = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
        idx = (v * (1 << np.arange(bits - 1, -1, -1))).sum(-1)
        if mode == "1":
            return ModeImage("1", (idx * 255).astype(np.uint8))
        return ModeImage("P", idx.astype(np.uint8), palette if palette is
                         not None else BLACK_PALETTE)
    if planes:
        px = rows[:, :w * planes].reshape(h, planes, w).transpose(0, 2, 1)
        if rawmode == "RGBX;L":
            px = px[..., :3]
        px = np.ascontiguousarray(px)
        if mode == "PA":
            return ModeImage("PA", px, palette)
        return ModeImage(mode, px)
    if rawmode in ("L", "RGB", "P"):
        px = rows[:, :w * bits // 8].reshape(h, w, -1)
        if mode == "P":
            return ModeImage("P", np.ascontiguousarray(px[..., 0]),
                             palette)
        return ModeImage(mode, np.ascontiguousarray(
            px if rawmode == "RGB" else px[..., 0]))
    v = np.frombuffer(np.ascontiguousarray(rows[:, :w * bits // 8]).tobytes(),
                      dt).reshape(h, w)
    if mode == "F":
        return ModeImage("F", v.astype(np.float32))
    if mode == "I":
        return ModeImage("I", v.astype(np.int32))
    return ModeImage(mode, v.astype(np.uint16))


# ---------------------------------------------------------------------------
# IMT

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_probe(data: bytes):
    """ImtImageFile._open: (mode, width, height, data offset or None)."""
    buffer = data[:100]
    pos = len(buffer)
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM Tools file")
    w = h = 0
    mode = ""
    offset = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            pos += len(more)
            buffer += more
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat("IM Tools: not identified")
    return mode, w, h, offset


def decode_imt(data: bytes) -> ModeImage:
    """IMT bytes -> "L" pixels (rows top-down after the form feed)."""
    mode, w, h, offset = imt_probe(data)
    if offset is None:
        raise OSError("IM Tools: cannot load this image (no form feed "
                      "before the pixels, as PIL 12.1 finds)")
    if len(data) - offset < w * h:
        raise ValueError("IM Tools: image file is truncated")
    return ModeImage("L", np.frombuffer(data, np.uint8, w * h, offset
                                        ).reshape(h, w).copy())
