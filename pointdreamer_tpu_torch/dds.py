"""DirectDraw Surface (DDS) and FTEX decoding, as PIL 12.1's
DdsImagePlugin and FtexImagePlugin read them.

DDS: the 124-byte header, then by its pixel-format flags, in PIL's order:
- RGB (+ ALPHAPIXELS): "RGB" / "RGBA" by bit masks, each channel
  (value & mask) >> its trailing zeros, over the mask's span, times 255,
  truncated (a short file reads as zeros);
- LUMINANCE: "L" at 8 bits, "LA" at 16 with ALPHAPIXELS;
- PALETTEINDEXED8: "P" with the 1024-byte RGBA palette after the header;
- FOURCC: DXT1 / DXT3 / DXT5 ("RGBA"), BC4U / ATI1 ("L"), BC5U / ATI2 /
  BC5S ("RGB"), and DX10 with the DXGI formats PIL names: BC1-BC5 (BC5
  signed too), BC6H UF16 / SF16 ("RGB"), BC7 and R8G8B8A8 ("RGBA"),
  decoded by `bcn.py`.
Any other format raises NotImplementedError as PIL does.

FTEX (Independence War 2 textures): one format a file, DXT1 ("RGBA",
through `bcn.py`) or raw "RGB".
"""
from __future__ import annotations

import struct

import numpy as np

from . import bcn
from .imagemode import ModeImage, NotThisFormat

_RGB, _ALPHAPIXELS, _FOURCC = 0x40, 0x1, 0x4
_LUMINANCE, _PAL8 = 0x20000, 0x20
# FourCC -> (BCn, pixel format, mode)
_FOURCCS = {b"DXT1": (1, "DXT1", "RGBA"), b"DXT3": (2, "DXT3", "RGBA"),
            b"DXT5": (3, "DXT5", "RGBA"), b"BC4U": (4, "BC4", "L"),
            b"ATI1": (4, "BC4", "L"), b"BC5S": (5, "BC5S", "RGB"),
            b"BC5U": (5, "BC5", "RGB"), b"ATI2": (5, "BC5", "RGB")}
# DXGI format -> (BCn, pixel format, mode); BCn 0 is raw RGBA
_DXGI = {70: (1, "BC1", "RGBA"), 71: (1, "BC1", "RGBA"),
         73: (2, "BC2", "RGBA"), 74: (2, "BC2", "RGBA"),
         76: (3, "BC3", "RGBA"), 77: (3, "BC3", "RGBA"),
         79: (4, "BC4", "L"), 80: (4, "BC4", "L"),
         82: (5, "BC5", "RGB"), 83: (5, "BC5", "RGB"),
         84: (5, "BC5S", "RGB"), 95: (6, "BC6H", "RGB"),
         96: (6, "BC6HS", "RGB"), 97: (7, "BC7", "RGBA"),
         98: (7, "BC7", "RGBA"), 99: (7, "BC7", "RGBA"),
         27: (0, "", "RGBA"), 28: (0, "", "RGBA"), 29: (0, "", "RGBA")}


def accepts(data: bytes) -> bool:
    return data[:4] == b"DDS "


def probe(data: bytes):
    """DdsImagePlugin._open: (mode, width, height, decoder, args, offset);
    raises NotThisFormat where PIL goes on to its next plugin."""
    if not accepts(data) or len(data) < 8:
        raise NotThisFormat("not a DDS file")
    size, = struct.unpack_from("<I", data, 4)
    if size != 124:
        raise OSError(f"DDS: unsupported header size {size}")
    header = data[8:128]
    if len(header) != 120:
        raise OSError(f"DDS: incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack_from("<3I", header)
    pfflags, = struct.unpack_from("<I", header, 72)
    fourcc = header[76:80]
    bitcount, = struct.unpack_from("<I", header, 80)
    if width <= 0 or height <= 0:
        raise NotThisFormat("DDS: empty image")
    if pfflags & _RGB:
        alpha = bool(pfflags & _ALPHAPIXELS)
        masks = struct.unpack_from(f"<{4 if alpha else 3}I", header, 84)
        return ("RGBA" if alpha else "RGB", width, height, "rgb",
                (bitcount, masks), 128)
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            return "L", width, height, "raw", (), 128
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            return "LA", width, height, "raw", (), 128
        raise OSError(f"DDS: unsupported bitcount {bitcount} for "
                      f"{pfflags}")
    if pfflags & _PAL8:
        return "P", width, height, "raw", (), 128 + 1024
    if pfflags & _FOURCC:
        if fourcc in _FOURCCS:
            n, fmt, mode = _FOURCCS[fourcc]
            return mode, width, height, "bcn", (n, fmt), 128
        if fourcc == b"DX10":
            if len(data) < 132:
                raise NotThisFormat("DDS: truncated DX10 header")
            dxgi, = struct.unpack_from("<I", data, 128)
            if dxgi not in _DXGI:
                raise NotImplementedError(
                    f"DDS: unimplemented DXGI format {dxgi} (PIL 12.1 does "
                    "not read it)")
            n, fmt, mode = _DXGI[dxgi]
            if n == 0:
                return mode, width, height, "raw", (), 148
            return mode, width, height, "bcn", (n, fmt), 148
        raise NotImplementedError(f"DDS: unimplemented pixel format "
                                  f"{fourcc!r} (PIL 12.1 does not read it)")
    raise NotImplementedError(f"DDS: unknown pixel format flags {pfflags}")


def _masked(data: bytes, offset: int, w: int, h: int, bitcount: int,
            masks) -> np.ndarray:
    """DdsRgbDecoder: little-endian pixels of bitcount // 8 bytes."""
    nb = bitcount // 8
    n = w * h
    if nb == 0:
        return np.zeros((h, w, len(masks)), np.uint8)
    raw = data[offset:offset + n * nb]
    raw = raw + bytes(n * nb - len(raw))
    b = np.frombuffer(raw, np.uint8).reshape(n, nb).astype(np.uint64)
    v = np.zeros(n, np.uint64)
    for k in range(nb):
        v |= b[:, k] << np.uint64(8 * k)
    out = []
    for mask in masks:
        if not mask:
            out.append(np.zeros(n, np.uint8))
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        x = ((v & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out.append(((x / total) * 255).astype(np.int64).astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, len(masks))


def _raw(data: bytes, offset: int, w: int, h: int, c: int) -> np.ndarray:
    n = w * h * c
    if len(data) - offset < n:
        raise ValueError("DDS: image file is truncated")
    return np.frombuffer(data, np.uint8, n, offset).reshape(h, w, c)


def decode_dds(data: bytes) -> ModeImage:
    """DDS bytes -> the image in PIL's mode (see the module docstring)."""
    mode, w, h, kind, args, offset = probe(data)
    if kind == "rgb":
        return ModeImage(mode, _masked(data, offset, w, h, *args))
    if kind == "bcn":
        px = bcn.decode(data, w, h, args[0], args[1], offset)
        return ModeImage(mode, px[..., 0] if mode == "L" else px)
    if mode == "P":
        pal = np.frombuffer(data[128:128 + 1024].ljust(1024, b"\0"),
                            np.uint8).reshape(256, 4).copy()
        return ModeImage("P", _raw(data, offset, w, h, 1)[..., 0].copy(),
                         pal)
    c = {"L": 1, "LA": 2, "RGBA": 4}[mode]
    px = _raw(data, offset, w, h, c)
    return ModeImage(mode, px[..., 0].copy() if c == 1 else px.copy())


def ftex_accepts(data: bytes) -> bool:
    return data[:4] == b"FTEX"


def ftex_probe(data: bytes):
    """FtexImagePlugin._open: (mode, width, height, format, payload)."""
    if not ftex_accepts(data) or len(data) < 32:
        raise NotThisFormat("not an FTEX file")
    w, h, _, count, fmt, where = struct.unpack_from("<6i", data, 8)
    if count != 1:
        raise AssertionError("FTEX: only single-format files are read")
    if where < 0:
        raise ValueError("FTEX: negative data offset")
    if len(data) < where + 4:
        raise NotThisFormat("FTEX: truncated")
    size, = struct.unpack_from("<i", data, where)
    payload = data[where + 4:where + 4 + size] if size >= 0 else \
        data[where + 4:]
    if fmt not in (0, 1):
        raise ValueError(f"FTEX: invalid texture compression format {fmt}")
    if w <= 0 or h <= 0:
        raise NotThisFormat("FTEX: empty image")
    return ("RGBA" if fmt == 0 else "RGB"), w, h, fmt, payload


def decode_ftex(data: bytes) -> ModeImage:
    """FTEX bytes -> "RGBA" (DXT1) or "RGB" pixels."""
    mode, w, h, fmt, payload = ftex_probe(data)
    if fmt == 0:
        return ModeImage(mode, bcn.decode(payload, w, h, 1, ""))
    if len(payload) < w * h * 3:
        raise ValueError("FTEX: image file is truncated")
    return ModeImage(mode, np.frombuffer(payload, np.uint8, w * h * 3
                                         ).reshape(h, w, 3).copy())
