"""Adobe Photoshop (PSD) decoding, as PIL 12.1's PsdImagePlugin reads it:
the merged composite after the layer section, which is what `Image.open`
gives (the layers themselves are skipped, as PIL skips them until a
`seek`).

- colour modes (mode, depth) -> PIL mode: bitmap 1 bit "1" (a set bit
  white, as PIL's raw "1" reads it), greyscale / duotone / multichannel
  8 bits "L", indexed "P" (the 768-byte planar colour table as its
  palette; without one, PIL's all-black palette), RGB "RGB" ("RGBA" with
  exactly four channels), CMYK "CMYK" (each channel inverted, PIL's "C;I"
  ...); PIL's mode for Lab is "LAB", which this port refuses;
- channel data raw (compression 0) or PackBits (1, each row's byte counts
  first; a run past a row's end is cut there, as PackbitsDecode.c cuts
  it); other compressions open and fail to load, as in PIL.

Header checks whose failure sends PIL on to its next plugin (signature,
version 1, a known mode and depth, the sections' lengths readable) raise
`NotThisFormat`; too few channels for the mode raises OSError.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import BLACK_PALETTE, ModeImage, NotThisFormat

# (colour mode, bits) -> (PIL mode, channels it needs)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
          (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
          (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def accepts(data: bytes) -> bool:
    return data[:4] == b"8BPS"


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def u(self, fmt: str) -> int:
        size = struct.calcsize(fmt)
        raw = self.read(size)
        if len(raw) < size:
            raise NotThisFormat("PSD: the file ends inside its header")
        return struct.unpack(fmt, raw)[0]


def probe(data: bytes):
    """PsdImageFile._open: (mode, width, height, channels, palette,
    compression, byte counts or None, data offset)."""
    if not accepts(data) or len(data) < 26 or \
            struct.unpack_from(">H", data, 4)[0] != 1:
        raise NotThisFormat("not a PSD file")
    channels_in, h, w, bits, cmode = struct.unpack_from(">HIIHH", data, 12)
    if (cmode, bits) not in _MODES:
        raise NotThisFormat(f"PSD: colour mode {cmode} at {bits} bits, "
                            "which PIL 12.1 does not open")
    mode, channels = _MODES[(cmode, bits)]
    if channels > channels_in:
        raise OSError("PSD: not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    r = _Reader(data, 26)
    size = r.u(">I")
    palette = None
    if size:
        table = r.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(table, np.uint8).reshape(3, 256).T.copy()
    size = r.u(">I")                            # image resources
    if size:
        end = r.pos + size
        while r.pos < end:
            r.read(4)
            r.u(">H")
            name_len = r.read(1)
            if not name_len:
                raise NotThisFormat("PSD: the file ends in a resource")
            name = r.read(name_len[0])
            if not len(name) & 1:
                r.read(1)
            blob = r.read(r.u(">I"))
            if len(blob) & 1:
                r.read(1)
    size = r.u(">I")                            # layer and mask section
    if size:
        end = r.pos + size
        r.u(">I")
        r.pos = end
    comp = r.u(">H")
    counts = None
    if comp == 1:
        raw = r.read(channels * h * 2)
        if len(raw) < channels * h * 2:
            raise NotThisFormat("PSD: the row byte counts are cut short")
        counts = np.frombuffer(raw, ">u2").astype(np.int64)
    if w <= 0 or h <= 0:
        raise NotThisFormat("PSD: empty image")
    return mode, w, h, channels, palette, comp, counts, r.pos


def _packbits_rows(data: bytes, pos: int, rows: int, rowbytes: int):
    """PackbitsDecode.c over `rows` rows of `rowbytes`: runs and literals
    are cut at a row's end; 0x80 is a no-op."""
    out = np.zeros((rows, rowbytes), np.uint8)
    n = len(data)
    for y in range(rows):
        line = bytearray()
        while len(line) < rowbytes:
            if pos >= n:
                raise OSError("PSD: image file is truncated")
            b = data[pos]
            if b == 0x80:
                pos += 1
                continue
            if b & 0x80:
                if pos + 1 >= n:
                    raise OSError("PSD: image file is truncated")
                line += data[pos + 1:pos + 2] * (257 - b)
                pos += 2
            else:
                lit = data[pos + 1:pos + 2 + b]
                if len(lit) < b + 1:
                    raise OSError("PSD: image file is truncated")
                line += lit
                pos += b + 2
        out[y] = np.frombuffer(bytes(line[:rowbytes]), np.uint8)
    return out, pos


def decode_psd(data: bytes) -> ModeImage:
    """PSD bytes -> the merged image in PIL's mode (module docstring)."""
    mode, w, h, channels, palette, comp, counts, pos = probe(data)
    if mode == "LAB":
        raise NotImplementedError("PSD: a Lab image (PIL's mode \"LAB\"), "
                                  "which the port does not convert")
    if comp not in (0, 1):
        raise OSError(f"PSD: compression {comp}: cannot load this image "
                      "(PIL 12.1 refuses it too)")
    rowbytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    offset = pos
    for k in range(channels):
        if comp == 0:
            n = h * rowbytes
            if len(data) - offset < n:
                raise OSError("PSD: image file is truncated")
            rows = np.frombuffer(data, np.uint8, n, offset).reshape(
                h, rowbytes)
            offset += w * h
        else:
            rows, _ = _packbits_rows(data, offset, h, rowbytes)
            offset += int(counts[k * h:(k + 1) * h].sum())
        planes.append(rows)
    if mode == "1":
        return ModeImage("1", np.unpackbits(planes[0], axis=1)[:, :w] * 255)
    if mode in ("L", "P"):
        px = planes[0].copy()
        if mode == "L":
            return ModeImage("L", px)
        return ModeImage("P", px, palette if palette is not None else
                         BLACK_PALETTE)
    px = np.stack(planes, -1)
    if mode == "CMYK":
        px = 255 - px
    return ModeImage(mode, np.ascontiguousarray(px))
