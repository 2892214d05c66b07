"""PCX decoding in numpy, as PIL 12.1's PcxImagePlugin reads it.

- 1 bit, 1 plane ("1"); 1 bit, 2 or 4 planes ("P", the header's 16-colour
  palette); version 5 at 8 bits, 1 plane ("P" with the 256-colour palette
  that follows a 12 at 769 bytes from the end, "L" where that palette is
  the grey ramp or absent); version 5 at 8 bits, 3 planes ("RGB");
- PcxDecode.c's run-length rows: a line of planes x stride bytes, where
  the stride is the row's bytes rounded up to even when the header's
  bytes-per-line differs from it, and the planes moved together before
  they are unpacked as PcxDecode.c moves them (runs that run past a line
  are an error).

`decode_pcx` takes the header's offset, for DCX (`dcx.py`).
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat


def accepts(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def probe(data: bytes, start: int = 0) -> None:
    """PcxImageFile._open's checks before it commits: the signature and
    a positive size (a header too short to hold it is not a PCX)."""
    head = data[start:start + 68]
    if not accepts(head) or len(head) < 12:
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", head, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")


def _rows(data: bytes, pos: int, h: int, nbytes: int) -> np.ndarray:
    out = bytearray()
    need = h * nbytes
    x = 0
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("PCX: image data is truncated")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError("PCX: image data is truncated")
            count = b & 0x3F
            if x + count > nbytes:
                raise ValueError("PCX: a run past the end of a line")
            out += data[pos + 1:pos + 2] * count
            x += count
            pos += 2
        else:
            out.append(b)
            x += 1
            pos += 1
        if x >= nbytes:
            x = 0
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, nbytes)


def decode_pcx(data: bytes, start: int = 0) -> ModeImage:
    """PCX bytes (the header at `start`) -> the image in PIL's mode (see
    the module docstring)."""
    probe(data, start)
    if len(data) - start < 128:
        raise ValueError("PCX: truncated header")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", data, start + 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    version, bits, planes = data[start + 1], data[start + 3], data[
        start + 65]
    provided, = struct.unpack_from("<H", data, start + 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(data, np.uint8, 48,
                                     start + 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if (pal != np.arange(256)[:, None]).any():
                mode, palette = "P", pal.copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise NotImplementedError(f"PCX: version {version} with {bits} "
                                  f"bits and {planes} planes, which PIL "
                                  "12.1 does not read")
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    nbytes = planes * stride
    rows = _rows(data, start + 128, h, nbytes)
    if mode == "1":
        px = np.unpackbits(rows, axis=1)[:, :w] * 255
    elif bits == 1:
        # "P;2L" / "P;4L": a plane a bit, `stride` bytes apart (PcxDecode.c
        # moves the planes together when the stride is padded)
        bitplanes = [np.unpackbits(rows[:, k * stride:(k + 1) * stride],
                                   axis=1)[:, :w] for k in range(planes)]
        px = sum(bp.astype(np.uint8) << k for k, bp in enumerate(bitplanes))
    elif mode == "RGB":
        # PcxDecode.c takes bytes // width bands, and moves them width apart
        # only where that leaves them further apart than the width
        bands = nbytes // w
        step = nbytes // bands
        step = step if step > w else w
        px = np.stack([rows[:, k * step:k * step + w] for k in range(3)], -1)
    else:
        px = rows[:, :w]
    px = np.ascontiguousarray(px.astype(np.uint8))
    return ModeImage(mode, px, palette)

