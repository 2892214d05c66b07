"""SGI image decoding in numpy, as PIL 12.1's SgiImagePlugin reads it.

- magic 474, 1 or 2 bytes a channel, dimension 1 to 3, 1 ("L"), 3 ("RGB")
  or 4 ("RGBA") channels; 16-bit channels by their high byte;
- uncompressed: one plane a channel, rows bottom-up; run-length encoded
  (SgiRleDecode.c): a row offset and length table a channel, each row
  packets of a count (the top bit: copy that many values, else repeat the
  next value) ended by a zero count.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage

# (bytes a channel, dimension, channels) -> mode
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
          (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
          (2, 3, 4): "RGBA"}


def accepts(data: bytes) -> bool:
    return len(data) >= 2 and struct.unpack_from(">H", data)[0] == 474


def _rle_row(data: bytes, pos: int, length: int, w: int, bpc: int):
    dt = ">u2" if bpc == 2 else np.uint8
    vals = np.frombuffer(data[pos:pos + length] + bytes(bpc), dt)
    out, i = [], 0
    while True:
        if i >= len(vals):
            raise ValueError("SGI: RLE row ends without its end mark")
        c = int(vals[i])
        i += 1
        n = c & 0x7F
        if not n:
            break
        if c & 0x80:
            out.extend(vals[i:i + n].tolist())
            i += n
        else:
            out.extend([int(vals[i])] * n)
            i += 1
        if len(out) > w:
            raise ValueError("SGI: an RLE row longer than the image")
    if len(out) != w:
        raise ValueError("SGI: an RLE row shorter than the image")
    return out


def decode_sgi(data: bytes) -> ModeImage:
    """SGI bytes -> the image in PIL's mode (see the module docstring)."""
    if not accepts(data) or len(data) < 512:
        raise ValueError("not an SGI image")
    rle, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">HHHH", data, 4)
    mode = _MODES.get((bpc, dim, z))
    if mode is None:
        raise ValueError(f"SGI: {bpc} bytes a channel, dimension {dim} and "
                         f"{z} channels is not a mode PIL 12.1 reads")
    c = len(mode)
    if rle == 0:
        dt = ">u2" if bpc == 2 else np.uint8
        need = w * h * c * bpc
        if len(data) - 512 < need:
            raise ValueError("SGI: image data is truncated")
        px = np.frombuffer(data, dt, w * h * c, 512).reshape(c, h, w)
    elif rle == 1:
        starts = struct.unpack_from(f">{h * z}I", data, 512)
        lengths = struct.unpack_from(f">{h * z}I", data, 512 + 4 * h * z)
        px = np.array([[_rle_row(data, starts[ch * h + y],
                                 lengths[ch * h + y], w, bpc)
                        for y in range(h)] for ch in range(c)], np.int64)
    else:
        raise ValueError(f"SGI: compression {rle}")
    if bpc == 2:
        px = px.astype(np.int64) >> 8
    px = np.ascontiguousarray(px.transpose(1, 2, 0)[::-1].astype(np.uint8))
    return ModeImage(mode, px[..., 0] if mode == "L" else px)
