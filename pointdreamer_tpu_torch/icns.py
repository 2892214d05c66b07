"""Apple icon (ICNS) decoding, as PIL 12.1's IcnsImagePlugin reads it.

PIL opens the largest entry size the file holds (the greatest (width,
height, scale) among the types it knows) and reads every entry of that
size it has a reader for:
- PNG entries (ic07-ic14, icp4-icp6): the PNG, in its own mode;
- JPEG 2000 entries (a codestream or a JP2 file, of the entry's length):
  decoded by `jpeg2000.py`, then converted to "RGBA" (PIL's
  `read_png_or_jpeg2000`);
- 24-bit entries is32 / il32 / ih32 / it32 (it32 after four zero bytes):
  raw when the entry holds exactly 3 bytes a pixel, else the three
  channels one after the other, each run-length coded (a byte n < 128: n
  + 1 literal bytes; n >= 128: the next byte n - 125 times), "RGB";
- their masks s8mk / l8mk / h8mk / t8mk: the alpha channel, "RGBA".
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat, of_array, to_rgba
from .jpeg2000 import decode_jpeg2000

_PNG = "png"
# (width, height, scale) -> the entry types of that size, in PIL's order
_SIZES = {
    (512, 512, 2): [(b"ic10", _PNG)], (512, 512, 1): [(b"ic09", _PNG)],
    (256, 256, 2): [(b"ic14", _PNG)], (256, 256, 1): [(b"ic08", _PNG)],
    (128, 128, 2): [(b"ic13", _PNG)],
    (128, 128, 1): [(b"ic07", _PNG), (b"it32", "32t"), (b"t8mk", "mk")],
    (64, 64, 1): [(b"icp6", _PNG)], (32, 32, 2): [(b"ic12", _PNG)],
    (48, 48, 1): [(b"ih32", "32"), (b"h8mk", "mk")],
    (32, 32, 1): [(b"icp5", _PNG), (b"il32", "32"), (b"l8mk", "mk")],
    (16, 16, 2): [(b"ic11", _PNG)],
    (16, 16, 1): [(b"icp4", _PNG), (b"is32", "32"), (b"s8mk", "mk")],
}


def accepts(data: bytes) -> bool:
    return data[:4] == b"icns"


def probe(data: bytes):
    """IcnsFile: ({type: (start, length)}, best size)."""
    if len(data) < 8 or not accepts(data):
        raise NotThisFormat("not an icns file")
    filesize, = struct.unpack_from(">I", data, 4)
    entries = {}
    i = 8
    while i < filesize:
        if i + 8 > len(data) or i < 0:
            raise NotThisFormat("ICNS: the file ends inside an entry header")
        sig, block = struct.unpack_from(">4sI", data, i)
        if block <= 0:
            raise NotThisFormat("ICNS: invalid block header")
        i += 8
        block -= 8
        entries[sig] = (i, block)
        i += block
    sizes = [size for size, kinds in _SIZES.items()
             if any(code in entries for code, _ in kinds)]
    if not sizes:
        raise NotThisFormat("ICNS: no 32-bit icon resources found")
    return entries, max(sizes)


def _rle_channels(data: bytes, pos: int, n: int) -> np.ndarray:
    chans = []
    for band in range(3):
        out = bytearray()
        left = n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise SyntaxError(f"ICNS: error reading channel [{left} left]")
        if len(out) < n:
            raise ValueError("ICNS: not enough image data")
        chans.append(np.frombuffer(bytes(out[:n]), np.uint8))
    return np.stack(chans, -1)


def _read_32(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    n = side * side
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < length:
            raise ValueError("ICNS: not enough image data")
        return np.frombuffer(raw, np.uint8).reshape(side, side, 3)
    return _rle_channels(data, start, n).reshape(side, side, 3)


def decode_icns(data: bytes) -> ModeImage:
    """ICNS bytes -> the largest icon in PIL's mode (module docstring)."""
    entries, size = probe(data)
    side = size[0] * size[2]
    rgb = alpha = None
    for code, kind in _SIZES[size]:
        if code not in entries:
            continue
        start, length = entries[code]
        if kind == _PNG:
            sig = data[start:start + 12]
            if sig.startswith(b"\x89PNG\r\n\x1a\n"):
                from .io import decode_png

                return of_array(decode_png(data[start:]))
            if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) \
                    or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
                img = decode_jpeg2000(data[start:start + length])
                return img if img.mode == "RGBA" else ModeImage(
                    "RGBA", to_rgba(img))
            raise ValueError("ICNS: unsupported icon subimage format")
        if kind == "32t":
            if data[start:start + 4] != b"\0\0\0\0":
                raise SyntaxError("ICNS: unknown it32 signature")
            rgb = _read_32(data, start + 4, length - 4, side)
        elif kind == "32":
            rgb = _read_32(data, start, length, side)
        else:
            raw = data[start:start + side * side]
            if len(raw) < side * side:
                raise ValueError("ICNS: not enough mask data")
            alpha = np.frombuffer(raw, np.uint8).reshape(side, side)
    if alpha is None:
        return ModeImage("RGB", np.ascontiguousarray(rgb))
    return ModeImage("RGBA", np.ascontiguousarray(
        np.concatenate([rgb, alpha[..., None]], -1)))
