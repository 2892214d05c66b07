"""FITS decoding, as PIL 12.1's FitsImagePlugin reads it.

The header is read in 80-byte cards up to END (the next unit starting at
a multiple of 2880 bytes); the first card must be SIMPLE = T.  The image
is the first unit with NAXIS > 0 (keywords of earlier units carry over,
as PIL keeps them): width NAXIS1 (1 for a 1-axis image), height NAXIS2,
and BITPIX 8 -> "L", 16 -> "I;16", 32 -> "I", -32 / -64 -> "F".  PIL reads
the samples with its raw modes of the same names, which are little-endian
(and "F" four bytes a sample even at -64), rows bottom-up: so does the
port, to give PIL's pixels.

A BINTABLE extension with ZIMAGE = T and ZCMPTYPE 'GZIP_1' is a
tile-compressed image: its size and BITPIX are the Z keywords, and the
gzip stream after the table (NAXIS1 x NAXIS2 x BITPIX / 8 bytes) holds
4 bytes a pixel, of which the last BITPIX / 8 (at most 4) are kept, rows
top-down in the stream and flipped as PIL flips them.
"""
from __future__ import annotations

import gzip
import math

import numpy as np

from .imagemode import ModeImage, NotThisFormat

_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"),
          -32: ("F", "<f4"), -64: ("F", "<f4")}


def accepts(data: bytes) -> bool:
    return data[:6] == b"SIMPLE"


def _size(headers, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers):
    prefix, gz, offset = b"", False, 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, b"") or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, gz = b"Z", True
    size = _size(headers, prefix)
    if not size:
        return None
    bitpix = int(headers[prefix + b"BITPIX"])
    return size, bitpix, gz, offset


def probe(data: bytes):
    """FitsImageFile._open: (width, height, BITPIX, gzip?, data offset)."""
    headers = {}
    in_header = False
    found = None
    pos = 0
    try:
        while True:
            card = data[pos:pos + 80]
            pos += len(card)
            if not card:
                raise OSError("FITS: truncated file")
            key = card[:8].strip()
            if key in (b"SIMPLE", b"XTENSION"):
                in_header = True
            elif headers and not in_header:
                break
            elif key == b"END":
                pos = math.ceil(pos / 2880) * 2880
                if not found:
                    found = _parse(headers)
                in_header = False
                continue
            if found:
                continue
            value = card[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not accepts(key) or value != b"T"):
                raise NotThisFormat("not a FITS file")
            headers[key] = value
    except KeyError as e:
        raise NotThisFormat(f"FITS: missing keyword {e}") from e
    if not found:
        raise ValueError("FITS: no image data")
    (w, h), bitpix, gz, offset = found
    if bitpix not in _MODES:
        raise ValueError(f"FITS: BITPIX {bitpix}, which PIL 12.1 has no "
                         "mode for")
    if w <= 0 or h <= 0:
        raise NotThisFormat("FITS: empty image")
    return w, h, bitpix, gz, offset + pos - 80


def decode_fits(data: bytes) -> ModeImage:
    """FITS bytes -> the image in PIL's mode (see the module docstring)."""
    w, h, bitpix, gz, offset = probe(data)
    mode, dt = _MODES[bitpix]
    size = np.dtype(dt).itemsize
    if gz:
        raw = gzip.decompress(data[offset:])
        keep = min(bitpix // 8, 4)
        if keep <= 0 or len(raw) < 4 * w * h:
            raise ValueError("FITS: not enough image data")
        words = np.frombuffer(raw, np.uint8, 4 * w * h).reshape(h, w, 4)
        buf = np.ascontiguousarray(words[::-1, :, 4 - keep:]).tobytes()
        if len(buf) < w * h * size:
            raise ValueError("FITS: not enough image data")
        px = np.frombuffer(buf, dt, w * h).reshape(h, w)
    else:
        if len(data) - offset < w * h * size:
            raise ValueError("FITS: image file is truncated")
        px = np.frombuffer(data, dt, w * h, offset).reshape(h, w)[::-1]
    kind = {"L": np.uint8, "I;16": np.uint16, "I": np.int32,
            "F": np.float32}[mode]
    return ModeImage(mode, np.ascontiguousarray(px).astype(kind))
