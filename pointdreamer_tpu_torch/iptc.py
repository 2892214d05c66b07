"""IPTC/NAA image decoding, as PIL 12.1's IptcImagePlugin reads it.

The file is a run of IPTC fields (0x1C, record, dataset, a length: two
bytes, or 0x80 + n and an n-byte length, 0x80 alone for none) up to the
first 8:10 field; 3:60 gives the layers and component flag ("L" for one
layer, "RGB" / "CMYK" for 3 / 4 component layers), 3:65 the band a single
band holds (1-based), 3:20 / 3:30 the size and 3:120 the compression (1
raw, 5 JPEG).  The 8:10 fields hold the pixels: raw bytes read as a PGM
of the image's size, or a file of its own (a JPEG) read by content.  A
multi-band image gets that one band and black in the others, as PIL
merges it.

IPTC has no signature: PIL runs this parser on every file no earlier
plugin took, so a parse failure goes on to the next plugin
(`NotThisFormat`); a field longer than 132 is an OSError.
"""
from __future__ import annotations

import struct

import numpy as np

from .imagemode import ModeImage, NotThisFormat


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


class _Fields:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def field(self):
        s = self.read(5)
        if not s.strip(b"\0"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _i(self.read(size - 128))
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        return tag, size


def probe(data: bytes):
    """IptcImageFile._open: (mode, band or None, width, height,
    compression, offset of the first 8:10 field or None)."""
    try:
        f = _Fields(data)
        info = {}
        while True:
            offset = f.pos
            tag, size = f.field()
            if not tag or tag == (8, 10):
                break
            blob = f.read(size) if size else None
            if tag in info:
                info[tag] = (info[tag] + [blob]) if isinstance(
                    info[tag], list) else [info[tag], blob]
            else:
                info[tag] = blob
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        w, h = _i(info[(3, 20)]), _i(info[(3, 30)])
        try:
            comp = {1: "raw", 5: "jpeg"}[_i(info[(3, 120)])]
        except KeyError as e:
            raise OSError("unknown IPTC image compression") from e
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError,
            struct.error) as e:
        raise NotThisFormat(f"IPTC: {e}") from e
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat("IPTC: not identified")
    return mode, band, w, h, comp, offset if tag == (8, 10) else None


def decode_iptc(data: bytes) -> ModeImage:
    """IPTC bytes -> the image in PIL's mode (see the module docstring)."""
    from .io import decode_image, decode_pnm

    mode, band, w, h, comp, offset = probe(data)
    if offset is None:
        raise OSError("IPTC: cannot load this image (no 8:10 field)")
    f = _Fields(data, offset)
    body = bytearray()
    while True:
        kind, size = f.field()
        if kind != (8, 10):
            break
        body += f.read(size)
    if comp == "raw":
        img = decode_pnm(b"P5\n%d %d\n255\n" % (w, h) + bytes(body))
    else:
        img = decode_image(bytes(body))
    if band is None:
        return img
    if img.mode != "L" or img.pixels.shape != (h, w):
        raise ValueError("IPTC: a band that is not an 'L' image of the "
                         "image's size (PIL cannot merge it)")
    px = np.zeros((h, w, len(mode)), np.uint8)
    px[..., band] = img.pixels
    return ModeImage(mode, px)
