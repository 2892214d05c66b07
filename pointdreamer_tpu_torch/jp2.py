"""JP2 boxes (ITU-T T.800 Annex I) and PIL 12.1's choice of size and mode
for a JPEG 2000 file (`Jpeg2KImagePlugin._parse_codestream` and
`_parse_jp2_header`), with what OpenJPEG 2.5 takes from the boxes.

- a raw codestream: the size is (Xsiz - XOsiz, Ysiz - YOsiz); one
  component gives "I;16" above 8 bits, else "L"; 2 give "LA", 3 "RGB", 4
  "RGBA"; anything else raises SyntaxError, as PIL;
- a JP2 file: the signature box, then the boxes up to `jp2h`; in it
  `ihdr` gives the size and the mode as above, a `colr` box of method 1
  and enumerated space 12 at 4 components gives "CMYK", a `pclr` box on
  "L" / "LA" with entries of at most 8 bits gives "P" / "PA" and the
  palette PIL builds (`ImagePalette.getcolor` per entry: a repeated
  colour takes its first index, the rest move down); `res ` is metadata;
- OpenJPEG's colour space: the first `colr` box's enumerated space (16
  sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK; anything else, an ICC
  profile included, unknown, which PIL guesses as it guesses a raw
  codestream's), and the codestream of the first `jp2c` box.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
CODESTREAM = b"\xff\x4f\xff\x51"

# OpenJPEG's OPJ_COLOR_SPACE
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


@dataclass
class Header:
    size: Tuple[int, int]
    mode: str
    codestream: bytes
    color_space: int
    palette: Optional[np.ndarray] = None          # [256, 3] uint8


def _boxes(data: bytes, pos: int, end: int) -> List[Tuple[bytes, int, int]]:
    """(type, content start, content end) of each box up to `end` (a
    length of 1: an 8-byte length follows; 0: the rest), as OpenJPEG
    finds them."""
    out = []
    while pos + 8 <= end:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > end:
                break
            lbox, = struct.unpack_from(">Q", data, pos + 8)
            hlen = 16
        elif lbox == 0:
            lbox = end - pos
        if lbox < hlen:
            break
        out.append((tbox, pos + hlen, min(pos + lbox, end)))
        pos += lbox
    return out


def _pil_boxes(data: bytes, pos: int, end: Optional[int]):
    """PIL's BoxReader: (type, content start, content end) box after box;
    `end` None for the top level, which PIL reads with no length."""
    while end is None or pos < end:
        limit = len(data) if end is None else end
        if pos + 8 > limit:
            if end is None:
                raise OSError("JP2: the file ends where a box header "
                              "should start (PIL reads past its end)")
            raise SyntaxError("Not enough data in header")
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > limit:
                raise SyntaxError("Not enough data in header")
            lbox, = struct.unpack_from(">Q", data, pos + 8)
            hlen = 16
        if lbox < hlen or (end is not None and pos + lbox > end):
            raise SyntaxError("Invalid header length")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


def _fields(data: bytes, s: int, e: int, fmt: str):
    if s + struct.calcsize(fmt) > e:
        raise SyntaxError("Not enough data in header")
    return struct.unpack_from(fmt, data, s)


def codestream_mode(cs: bytes) -> Tuple[Tuple[int, int], str]:
    """PIL's _parse_codestream on a codestream from its SOC marker."""
    if len(cs) < 4 + 38:
        raise SyntaxError("JPEG 2000: a truncated SIZ marker")
    (_, _, xsiz, ysiz, xo, yo, _, _, _, _, csiz) = struct.unpack_from(
        ">HHIIIIIIIIH", cs, 4)
    size = (xsiz - xo, ysiz - yo)
    if csiz == 1:
        mode = "I;16" if (cs[4 + 38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _pil_palette(entries: List[Tuple[int, ...]]) -> np.ndarray:
    """PIL's ImagePalette("RGB") after `getcolor` of each entry in turn;
    the colours past the last are black."""
    colours = {}
    rows: List[Tuple[int, int, int]] = []
    for e in entries:
        if e not in colours:
            if len(rows) >= 256:
                raise ValueError("cannot allocate more than 256 colors")
            colours[e] = len(rows)
            rows.append(e)
    pal = np.zeros((256, 3), np.uint8)
    if rows:
        pal[:len(rows)] = np.asarray(rows, np.uint8)
    return pal


def read_header(data: bytes) -> Header:
    """A JP2 file (from its signature box) as PIL and OpenJPEG read it."""
    if data[:12] != SIGNATURE:
        raise SyntaxError("not a JPEG 2000 file")
    for t, s, e in _pil_boxes(data, 12, None):
        if t == b"jp2h":
            if e > len(data):
                raise OSError("JP2: the jp2h box runs past the file")
            break
    size = mode = None
    nc = 0
    palette = None
    for t, s, e in _pil_boxes(data, s, e):
        if t == b"ihdr":
            height, width, nc, bpc = _fields(data, s, e, ">IIHB")
            size = (width, height)
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            else:
                mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif t == b"colr" and nc == 4:
            meth, _, _, enumcs = _fields(data, s, e, ">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif t == b"pclr" and mode in ("L", "LA"):
            ne, npc = _fields(data, s, e, ">HB")
            depths = _fields(data, s + 3, e, ">" + "B" * npc)
            if max(depths, default=0) <= 8:
                if npc != 3:
                    raise NotImplementedError(
                        f"JP2: a pclr box of {npc} columns (PIL 12.1 builds "
                        "an RGB palette of 3-byte entries only right)")
                raw = _fields(data, s + 3 + npc, e, f">{ne * npc}B")
                palette = _pil_palette([tuple(raw[i * npc:(i + 1) * npc])
                                        for i in range(ne)])
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    # what OpenJPEG takes: the first colr box's enumerated colour space,
    # the first jp2c box's codestream
    top = _boxes(data, 12, len(data))
    jp2h = next(((s, e) for t, s, e in top if t == b"jp2h"))
    color_space = UNKNOWN
    for t, s, e in _boxes(data, *jp2h):
        if t == b"colr":
            if e - s >= 7 and data[s] == 1:
                color_space = _ENUMCS.get(struct.unpack_from(
                    ">I", data, s + 3)[0], UNKNOWN)
            break
    jp2c = next(((s, e) for t, s, e in top if t == b"jp2c"), None)
    if jp2c is None or data[jp2c[0]:jp2c[0] + 4] != CODESTREAM:
        raise OSError("broken data stream when reading image file (JP2: "
                      "no codestream box)")
    return Header(size, mode, data[jp2c[0]:jp2c[1]], color_space, palette)


def probe(data: bytes) -> None:
    """Jpeg2KImageFile._open's checks: SyntaxError (and struct.error)
    where PIL goes on to its next plugin."""
    if data[:4] == CODESTREAM:
        codestream_mode(data)
    elif data[:12] == SIGNATURE:
        read_header(data)
    else:
        raise SyntaxError("not a JPEG 2000 file")


def accepts(data: bytes) -> bool:
    return data[:4] == CODESTREAM or data[:12] == SIGNATURE
