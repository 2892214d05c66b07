"""The formats PIL 12.1 identifies and the port refuses, each told apart
as PIL's plugin tells it, so that no later plugin misreads the file.

- EPS: PIL parses the DSC header (a "%!PS" start or the binary EPS
  preview header, a "%!PS-Adobe" comment and a bounding box) and renders
  the page through Ghostscript, which the port does not run: OSError, as
  PIL raises it where Ghostscript is missing;
- MPEG: a sequence header with its size; PIL opens it and cannot load it
  (OSError);
- WMF / EMF, BUFR, GRIB and HDF5: PIL's stub plugins, which open and then
  find no loader (OSError "cannot find loader", as PIL says it).
"""
from __future__ import annotations

import re
import struct

from .imagemode import NotThisFormat

# ---------------------------------------------------------------------------
# accept tests, as each plugin's _accept (on the first 16 bytes) and _open


_SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
_FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")


def eps_accepts(data: bytes) -> bool:
    return data[:4] == b"%!PS" or (
        len(data) >= 4 and struct.unpack_from("<I", data)[0] == 0xC6D3D0C5)


def eps_probe(data: bytes) -> None:
    """EpsImageFile._open's header comments: "%!PS-Adobe" and a bounding
    box before the comments end (else PIL goes on to its next plugin);
    a box that cannot be read is an OSError."""
    if data[:4] == b"%!PS":
        offset = 0
    elif eps_accepts(data):
        if len(data) < 12:
            raise NotThisFormat("EPS: truncated preview header")
        offset, = struct.unpack_from("<I", data, 4)
    else:
        raise NotThisFormat("not an EPS file")
    keys, box = set(), None
    for raw in re.split(rb"[\r\n]+", data[offset:]):
        if not raw:
            continue
        if len(raw) > 255 and raw[:1] == b"%":
            raise NotThisFormat("not an EPS file")
        if raw[:1] != b"%" or raw[:13] == b"%%EndComments":
            break
        s = raw.decode("latin-1")
        m = _SPLIT.match(s)
        if m:
            keys.add(m.group(1))
            if m.group(1) == "BoundingBox" and box is None:
                try:
                    box = [int(float(v)) for v in m.group(2).split()]
                except ValueError:
                    pass
        else:
            f = _FIELD.match(s)
            if f and f.group(1).startswith("PS-Adobe"):
                keys.add("PS-Adobe")
    if "PS-Adobe" not in keys or "BoundingBox" not in keys:
        raise NotThisFormat("EPS header missing a required comment")
    if not box:
        raise OSError("cannot determine EPS bounding box")


def mpeg_probe(data: bytes) -> None:
    if data[:4] != b"\x00\x00\x01\xb3" or len(data) < 7:
        raise NotThisFormat("not an MPEG file")
    w = (data[4] << 4) | (data[5] >> 4)
    h = ((data[5] & 15) << 8) | data[6]
    if w <= 0 or h <= 0:
        raise NotThisFormat("MPEG: empty image")


def wmf_probe(data: bytes) -> None:
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(s) < 16:
            raise NotThisFormat("WMF: truncated header")
        inch, = struct.unpack_from("<H", s, 14)
        if inch == 0:
            raise ValueError("WMF: invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
        if s[22:26] != b"\x01\x00\t\x00":
            raise NotThisFormat("unsupported WMF file format")
    elif s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        if f2 == f0 or f3 == f1:               # PIL divides by the frame
            raise ZeroDivisionError("EMF: an empty frame")
        size = (x1 - x0, y1 - y0)
    else:
        raise NotThisFormat("not a WMF / EMF file")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("WMF: empty image")


def bufr_accepts(data: bytes) -> bool:
    return data[:4] in (b"BUFR", b"ZCZC")


def grib_accepts(data: bytes) -> bool:
    return len(data) >= 8 and data[:4] == b"GRIB" and data[7] == 1


def hdf5_accepts(data: bytes) -> bool:
    return data[:8] == b"\x89HDF\r\n\x1a\n"


# ---------------------------------------------------------------------------
# what loading each gives


def eps_refused(data: bytes):
    eps_probe(data)
    raise OSError("EPS: PIL 12.1 renders EPS through Ghostscript; the port "
                  "runs no Ghostscript (as PIL fails where it is missing)")


def mpeg_refused(data: bytes):
    mpeg_probe(data)
    raise OSError("MPEG: cannot load this image (PIL 12.1 identifies an "
                  "MPEG stream and cannot read it)")


def stub_refused(kind: str):
    """A PIL stub plugin: the file opens, and loading it raises."""
    def decode(data: bytes):
        if kind == "WMF":
            wmf_probe(data)
        raise OSError(f"cannot find loader for this {kind} file (PIL "
                      f"12.1's {kind} plugin is a stub)")
    return decode
