"""X11 pixmap (XPM) decoding, as PIL 12.1's XpmImagePlugin reads it.

After "/* XPM */", the first line matching `"w h ncolors cpp` gives the
size; the next ncolors lines give each key's colour ("c #rrggbb"; "c
None" gives the key no colour; any other colour raises).  Up to 256
colours the image is "P" (palette in the order listed; a "None" key's
bytes become the alpha of the first indices, as PIL's convert reads
transparency given as bytes), above 256 "RGB" (where PIL cannot convert
a "None" key to RGBA, and the port refuses it).  The pixels are the text
between the first and last quote of each following line (a "/* pixels
*/" line skipped once), `cpp` characters a pixel; a key with no colour
raises, as in PIL.
"""
from __future__ import annotations

import re

import numpy as np

from .imagemode import ModeImage, NotThisFormat

_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accepts(data: bytes) -> bool:
    return data[:9] == b"/* XPM */"


def _lines(data: bytes, pos: int):
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def probe(data: bytes):
    """XpmImageFile._open: (width, height, cpp, palette {key: rgb}, data
    position)."""
    if not accepts(data):
        raise NotThisFormat("not an XPM file")
    pos = 9
    for line, pos in _lines(data, 9):
        m = _HEAD.match(line)
        if m:
            break
    else:
        raise NotThisFormat("broken XPM file")
    try:
        w, h, ncolors, cpp = (int(g) for g in m.groups())
    except ValueError as e:                  # an empty number: int(b"")
        raise ValueError("XPM: bad header") from e
    palette = {}
    clear = None
    lines = _lines(data, pos)
    for _ in range(ncolors):
        line, pos = next(lines, (b"", pos))
        line = line.rstrip()
        key = line[1:cpp + 1]
        words = line[cpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                rgb = words[i + 1]
                if rgb == b"None":
                    clear = key
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("XPM: cannot read this XPM file (an "
                                     "unknown colour)")
                break
        else:
            raise ValueError("XPM: cannot read this XPM file (a missing "
                             "colour key)")
    if w <= 0 or h <= 0:
        raise NotThisFormat("XPM: empty image")
    return w, h, ncolors, cpp, palette, clear, pos


def decode_xpm(data: bytes) -> ModeImage:
    """XPM bytes -> "P" (up to 256 colours) or "RGB" pixels."""
    w, h, ncolors, cpp, palette, clear, pos = probe(data)
    keys = list(palette)
    index = {k: i for i, k in enumerate(keys)}
    out = []
    header = False
    for line, _ in _lines(data, pos):
        if len(out) >= w * h:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(body), cpp):
            key = body[i:i + cpp]
            if key not in index:
                raise ValueError(f"XPM: pixel key {key!r} has no colour")
            out.append(index[key])
    if len(out) < w * h:
        raise ValueError("XPM: not enough image data")
    idx = np.array(out[:w * h], np.int64).reshape(h, w)
    pal = np.zeros((max(len(keys), 1), 3), np.uint8)
    pal[:len(keys)] = [palette[k] for k in keys]
    if ncolors > 256:
        if clear is not None:
            raise NotImplementedError("XPM: a transparent key in an image "
                                      "of more than 256 colours, which PIL "
                                      "12.1 cannot convert to RGBA")
        return ModeImage("RGB", pal[idx])
    full = np.zeros((256, 3 if clear is None else 4), np.uint8)
    full[:min(256, len(keys)), :3] = pal[:256]
    if clear is not None:
        full[:, 3] = 255
        full[:len(clear), 3] = np.frombuffer(clear, np.uint8)[:256]
    return ModeImage("P", idx.astype(np.uint8), full)
