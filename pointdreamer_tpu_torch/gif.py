"""GIF decoding in numpy: the first frame, as PIL 12.1's `Image.open`
holds it.

- GIF87a and GIF89a; the logical screen, global and local colour tables;
- LZW with variable code sizes up to 12 bits, clear and end codes, a full
  table kept until the next clear (GifDecode.c);
- interlaced frames (rows 0::8, 4::8, 2::4, 1::2);
- the graphic control extension's transparent index;
- a first frame smaller than the logical screen, or placed off its origin:
  the image is the screen (grown to hold the frame), the rest filled with
  the transparent index, else with 0;
- image data that ends before the frame is full raises, as PIL does.

The mode is "P" with the frame's colour table (local, else global), or
"L" when that table is the identity grey ramp (entry i = (i, i, i)) or
absent, as GifImagePlugin decides.  Later frames are not read.
"""
from __future__ import annotations

import numpy as np

from .imagemode import ModeImage


def _sub_blocks(data: bytes, pos: int):
    """The concatenated data sub-blocks starting at `pos`, and the offset
    past their terminator."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError("GIF: data runs past the end of the file")
        n = data[pos]
        pos += 1
        if not n:
            return b"".join(out), pos
        out.append(data[pos:pos + n])
        pos += n


def lzw_decode(data: bytes, min_bits: int, count: int) -> bytes:
    """GIF LZW codes (LSB first) -> at most `count` indices."""
    if not 1 <= min_bits <= 11:
        raise ValueError(f"GIF: LZW minimum code size {min_bits}")
    clear = 1 << min_bits
    end = clear + 1
    base = [bytes((i,)) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = min_bits + 1
    out = bytearray()
    prev = None
    acc = nacc = i = 0
    n = len(data)
    while len(out) < count:
        while nacc < size:
            if i >= n:
                return bytes(out)
            acc |= data[i] << nacc
            nacc += 8
            i += 1
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            table = list(base)
            size = min_bits + 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                raise ValueError(f"GIF: LZW code {code} after a clear")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                add = prev + entry[:1]
            elif code == len(table) and len(table) < 4096:
                entry = add = prev + prev[:1]
            else:
                raise ValueError(f"GIF: LZW code {code} past the table")
            if len(table) < 4096:
                table.append(add)
                if len(table) == 1 << size and size < 12:
                    size += 1
        out += entry
        prev = entry
    return bytes(out[:count])


def _palette(raw: bytes):
    """A colour table as [256, 3] uint8, or None for the identity grey
    ramp (which GifImagePlugin reads as mode "L")."""
    p = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (p == np.arange(len(p))[:, None]).all():
        return None
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(p)] = p[:256]
    return pal


def decode_gif(data: bytes) -> ModeImage:
    """GIF bytes -> the first frame (see the module docstring)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF (no GIF87a / GIF89a signature)")
    sw = data[6] | data[7] << 8
    sh = data[8] | data[9] << 8
    flags = data[10]
    pos = 13
    global_pal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos:pos + n])
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF: no image in the file")
        kind = data[pos]
        pos += 1
        if kind == 0x21:                                   # extension
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparency = body[3]
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF: unknown block 0x{kind:02x}")
        x0, y0, w, h = np.frombuffer(data, "<u2", 4, pos).tolist()
        iflags = data[pos + 8]
        pos += 9
        pal = global_pal
        if iflags & 0x80:
            n = 3 << ((iflags & 7) + 1)
            pal = _palette(data[pos:pos + n])
            pos += n
        min_bits = data[pos]
        codes, pos = _sub_blocks(data, pos + 1)
        break
    W, H = max(sw, x0 + w), max(sh, y0 + h)
    fill = transparency if transparency is not None else 0
    img = np.full((H, W), fill, np.uint8)
    px = lzw_decode(codes, min_bits, w * h)
    if len(px) < w * h:
        raise ValueError(f"GIF: the image data holds {len(px)} of the "
                         f"frame's {w * h} pixels (PIL: truncated)")
    if w and h:
        order = np.arange(h)
        if iflags & 0x40:
            order = np.concatenate([order[0::8], order[4::8], order[2::4],
                                    order[1::2]])
        img[y0 + order, x0:x0 + w] = np.frombuffer(px, np.uint8).reshape(
            h, w)
    if pal is None:
        return ModeImage("L", img, None, transparency)
    return ModeImage("P", img, pal, transparency)
