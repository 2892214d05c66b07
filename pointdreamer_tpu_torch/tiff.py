"""TIFF decoding in numpy: the first page, as PIL 12.1's `Image.open`
holds it (its own raw reader, or libtiff 4.7 for compressed data).

- little- and big-endian classic TIFF, little-endian BigTIFF (PIL does
  not read a big-endian one);
- strips and tiles, PlanarConfiguration 1 (chunky) and 2 (planar: 8-bit
  RGB, RGBA with ExtraSamples 2, and with ExtraSamples 1 when compressed:
  the layouts PIL reads right);
- compression none, PackBits, LZW (MSB-first codes with libtiff's early
  code width change, and the old-style LSB-first codes), Deflate (8 and
  32946), LZMA (34925, Python's `lzma`), ZSTD (50000, `zstd.py`: the
  first frame of each strip or tile, as libtiff reads it), JPEG (7: each
  strip or tile a JPEG stream after the JPEGTables, decoded by `jpeg.py`
  with no colour conversion but YCbCr's, as libtiff asks libjpeg for it)
  and CCITT RLE, Group 3 and Group 4 (2, 3, 4: `fax.py`);
- horizontal differencing (Predictor 2) at 8 and 16 bits, undone for LZW,
  Deflate, LZMA and ZSTD data only, as libtiff undoes it (PIL reads
  uncompressed data with its own raw reader, which ignores the tag, and
  libtiff's PackBits codec ignores it too);
- the modes of PIL's OPEN_INFO table: MinIsWhite and MinIsBlack grey
  ("1", "L" inverted for MinIsWhite, "I;16", which PIL does not invert;
  signed 16 and 32-bit and unsigned 32-bit samples as "I", 32-bit floats
  as "F"), grey + alpha ("LA"), RGB with up to three extra samples
  (unspecified: dropped; associated alpha, which PIL's "RGBa" unpacker
  un-premultiplies into "RGBA"; unassociated alpha "RGBA"), 16-bit colour
  (its high byte), Palette ("P", ColorMap values / 256), CMYK ("CMYK",
  16-bit by its high byte) and YCbCr ("RGB", converted as libtiff's
  TIFFRGBAImage converts it: TIFFYCbCrToRGB's fixed-point tables with the
  YCbCrCoefficients and ReferenceBlackWhite, YCbCrSubSampling blocks;
  through libjpeg's YCbCr conversion for JPEG data);
- FillOrder 2 where OPEN_INFO has the mode: the bits of each byte of the
  stored data reversed before it is decompressed, as PIL's ";R" raw modes
  and libtiff reverse them, except JPEG data (libtiff's TIFF_NOBITREV
  codec);
- Orientation 2 to 8, as `Image.open` returns the page: transposed by
  ImageOps.exif_transpose;
- PIL's byte order slip: libtiff hands signed 16 and 32-bit and float
  samples of a compressed big-endian file over in the host's order, and
  PIL's big-endian raw modes swap them once more.

Uncompressed YCbCr strips are read as PIL's raw reader misreads them (as
RGBX).  Anything else raises naming the tag and its value: old-style
JPEG, WebP and the other compressions, the floating-point predictor, the
other photometric interpretations, and the modes PIL itself refuses.
"""
from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict, List

import numpy as np

from . import fax, zstd
from .imagemode import ModeImage
from .jpeg import jpeg_planes, ycc_to_rgb

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "i", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_PAIRS = {5, 10}                             # rationals: two values each

COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32773: "PackBits",
                32946: "Deflate (PKZIP)", 34712: "JPEG 2000",
                34887: "LERC", 34925: "LZMA", 50000: "ZSTD",
                50001: "WebP"}
_SUPPORTED = {1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000}
PHOTOMETRICS = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette",
                4: "Mask", 5: "CMYK (Separated)", 6: "YCbCr", 8: "CIELab",
                9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

# (photometric, SampleFormat, BitsPerSample, ExtraSamples) -> mode: the
# subset of PIL's OPEN_INFO that this reads (FillOrder 1; `_FILL2` lists the
# keys that also have a FillOrder 2 entry, `_LITTLE_ONLY` those PIL has for
# little-endian files only)
_U = (1,)
_MODES = {
    (0, _U, (1,), ()): "1", (1, _U, (1,), ()): "1",
    (0, _U, (2,), ()): "L", (1, _U, (2,), ()): "L",
    (0, _U, (4,), ()): "L", (1, _U, (4,), ()): "L",
    (0, _U, (8,), ()): "L", (1, _U, (8,), ()): "L", (1, (2,), (8,), ()): "L",
    (0, _U, (16,), ()): "I;16", (1, _U, (16,), ()): "I;16",
    (1, (2,), (16,), ()): "I", (1, _U, (32,), ()): "I",
    (1, (2,), (32,), ()): "I", (0, (3,), (32,), ()): "F",
    (1, (3,), (32,), ()): "F",
    (1, _U, (8, 8), (2,)): "LA",
    (2, _U, (8, 8, 8), ()): "RGB", (2, _U, (16, 16, 16), ()): "RGB",
    (2, _U, (8,) * 4, ()): "RGBA", (2, _U, (16,) * 4, ()): "RGBA",
    (2, _U, (8,) * 4, (0,)): "RGB", (2, _U, (16,) * 4, (0,)): "RGB",
    (2, _U, (8,) * 5, (0, 0)): "RGB", (2, _U, (8,) * 6, (0, 0, 0)): "RGB",
    (2, _U, (8,) * 4, (1,)): "RGBa", (2, _U, (16,) * 4, (1,)): "RGBa",
    (2, _U, (8,) * 5, (1, 0)): "RGBa", (2, _U, (8,) * 6, (1, 0, 0)): "RGBa",
    (2, _U, (8,) * 4, (2,)): "RGBA", (2, _U, (16,) * 4, (2,)): "RGBA",
    (2, _U, (8,) * 5, (2, 0)): "RGBA", (2, _U, (8,) * 6, (2, 0, 0)): "RGBA",
    (2, _U, (8,) * 4, (999,)): "RGBA",
    (3, _U, (1,), ()): "P", (3, _U, (2,), ()): "P", (3, _U, (4,), ()): "P",
    (3, _U, (8,), ()): "P", (3, _U, (8, 8), (0,)): "P",
    (5, _U, (8,) * 4, ()): "CMYK", (5, _U, (8,) * 5, (0,)): "CMYK",
    (5, _U, (8,) * 6, (0, 0)): "CMYK", (5, _U, (16,) * 4, ()): "CMYK",
    (6, _U, (8,), ()): "L", (6, _U, (8, 8, 8), ()): "RGB",
}
_FILL2 = {k for k in _MODES if k[0] in (0, 1, 3) and k[1] == _U
          and k[2] in ((1,), (2,), (4,), (8,))} | {(2, _U, (8, 8, 8), ())}
_LITTLE_ONLY = {(0, _U, (16,), ()), (1, _U, (32,), ())}
# codecs whose data libtiff does not bit-reverse for FillOrder 2
_NOBITREV = {7}
# ImageOps.exif_transpose: Orientation -> (transpose, then flips)
_ORIENT = {2: (False, False, True), 3: (False, True, True),
           4: (False, True, False), 5: (True, False, False),
           6: (True, False, True), 7: (True, True, True),
           8: (True, True, False)}
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _ifd(data: bytes):
    """The first IFD as {tag: [values]}, and the byte order."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None:
        raise ValueError("not a TIFF (no II / MM byte order)")
    magic, = struct.unpack_from(order + "H", data, 2)
    if magic == 42:
        big = False
        off, = struct.unpack_from(order + "I", data, 4)
    elif magic == 43:
        if order == ">":
            raise NotImplementedError(
                "TIFF: a big-endian BigTIFF, which PIL 12.1 does not read "
                "(it looks for 43 in the little-endian byte)")
        big = True
        size, zero, off = struct.unpack_from(order + "HHQ", data, 4)
        if size != 8 or zero:
            raise ValueError("TIFF: a bad BigTIFF header")
    else:
        raise ValueError(f"not a TIFF (version {magic})")
    n, = struct.unpack_from(order + ("Q" if big else "H"), data, off)
    pos = off + (8 if big else 2)
    field = 8 if big else 4
    tags: Dict[int, List] = {}
    for _ in range(n):
        if big:
            tag, typ, count = struct.unpack_from(order + "HHQ", data, pos)
        else:
            tag, typ, count = struct.unpack_from(order + "HHI", data, pos)
        vpos = pos + (12 if big else 8)
        pos += 20 if big else 12
        if typ not in _TYPES:
            continue                      # unknown types are skipped
        fmt = _TYPES[typ]
        k = count * (2 if typ in _PAIRS else 1)
        nbytes = k * struct.calcsize(fmt)
        if nbytes > field:
            vpos, = struct.unpack_from(order + ("Q" if big else "I"), data,
                                       vpos)
        if vpos + nbytes > len(data):
            raise ValueError(f"TIFF: tag {tag} runs past the end of the file")
        tags[tag] = list(struct.unpack_from(f"{order}{k}{fmt}", data, vpos))
    return tags, order


def packbits_decode(raw: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        c = raw[i]
        i += 1
        if c < 128:
            out += raw[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += raw[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def lzw_decode(raw: bytes) -> bytes:
    """TIFF LZW (MSB-first codes from 9 to 12 bits, clear 256, end 257; the
    code width grows one code early, as libtiff's decoder reads it)."""
    if raw[:1] == b"\x00" and len(raw) > 1 and raw[1] & 1:
        return _lzw_decode_compat(raw)
    base = [bytes((i,)) for i in range(256)] + [b"", b""]
    table = list(base)
    size = 9
    out = bytearray()
    prev = None
    acc = nacc = i = 0
    n = len(raw)
    while True:
        while nacc < size:
            if i >= n:
                return bytes(out)
            acc = (acc << 8) | raw[i]
            nacc += 8
            i += 1
        code = (acc >> (nacc - size)) & ((1 << size) - 1)
        nacc -= size
        acc &= (1 << nacc) - 1
        if code == 256:
            table = list(base)
            size = 9
            prev = None
            continue
        if code == 257:
            return bytes(out)
        if prev is None:
            if code > 256:
                raise ValueError(f"TIFF: LZW code {code} after a clear")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"TIFF: LZW code {code} past the table")
            if len(table) > 4096:
                raise ValueError("TIFF: LZW table overflow")
            if len(table) == (1 << size) - 1 and size < 12:
                size += 1
        out += entry
        prev = entry


def _lzw_decode_compat(raw: bytes) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat): LSB-first codes, the
    code width growing only when the next code needs it."""
    base = [bytes((i,)) for i in range(256)] + [b"", b""]
    table = list(base)
    size = 9
    out = bytearray()
    prev = None
    acc = nacc = i = 0
    n = len(raw)
    while True:
        while nacc < size:
            if i >= n:
                return bytes(out)
            acc |= raw[i] << nacc
            nacc += 8
            i += 1
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == 256:
            table = list(base)
            size = 9
            prev = None
            continue
        if code == 257:
            return bytes(out)
        if prev is None:
            if code > 256:
                raise ValueError(f"TIFF: LZW code {code} after a clear")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"TIFF: LZW code {code} past the table")
            if len(table) > 4096:
                raise ValueError("TIFF: LZW table overflow")
            if len(table) == 1 << size and size < 12:
                size += 1
        out += entry
        prev = entry


def _decompress(raw: bytes, comp: int) -> bytes:
    if comp == 1:
        return raw
    if comp == 32773:
        return packbits_decode(raw)
    if comp == 5:
        return lzw_decode(raw)
    if comp == 34925:
        return lzma.LZMADecompressor().decompress(raw)
    if comp == 50000:
        return zstd.decompress(raw)
    return zlib.decompressobj().decompress(raw)


def _ycbcr_tables(luma, refbw):
    """libtiff's TIFFYCbCrToRGBInit: float32 arithmetic as C does it,
    16-bit fixed-point tables."""
    f = np.float32
    lr, lg, lb = (f(x) for x in luma)
    rb = [f(x) for x in refbw]

    def fix(x):
        return int(float(f(min(max(x, f(0)), f(2)) * f(65536))) + 0.5)

    def code2v(c, black, white, cr):
        span = f(white - black)
        return f(f(f(c - int(black)) * f(cr)) / (span if span else f(1)))

    def clampw(v):
        return int(min(max(float(v), -4096.0), 4096.0))

    f1 = f(f(2) - f(f(2) * lr))
    f3 = f(f(2) - f(f(2) * lb))
    d1, d3 = fix(f1), fix(f3)
    d2 = -fix(f(f(lr * f1) / lg))
    d4 = -fix(f(f(lb * f3) / lg))
    cr = np.array([clampw(code2v(x, f(rb[4] - f(128)), f(rb[5] - f(128)),
                                 127)) for x in range(-128, 128)], np.int64)
    cb = np.array([clampw(code2v(x, f(rb[2] - f(128)), f(rb[3] - f(128)),
                                 127)) for x in range(-128, 128)], np.int64)
    y = np.array([clampw(code2v(x, rb[0], rb[1], 255)) for x in range(256)],
                 np.int64)
    half = 1 << 15
    return (y, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half)


def ycbcr_to_rgb(y, cb, cr, luma=(0.299, 0.587, 0.114),
                 refbw=(0, 255, 128, 255, 128, 255)) -> np.ndarray:
    """8-bit Y, Cb, Cr -> uint8 RGB [..., 3], as libtiff's TIFFYCbCrtoRGB
    converts them."""
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(luma, refbw)
    yv = y_tab[y]
    rgb = [yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)


def _ycbcr_chunk(buf: bytes, rows: int, width: int, sub, tags) -> np.ndarray:
    """One chunk of YCbCr data units (YCbCrSubSampling h x v: h v Y samples,
    then Cb and Cr) -> RGB [rows, width, 3], each pixel with its unit's Cb
    and Cr, as TIFFRGBAImage's putcontig8bitYCbCr tiles convert them."""
    h, v = sub
    bw, bh = -(-width // h), -(-rows // v)
    unit = h * v + 2
    if len(buf) < bw * bh * unit:
        raise ValueError(f"TIFF: a YCbCr strip or tile holds {len(buf)} "
                         f"bytes, {bw * bh * unit} needed")
    a = np.frombuffer(buf, np.uint8, bw * bh * unit).reshape(bh, bw, unit)
    y = a[..., :h * v].reshape(bh, bw, v, h).transpose(0, 2, 1, 3).reshape(
        bh * v, bw * h)
    cb = np.repeat(np.repeat(a[..., h * v], v, 0), h, 1)
    cr = np.repeat(np.repeat(a[..., h * v + 1], v, 0), h, 1)
    luma = tags.get(529, [0.299, 0.587, 0.114])
    refbw = tags.get(532, [0, 255, 128, 255, 128, 255])
    rgb = ycbcr_to_rgb(y.astype(np.int64), cb.astype(np.int64),
                       cr.astype(np.int64), luma, refbw)
    return rgb[:rows, :width].astype(np.int64)


def _jpeg_chunk(raw: bytes, rows: int, width: int, photo: int,
                tables) -> np.ndarray:
    """One JPEG-compressed strip or tile -> samples [rows, width, spp]: the
    stream after the JPEGTables' segments, decoded with no colour
    conversion but YCbCr -> RGB (libtiff's JPEGCOLORMODE_RGB, which PIL
    asks for)."""
    if tables and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:]
    j, planes = jpeg_planes(raw)
    if j["frame"]["lossless"]:
        raise NotImplementedError("TIFF: a lossless JPEG strip or tile")
    if photo == 6 and len(planes) == 3:
        px = ycc_to_rgb(*planes)
    else:
        px = np.stack(planes, -1)
    if px.shape[0] < rows or px.shape[1] < width:
        raise ValueError(f"TIFF: a JPEG strip or tile of {px.shape[:2]} "
                         f"for {(rows, width)}")
    return px[:rows, :width].astype(np.int64)


def _samples(buf: bytes, rows: int, width: int, spp: int, bits: int,
             order: str, predictor: int) -> np.ndarray:
    """One chunk's decompressed bytes -> samples [rows, width, spp]
    (int64), rows padded to whole bytes below 8 bits."""
    rowbytes = (width * spp * bits + 7) // 8
    need = rows * rowbytes
    if len(buf) < need:
        raise ValueError(f"TIFF: a strip or tile holds {len(buf)} bytes, "
                         f"{need} needed")
    a = np.frombuffer(buf, np.uint8, need).reshape(rows, rowbytes)
    if bits == 32:
        return a.view(order + "u4").reshape(rows, width, spp).astype(
            np.int64)
    if bits == 16:
        v = a.view(order + "u2").reshape(rows, width, spp)
        if predictor == 2:
            v = np.cumsum(v, axis=1, dtype=np.uint16)
        return v.astype(np.int64)
    if bits == 8:
        v = a.reshape(rows, width, spp)
        if predictor == 2:
            v = np.cumsum(v, axis=1, dtype=np.uint8)
        return v.astype(np.int64)
    bitsarr = np.unpackbits(a, axis=1)[:, :width * spp * bits]
    weights = 1 << np.arange(bits - 1, -1, -1)
    v = (bitsarr.reshape(rows, width * spp, bits) * weights).sum(-1)
    return v.reshape(rows, width, spp).astype(np.int64)


def _mode_key(tags, order):
    """PIL's OPEN_INFO key and the mode it names, or a raise naming what
    PIL does not read."""
    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    photo = one(262, 0)
    if photo not in (0, 1, 2, 3, 5, 6):
        raise NotImplementedError(
            f"TIFF PhotometricInterpretation {photo} "
            f"({PHOTOMETRICS.get(photo, 'unknown')}) is not supported")
    fmt = tuple(tags.get(339, [1]))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    extra = tuple(tags.get(338, []))
    bps = tuple(tags.get(258, [1]))
    spp = one(277, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"TIFF: BitsPerSample {bps} for {spp} samples")
    key = (photo, fmt, bps, extra)
    fill = one(266, 1)
    mode = _MODES.get(key)
    if mode is None or (key in _LITTLE_ONLY and order == ">") or (
            fill == 2 and key not in _FILL2) or fill not in (1, 2):
        raise NotImplementedError(
            f"TIFF: PhotometricInterpretation {photo} with SampleFormat "
            f"{fmt}, BitsPerSample {bps}, ExtraSamples {extra} and "
            f"FillOrder {fill} is not a mode PIL reads")
    return key, mode, fill


def decode_tiff(data: bytes) -> ModeImage:
    """TIFF bytes -> the first page (see the module docstring)."""
    tags, order = _ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    if 256 not in tags or 257 not in tags:
        raise ValueError("TIFF: no ImageWidth / ImageLength")
    w, h = one(256), one(257)
    comp = one(259, 1)
    if comp not in _SUPPORTED:
        raise NotImplementedError(
            f"TIFF Compression {comp} ({COMPRESSIONS.get(comp, 'unknown')})"
            " is not supported: none, CCITT RLE, Group 3 and 4, LZW, JPEG, "
            "Deflate, PackBits, LZMA and ZSTD only")
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise NotImplementedError(
            f"TIFF Predictor {predictor}"
            f"{' (floating point)' if predictor == 3 else ''} is not "
            "supported: 1 and 2 only")
    (photo, fmt, bps, extra), mode, fill = _mode_key(tags, order)
    planar = one(284, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF PlanarConfiguration {planar}")
    spp = len(bps)
    bits = bps[0]
    orient = one(274, 1)
    if comp in (2, 3, 4) and bps != (1,):
        raise NotImplementedError(
            f"TIFF Compression {comp} ({COMPRESSIONS[comp]}) with "
            f"BitsPerSample {bps}: 1-bit pages only, as libtiff")
    # PIL's raw reader takes uncompressed YCbCr strips as RGBX: 4 bytes a
    # pixel from each strip's offset on, Y, Cb and Cr of the next pixel
    # included
    rgbx = photo == 6 and spp == 3 and comp == 1
    if rgbx and (324 in tags or planar != 1):
        raise NotImplementedError(
            "TIFF PhotometricInterpretation 6 (YCbCr) uncompressed in tiles "
            "or planes, which PIL 12.1 misreads")
    ycbcr = photo == 6 and spp == 3 and comp != 7 and not rgbx
    sub = tuple(tags.get(530, [2, 2]))[:2] if ycbcr else (1, 1)
    if ycbcr and (planar != 1 or orient not in (1, None)):
        raise NotImplementedError(
            "TIFF: YCbCr through libtiff's RGBA reader with "
            f"PlanarConfiguration {planar} or Orientation {orient}")
    if planar == 2 and spp > 1 and (bps, extra) not in (
            ((8, 8, 8), ()), ((8,) * 4, (2,))) and not (
            (bps, extra) == ((8,) * 4, (1,)) and comp != 1):
        raise NotImplementedError(
            f"TIFF PlanarConfiguration 2 with BitsPerSample {bps} and "
            f"ExtraSamples {extra}: planar 8-bit RGB and RGBA only (PIL "
            "12.1 refuses or misreads the other planar layouts)")
    if comp not in (5, 8, 32946, 34925, 50000):
        # libtiff undoes the predictor for LZW, Deflate, LZMA and ZSTD only,
        # and PIL's own reader of uncompressed data ignores it
        predictor = 1
    if predictor == 2 and bits not in (8, 16):
        raise NotImplementedError(f"TIFF Predictor 2 at {bits} bits")

    # the chunks: (plane, x0, y0, width, rows, offset, byte count)
    planes = spp if planar == 2 else 1
    cspp = 1 if planar == 2 else spp
    chunks = []
    if 324 in tags:
        tw, th = one(322), one(323)
        offs, counts = tags[324], tags.get(325)
        across, down = -(-w // tw), -(-h // th)
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    k = (p * down + ty) * across + tx
                    chunks.append((p, tx * tw, ty * th, tw, th, k))
    elif 273 in tags:
        rps = min(one(278, h), h) or h
        offs, counts = tags[273], tags.get(279)
        per = -(-h // rps)
        for p in range(planes):
            for s in range(per):
                rows = min(rps, h - s * rps)
                chunks.append((p, 0, s * rps, w, rows, p * per + s))
    else:
        raise ValueError("TIFF: no strips or tiles")
    if counts is None or len(offs) < len(chunks) or len(counts) < len(
            chunks):
        raise ValueError("TIFF: fewer strip or tile offsets than the image "
                         "needs")
    tables = bytes(tags.get(347, b""))
    out = np.zeros((h, w, 3 if ycbcr else spp), np.int64)
    for p, x0, y0, cw, rows, k in chunks:
        raw = data[offs[k]:offs[k] + counts[k]]
        if fill == 2 and comp not in _NOBITREV:
            raw = raw.translate(_REVERSED)
        try:
            if rgbx:
                raw = data[offs[k]:offs[k] + rows * cw * 4]
                if len(raw) < rows * cw * 4:
                    raise ValueError("image data is truncated")
                v = np.frombuffer(raw, np.uint8).reshape(
                    rows, cw, 4)[..., :3].astype(np.int64)
            elif comp == 7:
                v = _jpeg_chunk(raw, rows, cw, photo, tables)
            elif comp in (2, 3, 4):
                v = fax.decode(raw, cw, rows, comp, one(292, 0))[..., None]
            elif ycbcr:
                v = _ycbcr_chunk(_decompress(raw, comp), rows, cw, sub, tags)
            else:
                v = _samples(_decompress(raw, comp), rows, cw, cspp, bits,
                             order, predictor)
        except (ValueError, IndexError, lzma.LZMAError, zlib.error) as e:
            raise ValueError(f"TIFF Compression {comp} ("
                             f"{COMPRESSIONS.get(comp)}): a strip or tile "
                             f"fails to decode: {e}") from None
        v = v[:h - y0, :w - x0]
        if planar == 2:
            out[y0:y0 + v.shape[0], x0:x0 + v.shape[1], p] = v[..., 0]
        else:
            out[y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
    # libtiff hands a compressed big-endian file's samples over in the host
    # order, which PIL's big-endian signed and float raw modes swap again
    swap = order == ">" and comp != 1 and mode in ("I", "F")
    img = _to_mode(out, mode, photo, bits, tags, swap)
    return _orient(img, orient)


def _orient(img: ModeImage, orient) -> ModeImage:
    if orient not in _ORIENT:
        return img
    transpose, flip_v, flip_h = _ORIENT[orient]
    p = img.pixels
    if transpose:
        p = p.swapaxes(0, 1)
    if flip_v:
        p = p[::-1]
    if flip_h:
        p = p[:, ::-1]
    return img._replace(pixels=np.ascontiguousarray(p))


def _to_mode(v: np.ndarray, mode: str, photo: int, bits: int,
             tags, swap: bool = False) -> ModeImage:
    if mode == "F":
        u = v[..., 0].astype(np.uint32)
        if swap:
            u = u.byteswap()
        return ModeImage("F", u.view(np.float32))
    if mode == "I":
        u = v[..., 0].astype(np.uint16 if bits == 16 else np.uint32)
        if swap:
            u = u.byteswap()
        signed = u.view(np.int16 if bits == 16 else np.int32)
        return ModeImage("I", signed.astype(np.int32))
    if mode == "P":
        cmap = np.asarray(tags.get(320, []), np.int64)
        n = 1 << bits
        if len(cmap) < 3 * n:
            raise ValueError("TIFF: a palette image without its ColorMap")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = (cmap[:3 * n].reshape(3, n).T // 256).astype(np.uint8)
        return ModeImage("P", v[..., 0].astype(np.uint8), pal)
    if mode == "I;16":
        return ModeImage("I;16", v[..., 0].astype(np.uint16))
    if bits == 16:
        v = v >> 8
    elif bits < 8:
        v = v * (255 // ((1 << bits) - 1))
    if photo == 0:
        v = 255 - v
    v = v.astype(np.uint8)
    if mode in ("1", "L"):
        return ModeImage(mode, np.ascontiguousarray(v[..., 0]))
    v = v[..., :{"LA": 2, "RGB": 3}.get(mode, 4)]    # extra samples dropped
    if mode == "RGBa":
        # PIL's "RGBa" unpacker: un-premultiplied, and a transparent pixel
        # all zero
        x = v.astype(np.int64)
        a = x[..., 3:]
        rgb = np.where(a == 255, x[..., :3],
                       np.minimum(255 * x[..., :3] // np.maximum(a, 1), 255))
        rgb = np.where(a == 0, 0, rgb)
        return ModeImage("RGBA", np.concatenate([rgb, a], -1).astype(
            np.uint8))
    return ModeImage(mode, np.ascontiguousarray(v))
