"""TIFF decoding in numpy: the first page, as PIL 12.1's `Image.open`
holds it (its own raw reader, or libtiff for compressed data).

- little- and big-endian classic TIFF, little-endian BigTIFF (PIL does
  not read a big-endian one);
- strips and tiles, PlanarConfiguration 1 (chunky) and 2 (planar: 8-bit
  RGB, RGBA with ExtraSamples 2, and with ExtraSamples 1 when compressed:
  the layouts PIL reads right);
- compression none, PackBits, LZW (MSB-first codes, libtiff's early code
  width change) and Deflate (8 and 32946);
- horizontal differencing (Predictor 2) at 8 and 16 bits, undone for LZW
  and Deflate data only, as libtiff undoes it (PIL reads uncompressed
  data with its own raw reader, which ignores the tag, and libtiff's
  PackBits codec ignores it too);
- BitsPerSample 1, 2, 4, 8 and 16, as PIL's OPEN_INFO table maps them to
  modes: MinIsWhite and MinIsBlack grey ("1", "L" inverted for
  MinIsWhite, "I;16", which PIL does not invert), grey + alpha ("LA"),
  RGB, RGB + ExtraSamples 0 (dropped), 1 (associated alpha, which PIL's
  "RGBa" unpacker un-premultiplies into "RGBA") and 2 ("RGBA"), 16-bit
  colour (its high byte), and Palette ("P", ColorMap values / 256).

Anything else raises naming the tag and its value: JPEG, CCITT and other
compressions, the floating-point predictor, YCbCr, CMYK and other
photometric interpretations, FillOrder 2, signed or float samples, an
Orientation other than 1, and the modes PIL itself refuses.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

from .imagemode import ModeImage

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "i", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_PAIRS = {5, 10}                             # rationals: two values each

COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 5: "LZW", 6: "old-style JPEG",
                7: "JPEG", 8: "Deflate", 32773: "PackBits",
                32946: "Deflate (PKZIP)", 34712: "JPEG 2000",
                34887: "LERC", 34925: "LZMA", 50000: "ZSTD",
                50001: "WebP"}
_SUPPORTED = {1, 5, 8, 32773, 32946}
PHOTOMETRICS = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette",
                4: "Mask", 5: "CMYK (Separated)", 6: "YCbCr", 8: "CIELab",
                9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

# (photometric, BitsPerSample, ExtraSamples) -> mode, the subset of PIL's
# OPEN_INFO (FillOrder 1, SampleFormat 1) that this reads
_MODES = {
    (0, (1,), ()): "1", (1, (1,), ()): "1",
    (0, (2,), ()): "L", (1, (2,), ()): "L",
    (0, (4,), ()): "L", (1, (4,), ()): "L",
    (0, (8,), ()): "L", (1, (8,), ()): "L",
    (0, (16,), ()): "I;16", (1, (16,), ()): "I;16",
    (1, (8, 8), (2,)): "LA",
    (2, (8, 8, 8), ()): "RGB", (2, (16, 16, 16), ()): "RGB",
    (2, (8,) * 4, ()): "RGBA", (2, (16,) * 4, ()): "RGBA",
    (2, (8,) * 4, (0,)): "RGB", (2, (16,) * 4, (0,)): "RGB",
    (2, (8,) * 4, (1,)): "RGBa", (2, (16,) * 4, (1,)): "RGBa",
    (2, (8,) * 4, (2,)): "RGBA", (2, (16,) * 4, (2,)): "RGBA",
    (3, (1,), ()): "P", (3, (2,), ()): "P", (3, (4,), ()): "P",
    (3, (8,), ()): "P",
}


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
        raise NotImplementedError("TIFF: old-style (LSB-first) LZW")
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


def _decompress(raw: bytes, comp: int) -> bytes:
    if comp == 1:
        return raw
    if comp == 32773:
        return packbits_decode(raw)
    if comp == 5:
        return lzw_decode(raw)
    return zlib.decompressobj().decompress(raw)


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
            " is not supported: none, PackBits, LZW and Deflate only")
    photo = one(262, 0)
    if photo not in (0, 1, 2, 3):
        raise NotImplementedError(
            f"TIFF PhotometricInterpretation {photo} "
            f"({PHOTOMETRICS.get(photo, 'unknown')}) is not supported")
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise NotImplementedError(
            f"TIFF Predictor {predictor}"
            f"{' (floating point)' if predictor == 3 else ''} is not "
            "supported: 1 and 2 only")
    if one(266, 1) != 1:
        raise NotImplementedError(f"TIFF FillOrder {one(266)} is not "
                                  "supported: 1 only")
    if one(274, 1) != 1:
        raise NotImplementedError(f"TIFF Orientation {one(274)} is not "
                                  "supported: 1 only")
    fmt = tuple(tags.get(339, [1]))
    if set(fmt) != {1}:
        raise NotImplementedError(f"TIFF SampleFormat {fmt} is not "
                                  "supported: unsigned integers only")
    planar = one(284, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF PlanarConfiguration {planar}")
    extra = tuple(tags.get(338, []))
    bps = tuple(tags.get(258, [1]))
    spp = one(277, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"TIFF: BitsPerSample {bps} for {spp} samples")
    mode = _MODES.get((photo, bps, extra))
    if mode is None or (mode == "I;16" and photo == 0 and order == ">"):
        raise NotImplementedError(
            f"TIFF: PhotometricInterpretation {photo} with BitsPerSample "
            f"{bps} and ExtraSamples {extra} is not a supported mode")
    bits = bps[0]
    if planar == 2 and spp > 1 and (bps, extra) not in (
            ((8, 8, 8), ()), ((8,) * 4, (2,))) and not (
            (bps, extra) == ((8,) * 4, (1,)) and comp != 1):
        raise NotImplementedError(
            f"TIFF PlanarConfiguration 2 with BitsPerSample {bps} and "
            f"ExtraSamples {extra}: planar 8-bit RGB and RGBA only (PIL "
            "12.1 refuses or misreads the other planar layouts)")
    if comp not in (5, 8, 32946):
        # libtiff undoes the predictor for LZW and Deflate only, and PIL's
        # own reader of uncompressed data ignores it
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
    out = np.zeros((h, w, spp), np.int64)
    for p, x0, y0, cw, rows, k in chunks:
        raw = data[offs[k]:offs[k] + counts[k]]
        v = _samples(_decompress(raw, comp), rows, cw, cspp, bits, order,
                     predictor)
        v = v[:h - y0, :w - x0]
        if planar == 2:
            out[y0:y0 + v.shape[0], x0:x0 + v.shape[1], p] = v[..., 0]
        else:
            out[y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
    return _to_mode(out, mode, photo, bits, tags)


def _to_mode(v: np.ndarray, mode: str, photo: int, bits: int,
             tags) -> ModeImage:
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
    if mode == "RGB":
        return ModeImage("RGB", np.ascontiguousarray(v[..., :3]))
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
