"""PyTorch port, the image inputs PIL 12.1 reads that the port refused or
misread: PNM at any maxval, PFM and PIL's own PNM variants (io.py), TIFF
CMYK, YCbCr (subsampled, and under JPEG), JPEG, LZMA and CCITT
compression, old-style LZW, FillOrder 2, Orientation, signed, 32-bit and
float samples (tiff.py, fax.py), and TGA, PCX, SGI, QOI, ICO, CUR, DIB,
MSP and XBM (tga.py, pcx.py, sgi.py, qoi.py, ico.py, msp.py, xbm.py).

PIL is the oracle: each file decodes bit-equal to PIL's convert("RGB")
and convert("RGBA"), and `io.image_type` names PIL's `format` (its
plugin, picked by content in PIL's order).  PIL writes most fixtures; the
variants it cannot write come from the small writers here.  The committed
fixtures under tests/data/{pnm,tiff_more,tga,pcx,sgi,qoi,ico,bilevel,
restore16}/ (with PIL's convert("RGBA") beside each as `<stem>_pil.png`)
are what `make_fixtures` writes; `chip_smoke.py` decodes them on the
machine without PIL.  The slice as a whole: the restore dataset's batches
over tests/data/restore16 (files only the new readers decode, under the
dataset's extensions) bit-equal to the JAX package's."""
import io
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import imagemode as tmode
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import tiff as ttiff

from test_torch_image_formats import _image, poster, tiff_file, tiff_lzw

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_REV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _rng(seed):
    return np.random.default_rng(seed)


def _pil_bytes(img, fmt, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def pil_format(data: bytes) -> str:
    return Image.open(io.BytesIO(data)).format


def assert_reads_as_pil(data: bytes, name: str = "image"):
    """The port's mode image converts to PIL's convert("RGB") and
    convert("RGBA") bit for bit, and image_type names PIL's plugin."""
    im = Image.open(io.BytesIO(data))
    im.load()
    kind = tio.image_type(data)
    assert ("PPM" if kind == "PNM" else kind) == im.format, name
    got = tio.decode_image(data, name)
    rgb, rgba = np.asarray(im.convert("RGB")), np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(tmode.to_rgb(got), rgb, err_msg=name)
    np.testing.assert_array_equal(tmode.to_rgba(got), rgba, err_msg=name)
    # the restore reads convert("RGB"), chip_smoke holds it to the
    # committed RGBA decode's first three channels
    np.testing.assert_array_equal(rgb, rgba[..., :3])
    if im.mode in ("I", "F"):
        assert got.mode == im.mode
        np.testing.assert_array_equal(got.pixels, np.asarray(im))
    return got, im


# ---------------------------------------------------------------------------
# writers for what PIL does not write

def old_lzw(raw: bytes) -> bytes:
    """Old-style TIFF LZW: LSB-first codes, the width growing when the
    next code needs it."""
    out = bytearray()
    acc = nacc = 0

    def put(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def fresh():
        return {bytes((i,)): i for i in range(256)}, 258, 9

    table, nxt, size = fresh()
    put(256, size)
    cur = b""
    for b in raw:
        s = cur + bytes((b,))
        if s in table:
            cur = s
            continue
        put(table[cur], size)
        table[s] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, size)
            table, nxt, size = fresh()
        elif nxt > 1 << size:
            size += 1
        cur = bytes((b,))
    if cur:
        put(table[cur], size)
        nxt += 1
        if nxt > 1 << size and size < 12:
            size += 1
    put(257, size)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def ycbcr_units(ycc: np.ndarray, h: int, v: int) -> bytes:
    """YCbCr samples [rows, width, 3] -> TIFF's subsampled data units (h v
    Y samples, then the unit's mean Cb and Cr), edges repeated."""
    rows, width = ycc.shape[:2]
    bh, bw = -(-rows // v), -(-width // h)
    pad = np.pad(ycc, ((0, bh * v - rows), (0, bw * h - width), (0, 0)),
                 mode="edge").astype(np.int64)
    out = []
    for by in range(bh):
        for bx in range(bw):
            blk = pad[by * v:(by + 1) * v, bx * h:(bx + 1) * h]
            out += list(blk[..., 0].ravel()) + [int(blk[..., 1].mean()),
                                                int(blk[..., 2].mean())]
    return bytes(np.array(out, np.uint8))


def tga_file(px: np.ndarray, kind: int, depth: int, cmap=None, start=0,
             mapdepth=24, flags=0x20, rle=False, ident=b"") -> bytes:
    """A TGA of raw pixel bytes px [H, W, bytes a pixel] (as stored: BGR,
    rows top-down when flags has 0x20), RLE packets running across rows."""
    h, w = px.shape[:2]
    head = struct.pack("<BBBHHBHHHHBB", len(ident), int(cmap is not None),
                       kind, start, 0 if cmap is None else len(cmap),
                       mapdepth if cmap is not None else 0, 0, 0, w, h,
                       depth, flags)
    body = px.tobytes()
    if rle:
        bpp = px.shape[2]
        pixels = [body[i:i + bpp] for i in range(0, len(body), bpp)]
        out, i = bytearray(), 0
        while i < len(pixels):
            j = i
            while j + 1 < len(pixels) and pixels[j + 1] == pixels[i] \
                    and j - i < 127:
                j += 1
            if j > i:
                out += bytes((0x80 | (j - i),)) + pixels[i]
                i = j + 1
                continue
            j = i + 1
            while j < len(pixels) and j - i < 128 and pixels[j] != \
                    pixels[j - 1]:
                j += 1
            out += bytes((j - i - 1,)) + b"".join(pixels[i:j])
            i = j
        body = bytes(out)
    cmap_bytes = b"" if cmap is None else np.asarray(cmap).tobytes()
    return head + ident + cmap_bytes + body


def pcx_planes(idx: np.ndarray, planes: int, palette: np.ndarray) -> bytes:
    """A 1-bit, `planes`-plane PCX of indices [H, W] (version 5, runs of
    up to 63 within a line), the 16-colour palette in the header."""
    h, w = idx.shape
    stride = (w + 7) // 8
    stride += stride % 2
    head = bytearray(128)
    head[0:4] = bytes((10, 5, 1, 1))
    struct.pack_into("<HHHHHH", head, 4, 0, 0, w - 1, h - 1, 72, 72)
    head[16:64] = palette.astype(np.uint8).tobytes()
    head[65] = planes
    struct.pack_into("<HH", head, 66, stride, 1)
    out = bytearray(head)
    for y in range(h):
        line = b""
        for k in range(planes):
            bits = ((idx[y] >> k) & 1).astype(np.uint8)
            line += np.packbits(bits).tobytes().ljust(stride, b"\0")
        i = 0
        while i < len(line):
            j = i
            while j + 1 < len(line) and line[j + 1] == line[i] and j - i < 62:
                j += 1
            if j > i or line[i] >= 0xC0:
                out += bytes((0xC0 | (j - i + 1), line[i]))
            else:
                out.append(line[i])
            i = j + 1
    return bytes(out)


def sgi_file(px: np.ndarray, bpc: int, rle: bool) -> bytes:
    """An SGI image of px [H, W, C] (values of bpc bytes), rows bottom-up,
    RLE rows of packets up to 127 long."""
    h, w, c = px.shape
    head = bytearray(512)
    struct.pack_into(">HBBHHHH", head, 0, 474, int(rle), bpc,
                     1 if (c == 1 and h == 1) else (2 if c == 1 else 3), w,
                     h, c)
    dt = ">u2" if bpc == 2 else np.uint8
    planes = px.transpose(2, 0, 1)[:, ::-1].astype(np.int64)
    if not rle:
        return bytes(head) + planes.astype(dt).tobytes()
    rows = []
    for ch in range(c):
        for y in range(h):
            vals, out, i = planes[ch, y].tolist(), [], 0
            while i < w:
                j = i
                while j + 1 < w and vals[j + 1] == vals[i] and j - i < 126:
                    j += 1
                if j > i:
                    out += [j - i + 1, vals[i]]
                    i = j + 1
                    continue
                j = i + 1
                while j < w and j - i < 127 and vals[j] != vals[j - 1]:
                    j += 1
                out += [0x80 | (j - i)] + vals[i:j]
                i = j
            rows.append(np.array(out + [0], np.int64).astype(dt).tobytes())
    table = 512 + 8 * h * c
    starts, pos = [], table
    for r in rows:
        starts.append(pos)
        pos += len(r)
    return (bytes(head) + struct.pack(f">{h * c}I", *starts)
            + struct.pack(f">{h * c}I", *[len(r) for r in rows])
            + b"".join(rows))


def msp_lins(bits: np.ndarray) -> bytes:
    """A version 2 ("LinS") MSP of bits [H, W] (1 white), runs coded."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    coded = []
    for r in (rows[y].tobytes() for y in range(h)):
        out, i = bytearray(), 0
        while i < len(r):
            j = i
            while j + 1 < len(r) and r[j + 1] == r[i] and j - i < 254:
                j += 1
            if j > i:
                out += bytes((0, j - i + 1, r[i]))
                i = j + 1
            else:
                out += bytes((1, r[i]))
                i += 1
        coded.append(b"" if r == b"\xff" * len(r) else bytes(out))
    words = list(struct.unpack("<2H", b"LinS")) + [w, h, 1, 1, 1, 1] + \
        [0] * 8
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return (struct.pack("<16H", *words) + struct.pack(
        f"<{h}H", *[len(c) for c in coded]) + b"".join(coded))


def cur_file(dibs, hotspots=((1, 2),)) -> bytes:
    """A CUR of DIBs (each a PIL-written DIB; its height doubled and a
    zero AND mask appended, as a cursor stores it)."""
    entries, blobs = [], []
    for dib in dibs:
        d = bytearray(dib)
        w, hgt = struct.unpack_from("<ii", d, 4)
        struct.pack_into("<i", d, 8, 2 * hgt)
        d += bytes(-(-w // 32) * 4 * hgt)
        blobs.append(bytes(d))
        entries.append((w, hgt))
    pos = 6 + 16 * len(dibs)
    head = struct.pack("<HHH", 0, 2, len(dibs))
    for (w, hgt), blob, hot in zip(entries, blobs,
                                   list(hotspots) * len(dibs)):
        head += struct.pack("<BBBBHHII", w % 256, hgt % 256, 0, 0, *hot,
                            len(blob), pos)
        pos += len(blob)
    return head + b"".join(blobs)


def ico_and_mask(img: Image.Image, mask: np.ndarray) -> bytes:
    """An ICO of one BMP entry: img's DIB (height doubled) and the AND
    mask (1 transparent), rows bottom-up."""
    d = bytearray(_pil_bytes(img, "DIB"))
    w, hgt = struct.unpack_from("<ii", d, 4)
    struct.pack_into("<i", d, 8, 2 * hgt)
    stride = -(-w // 32) * 4
    rows = np.zeros((hgt, stride), np.uint8)
    rows[:, :-(-w // 8)] = np.packbits(mask.astype(np.uint8), axis=1)
    d += rows[::-1].tobytes()
    bpp, = struct.unpack_from("<H", d, 14)
    return struct.pack("<HHHBBBBHHII", 0, 1, 1, w, hgt, 0, 0, 1, bpp,
                       len(d), 22) + bytes(d)


def _tiff_pil(img, **opts):
    return _pil_bytes(img, "TIFF", **opts)


def _pnm(magic: bytes, w, h, maxval, body) -> bytes:
    return magic + b"\n# a comment\n%d %d\n%d\n" % (w, h, maxval) + body


# ---------------------------------------------------------------------------
# the fixtures: name -> maker, a set a directory under tests/data

def _pnm_fixtures():
    img = _image(32, 24, 21).astype(np.int64)
    big = img * 257 + _rng(22).integers(0, 256, img.shape)
    f = (_image(20, 12, 23)[..., 0].astype(np.float32) - 60) * 2.5
    f[0, :3] = [np.nan, np.inf, -np.inf]
    cmyk = _rng(24).integers(0, 256, (12, 20, 4))
    return {
        "p6_65535.ppm": lambda: _pnm(b"P6", 32, 24, 65535,
                                     big.astype(">u2").tobytes()),
        "p6_100.ppm": lambda: _pnm(b"P6", 32, 24, 100,
                                   (img * 100 // 255).astype(
                                       np.uint8).tobytes()),
        "p5_1000.pgm": lambda: _pnm(b"P5", 32, 24, 1000, (
            big[..., 0] * 1000 // 65535).astype(">u2").tobytes()),
        "p5_65535.pgm": lambda: _pil_bytes(Image.fromarray(
            big[..., 1].astype(np.int32), "I"), "PPM"),
        "p2_300.pgm": lambda: _pnm(b"P2", 32, 24, 300, " ".join(
            map(str, (img[..., 2] * 300 // 255).ravel())).encode()),
        "p3_7.ppm": lambda: _pnm(b"P3", 32, 24, 7, "\n".join(
            map(str, (img >> 5).ravel())).encode()),
        "pf_le.pfm": lambda: _pil_bytes(Image.fromarray(f, "F"), "PPM"),
        "pf_be.pfm": lambda: b"Pf\n20 12\n4.0\n" + f[::-1].astype(
            ">f4").tobytes(),
        "p0cmyk.pnm": lambda: _pnm(b"P0CMYK", 20, 12, 255, cmyk.astype(
            np.uint8).tobytes()),
        "pyrgba.pnm": lambda: _pnm(b"PyRGBA", 20, 12, 1000, (
            cmyk * 1000 // 255).astype(">u2").tobytes()),
        "pyp.pnm": lambda: _pnm(b"PyP", 20, 12, 255, cmyk[..., 0].astype(
            np.uint8).tobytes()),
    }


def _tiff_fixtures():
    img = _image(45, 37, 31)
    pim = Image.fromarray(img)
    i64 = img.astype(np.int64)
    bits = np.asarray(pim.convert("1"))
    ycc = np.asarray(pim.convert("YCbCr")).astype(np.int64)
    rng = _rng(32)
    s16 = rng.integers(-32768, 32768, (37, 45, 1))
    s32 = rng.integers(-2 ** 31, 2 ** 31, (37, 45, 1))
    u32 = rng.integers(0, 2 ** 32, (37, 45, 1))

    def g4_fill2():
        d = _tiff_pil(Image.fromarray(bits), compression="group4")
        tags, _ = ttiff._ifd(d)
        strip = d[tags[273][0]:tags[273][0] + tags[279][0]].translate(_REV)
        return tiff_file(bits[..., None].astype(np.int64), tags[262][0], 1,
                         compression=4, encode=lambda b: strip,
                         extra_tags={266: (3, [2])})

    def subsampled(h, v):
        return tiff_file(ycc, 6, 8, compression=5, rows_per_strip=8,
                         encode=lambda b: tiff_lzw(ycbcr_units(
                             np.frombuffer(b, np.uint8).reshape(-1, 45, 3),
                             h, v)),
                         extra_tags={530: (3, [h, v]),
                                     532: (3, [0, 255, 128, 255, 128, 255])})

    return {
        "cmyk_lzw.tif": lambda: _tiff_pil(pim.convert("CMYK"),
                                          compression="tiff_lzw"),
        "cmyk_jpeg.tif": lambda: _tiff_pil(pim.convert("CMYK"),
                                           compression="jpeg"),
        "cmyk_lzma.tif": lambda: _tiff_pil(pim.convert("CMYK"),
                                           compression="lzma"),
        "ycbcr_deflate.tif": lambda: _tiff_pil(
            pim.convert("YCbCr"), compression="tiff_adobe_deflate"),
        "ycbcr_jpeg.tif": lambda: _tiff_pil(pim.convert("YCbCr"),
                                            compression="jpeg"),
        "ycbcr_22_lzw.tif": lambda: subsampled(2, 2),
        "ycbcr_42_lzw.tif": lambda: subsampled(4, 2),
        "rgb_jpeg.tif": lambda: _tiff_pil(pim, compression="jpeg",
                                          quality=85),
        "grey_jpeg.tif": lambda: _tiff_pil(pim.convert("L"),
                                           compression="jpeg"),
        "rgb_lzma.tif": lambda: _tiff_pil(pim, compression="lzma"),
        "old_lzw.tif": lambda: tiff_file(i64, 2, 8, compression=5,
                                         rows_per_strip=16, encode=old_lzw),
        "fill2_raw_grey.tif": lambda: tiff_file(
            i64[..., :1], 1, 8, encode=lambda b: b.translate(_REV),
            extra_tags={266: (3, [2])}),
        "fill2_lzw_bits.tif": lambda: tiff_file(
            bits[..., None].astype(np.int64), 0, 1, compression=5,
            encode=lambda b: tiff_lzw(b).translate(_REV),
            extra_tags={266: (3, [2])}),
        "fill2_deflate_rgb.tif": lambda: tiff_file(
            i64, 2, 8, compression=8,
            encode=lambda b: zlib.compress(b).translate(_REV),
            extra_tags={266: (3, [2])}),
        "orient6_lzw.tif": lambda: tiff_file(i64, 2, 8, compression=5,
                                             rows_per_strip=10,
                                             extra_tags={274: (3, [6])}),
        "orient3_raw.tif": lambda: tiff_file(i64, 2, 8,
                                             extra_tags={274: (3, [3])}),
        "orient5_packbits.tif": lambda: tiff_file(
            i64[..., :1], 1, 8, compression=32773,
            extra_tags={274: (3, [5])}),
        "int16.tif": lambda: tiff_file(s16, 1, 16, sample_dtype="i2",
                                       extra_tags={339: (3, [2])}),
        "int32_be_lzw.tif": lambda: tiff_file(
            s32, 1, 32, ">", compression=5, sample_dtype="i4",
            extra_tags={339: (3, [2])}),
        "uint32.tif": lambda: tiff_file(u32, 1, 32, sample_dtype="u4"),
        "float32_deflate.tif": lambda: _tiff_pil(Image.fromarray(
            (img[..., 0].astype(np.float32) - 100) * 3.5, "F"),
            compression="tiff_adobe_deflate"),
        "float32_be_raw.tif": lambda: tiff_file(
            (i64[..., :1] - 100) * 0.75, 1, 32, ">", sample_dtype="f4",
            extra_tags={339: (3, [3])}),
        "ccitt_rle.tif": lambda: _tiff_pil(Image.fromarray(bits),
                                           compression="tiff_ccitt"),
        "g3.tif": lambda: _tiff_pil(Image.fromarray(bits),
                                    compression="group3"),
        "g3_2d.tif": lambda: _tiff_pil(Image.fromarray(bits),
                                       compression="group3",
                                       tiffinfo={292: 5}),
        "g4.tif": lambda: _tiff_pil(Image.fromarray(bits),
                                    compression="group4"),
        "g4_fill2.tif": g4_fill2,
    }


def _tga_fixtures():
    img = _image(31, 23, 41)
    pim = Image.fromarray(img)
    rgba = np.dstack([img, _rng(42).integers(0, 256, img.shape[:2])])
    v16 = _rng(43).integers(0, 65536, (23, 31)).astype("<u2")
    idx = _rng(44).integers(0, 12, (23, 31)).astype(np.uint8)
    cmap16 = _rng(45).integers(0, 65536, 10).astype("<u2")
    cmap24 = _rng(46).integers(0, 256, (40, 3)).astype(np.uint8)
    flat = np.repeat(np.repeat(img[::4, ::4], 4, 0), 4, 1)[:23, :31]
    return {
        "rgb_raw.tga": lambda: _pil_bytes(pim, "TGA"),
        "rgba_rle_top.tga": lambda: _pil_bytes(Image.fromarray(
            rgba.astype(np.uint8)), "TGA", rle=True, orientation=1),
        "grey_rle.tga": lambda: _pil_bytes(pim.convert("L"), "TGA",
                                           rle=True),
        "la.tga": lambda: _pil_bytes(pim.convert("LA"), "TGA"),
        "p_rle.tga": lambda: _pil_bytes(pim.quantize(24), "TGA", rle=True),
        "mono.tga": lambda: _pil_bytes(pim.convert("1"), "TGA"),
        "rgb16.tga": lambda: tga_file(v16.view(np.uint8).reshape(
            23, 31, 2), 2, 16),
        "cmap16_start.tga": lambda: tga_file(
            (idx + 2)[..., None], 1, 8, cmap=cmap16, start=2, mapdepth=16,
            flags=0x00, ident=b"id text"),
        "cmap24_rle.tga": lambda: tga_file(idx[..., None], 9, 8,
                                           cmap=cmap24, rle=True),
        "mirrored.tga": lambda: tga_file(img[..., ::-1].copy(), 2, 24,
                                         flags=0x30),
        "rle_across_rows.tga": lambda: tga_file(
            flat[..., ::-1].copy(), 10, 24, flags=0x10, rle=True),
    }


def _pcx_fixtures():
    img = _image(33, 21, 51)
    pim = Image.fromarray(img)
    idx = _rng(52).integers(0, 16, (21, 33))
    pal = _rng(53).integers(0, 256, (16, 3))
    return {
        "mono.pcx": lambda: _pil_bytes(pim.convert("1"), "PCX"),
        "grey.pcx": lambda: _pil_bytes(pim.convert("L"), "PCX"),
        "palette.pcx": lambda: _pil_bytes(pim.quantize(60), "PCX"),
        "rgb.pcx": lambda: _pil_bytes(pim, "PCX"),
        "planes4.pcx": lambda: pcx_planes(idx, 4, pal),
        "planes2.pcx": lambda: pcx_planes(idx & 3, 2, pal),
    }


def _sgi_fixtures():
    img = _image(29, 19, 61)
    pim = Image.fromarray(img)
    rgba = np.dstack([img, _rng(62).integers(0, 256, img.shape[:2])])
    flat = np.repeat(img[::3], 3, 0)[:19]
    w16 = img.astype(np.int64) * 257 + _rng(63).integers(0, 256, img.shape)
    return {
        "rgb.sgi": lambda: _pil_bytes(pim, "SGI"),
        "rgba.sgi": lambda: _pil_bytes(Image.fromarray(
            rgba.astype(np.uint8)), "SGI"),
        "grey.sgi": lambda: _pil_bytes(pim.convert("L"), "SGI"),
        "rgb_rle.sgi": lambda: sgi_file(flat, 1, True),
        "grey16_rle.sgi": lambda: sgi_file(w16[..., :1], 2, True),
        "rgb16.sgi": lambda: sgi_file(w16, 2, False),
    }


def _qoi_fixtures():
    img = _image(30, 22, 71)
    rgba = np.dstack([img, np.where(_rng(72).random(img.shape[:2]) < 0.3,
                                    0, 200)]).astype(np.uint8)
    return {
        "rgb.qoi": lambda: _pil_bytes(Image.fromarray(poster(32, 24, 73)),
                                      "QOI"),
        "rgba.qoi": lambda: _pil_bytes(Image.fromarray(rgba), "QOI"),
    }


def _ico_fixtures():
    img = _image(32, 32, 81)
    pim = Image.fromarray(img)
    rgba = Image.fromarray(np.dstack([img, _rng(82).integers(
        0, 256, (32, 32))]).astype(np.uint8))
    small = Image.fromarray(_image(16, 16, 83))
    mask = _rng(84).random((16, 16)) < 0.3
    return {
        "png_entries.ico": lambda: _pil_bytes(rgba, "ICO",
                                              sizes=[(32, 32), (16, 16)]),
        "bmp32.ico": lambda: _pil_bytes(rgba, "ICO", bitmap_format="bmp",
                                        sizes=[(32, 32), (16, 16)]),
        "bmp_p.ico": lambda: _pil_bytes(pim.quantize(16), "ICO",
                                        bitmap_format="bmp",
                                        sizes=[(32, 32)]),
        "and_mask.ico": lambda: ico_and_mask(small.quantize(16), mask),
        "cursor32.cur": lambda: cur_file([_pil_bytes(rgba.resize(
            (16, 16)), "DIB")]),
        "cursor_two.cur": lambda: cur_file([
            _pil_bytes(small.quantize(8), "DIB"), _pil_bytes(pim, "DIB")]),
        "rgb.dib": lambda: _pil_bytes(pim, "DIB"),
        "palette.dib": lambda: _pil_bytes(pim.quantize(20), "DIB"),
    }


def _bilevel_fixtures():
    bits = np.asarray(Image.fromarray(_image(37, 19, 91)).convert("1"))
    runs = np.repeat(np.repeat(bits[::4, ::5], 4, 0), 5, 1)[:19, :37]
    runs[3:5] = True
    return {
        "danm.msp": lambda: _pil_bytes(Image.fromarray(bits), "MSP"),
        "lins.msp": lambda: msp_lins(runs),
        "plain.xbm": lambda: _pil_bytes(Image.fromarray(bits), "XBM"),
        "hotspot.xbm": lambda: _pil_bytes(Image.fromarray(bits), "XBM",
                                          hotspot=(3, 4)),
    }


def _restore_fixtures():
    """The restore folder: 256x256 files that only the new readers decode,
    under the dataset's extensions; and a TGA for --image."""
    p = [poster(256, 256, 100 + k).astype(np.int64) for k in range(9)]
    return {
        "p6_65535.ppm": lambda: _pnm(b"P6", 256, 256, 65535, (
            p[0] * 257 + (p[0] % 7)).astype(">u2").tobytes()),
        "p6_100.ppm": lambda: _pnm(b"P6", 256, 256, 100, (
            p[1] * 100 // 255).astype(np.uint8).tobytes()),
        "p5_1000.ppm": lambda: _pnm(b"P5", 256, 256, 1000, (
            p[2][..., 0] * 4).astype(">u2").tobytes()),
        "cmyk_lzw.png": lambda: _tiff_pil(Image.fromarray(p[3].astype(
            np.uint8)).convert("CMYK"), compression="tiff_lzw"),
        "ycbcr_jpeg.jpg": lambda: _tiff_pil(Image.fromarray(p[4].astype(
            np.uint8)).convert("YCbCr"), compression="jpeg"),
        "tga_rle.jpg": lambda: _pil_bytes(Image.fromarray(p[5].astype(
            np.uint8)), "TGA", rle=True),
        "sgi_rle.png": lambda: sgi_file(p[6], 1, True),
        "qoi.jpg": lambda: _pil_bytes(Image.fromarray(p[7].astype(
            np.uint8)), "QOI"),
    }


FIXTURE_SETS = {"pnm": _pnm_fixtures, "tiff_more": _tiff_fixtures,
                "tga": _tga_fixtures, "pcx": _pcx_fixtures,
                "sgi": _sgi_fixtures, "qoi": _qoi_fixtures,
                "ico": _ico_fixtures, "bilevel": _bilevel_fixtures,
                "restore16": _restore_fixtures}
# --image in chip_smoke's phase 15: an uncompressed bottom-up TGA
IMAGE_TGA = ("tga", "restore_256.tga", lambda: _pil_bytes(Image.fromarray(
    poster(256, 256, 120)), "TGA"))


def pil_png_name(name: str) -> str:
    return os.path.splitext(name)[0] + "_pil.png"


def make_fixtures(root: str) -> None:
    """Write each fixture under root/<set>/ and PIL's convert("RGBA") of
    it beside it as `<stem>_pil.png`."""
    for sub, fixtures in FIXTURE_SETS.items():
        items = list(fixtures().items())
        if sub == IMAGE_TGA[0]:
            items.append(IMAGE_TGA[1:])
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for name, make in items:
            data = make()
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(data)
            rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
            Image.fromarray(rgba).save(os.path.join(root, sub,
                                                    pil_png_name(name)))


def _all_fixtures():
    out = []
    for sub, fixtures in FIXTURE_SETS.items():
        out += [(sub, n) for n in fixtures()]
    return out + [IMAGE_TGA[:2]]


# ---------------------------------------------------------------------------
# tests

@pytest.mark.parametrize("sub,name", _all_fixtures(),
                         ids=lambda x: x if isinstance(x, str) else None)
def test_committed_fixture_reads_as_pil(sub, name):
    path = os.path.join(DATA, sub, name)
    with open(path, "rb") as f:
        data = f.read()
    got, im = assert_reads_as_pil(data, name)
    np.testing.assert_array_equal(tio.load_rgba_uint8(path), tio.load_png(
        os.path.join(DATA, sub, pil_png_name(name))))
    np.testing.assert_array_equal(tio.load_rgb_uint8(path),
                                  np.asarray(im.convert("RGB")))
    if im.format not in ("DIB", "ICO", "CUR"):      # read through BMP's
        assert got.mode == im.mode or im.mode == "P", (name, got.mode,
                                                      im.mode)


def test_fixtures_are_what_make_fixtures_writes(tmp_path):
    make_fixtures(str(tmp_path))
    for sub, name in _all_fixtures():
        committed = os.path.join(DATA, sub, name)
        made = str(tmp_path / sub / name)
        a, b = open(committed, "rb").read(), open(made, "rb").read()
        if a != b:
            # libtiff leaves some IFD bytes undefined: compare the decodes
            assert name.endswith((".tif", ".png", ".jpg")) and \
                a[:2] in (b"II", b"MM"), name
            np.testing.assert_array_equal(
                np.asarray(Image.open(committed).convert("RGBA")),
                np.asarray(Image.open(made).convert("RGBA")))
        np.testing.assert_array_equal(
            tio.load_png(os.path.join(DATA, sub, pil_png_name(name))),
            tio.load_png(str(tmp_path / sub / pil_png_name(name))))


@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 65534, 65535])
@pytest.mark.parametrize("magic,bands", [(b"P5", 1), (b"P6", 3), (b"P2", 1),
                                         (b"P3", 3), (b"P0CMYK", 4),
                                         (b"PyRGBA", 4), (b"PyCMYK", 4)])
def test_pnm_any_maxval_reads_as_pil(magic, bands, maxval):
    # the fault: the port raised "unsupported PNM maxval" on all but 255
    v = _rng(maxval).integers(0, maxval + 1, (5, 7, bands))
    if magic in (b"P2", b"P3"):
        body = " ".join(map(str, v.ravel())).encode()
    else:
        body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    assert_reads_as_pil(_pnm(magic, 7, 5, maxval, body))


@pytest.mark.parametrize("case", [
    "sample_above_maxval", "maxval_0", "maxval_65536", "truncated",
    "pf_zero_scale", "bad_magic"])
def test_pnm_refused_where_pil_refuses(case):
    data = {
        "sample_above_maxval": _pnm(b"P2", 2, 1, 7, b"3 9"),
        "maxval_0": _pnm(b"P5", 2, 1, 0, b"\0\0"),
        "maxval_65536": _pnm(b"P5", 2, 1, 65536, bytes(4)),
        "truncated": _pnm(b"P6", 2, 2, 255, bytes(5)),
        "pf_zero_scale": b"Pf\n1 1\n0.0\n" + bytes(4),
        "bad_magic": b"P8\n1 1\n255\n\0",
    }[case]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError):
        tio.decode_image(data)


@pytest.mark.parametrize("fmt,opts", [
    ("DDS", {}), ("IM", {}), ("ICNS", {}), ("JPEG2000", {}), ("BLP", {}),
    ("EPS", {}), ("AVIF", {"quality": 60})])
def test_formats_still_refused_raise_naming_the_type(fmt, opts, tmp_path):
    # the formats this file's slice left: PIL writes each here.  DDS, IM,
    # ICNS, BLP, JPEG 2000 and AVIF are now read as PIL reads them; EPS
    # raises where PIL raises (it renders through Ghostscript, and raises
    # without it)
    img = Image.fromarray(_image(32, 32, 99))
    if fmt == "BLP":                        # PIL writes BLP from "P" only
        img = img.quantize(16)
    try:
        data = _pil_bytes(img, fmt, **opts)
    except Exception as e:                          # pragma: no cover
        pytest.fail(f"PIL could not write {fmt}: {e}")
    assert tio.image_type(data) == pil_format(data)
    if fmt == "EPS":
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        with pytest.raises(OSError, match="EPS"):
            tio.decode_image(data, "a.bin")
    else:
        assert_reads_as_pil(data, fmt)


def test_tiff_zstd_and_webp_raise_naming_the_compression():
    # ZSTD (50000) is read (zstd.py): a strip of raw bytes is no zstd
    # frame, so it raises, naming zstd, where libtiff fails too; WebP
    # (50001) raises naming the compression
    img = _image(16, 8, 7).astype(np.int64)
    data = tiff_file(img, 2, 8, encode=lambda b: b,
                     extra_tags={259: (3, [50000])})
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="zstd"):
        ttiff.decode_tiff(data)
    from test_torch_zstd import zstd_frame

    data = tiff_file(img, 2, 8, encode=zstd_frame,
                     extra_tags={259: (3, [50000])})
    np.testing.assert_array_equal(ttiff.decode_tiff(data).pixels, img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    data = tiff_file(img, 2, 8, encode=lambda b: b,
                     extra_tags={259: (3, [50001])})
    with pytest.raises(NotImplementedError,
                       match="Compression 50001 \\(WebP\\)"):
        ttiff.decode_tiff(data)


def test_tga_without_a_signature_is_tried_last():
    # a type-2 TGA begins with CUR's prefix (0, 0, 2, 0): PIL's CUR plugin
    # finds no cursor and goes on, as image_type does; a TGA with a bad
    # header is no image at all
    data = _pil_bytes(Image.fromarray(_image(9, 7, 5)), "TGA")
    assert data[:4] == b"\0\0\2\0"
    assert tio.image_type(data) == "TGA" == pil_format(data)
    bad = data[:16] + bytes((7,)) + data[17:]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bad))
    assert tio.image_type(bad) == ""


def test_restore_folder_batches_match_jax(tmp_path):
    # the slice as a whole: the restore dataset over files only the new
    # readers decode, bit-equal to the JAX package's (PIL's) batches
    from pointdreamer_tpu.models.diffusion import datasets as jds
    from pointdreamer_tpu_torch.models.diffusion import datasets as tds

    src = os.path.join(DATA, "restore16")
    names = list(_restore_fixtures())
    root = tmp_path / "imgs"
    os.makedirs(root)
    for n in names:
        shutil.copy(os.path.join(src, n), root / n)
    jd = jds.ImageFolderDataset(str(root), 256)
    td = tds.ImageFolderDataset(str(root), 256)
    assert td.files == jd.files and len(td.files) == 8
    jb, tb = list(jd.batches(8)), list(td.batches(8))
    assert [n for n, _ in tb] == [n for n, _ in jb]
    for (_, a), (_, b) in zip(jb, tb):
        assert a.shape == b.shape == (8, 256, 256, 3)
        np.testing.assert_array_equal(b, a)
    kinds = sorted(tio.image_type(open(os.path.join(src, n), "rb").read())
                   for n in names)
    assert kinds == ["PNM", "PNM", "PNM", "QOI", "SGI", "TGA", "TIFF",
                     "TIFF"]
