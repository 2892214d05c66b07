"""PyTorch port, the rest of PIL 12.1's readers: DDS with BC1-BC7 and FTEX
(dds.py, bcn.py), PSD (psd.py), ICNS (icns.py), BLP (blp.py), IM and IMT
(im.py), SPIDER (spider.py), FITS (fits.py), XPM (xpm.py), FLI (fli.py),
SUN (sun.py), DCX (dcx.py), PCD (pcd.py), IPTC (iptc.py), GBR, McIdas,
PIXAR and XV thumbnails (smallimg.py), and the formats PIL identifies
and the port refuses (refused.py).

PIL is the oracle: each file decodes bit-equal to PIL's convert("RGB"),
convert("RGBA") and its native pixels, in PIL's mode, and `io.image_type`
names PIL's `format`, the port's plugin walk being PIL's `Image.ID`.  PIL
writes what it can (DDS raw and DXT / BC2 / BC3 / BC5, BLP palettes, IM,
SPIDER); the rest come from the writers here.  The committed fixtures
under tests/data/{dds,blp,psd,icns,im,sci,xpm,fli,sun,dcx,pcd,small,
restore17}/ (PIL's convert("RGBA") beside each as `<stem>_pil.png`, and
its pixels as `<stem>_pil.npy` where PNG cannot hold its mode) are what
`make_fixtures` writes; `chip_smoke.py` decodes them on the machine
without PIL.  The slice as a whole: the restore dataset's batches over
tests/data/restore17 (files only the new readers decode, under the
dataset's extensions) bit-equal to the JAX package's."""
import gzip
import io
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import bcn as tbcn
from pointdreamer_tpu_torch import imagemode as tmode
from pointdreamer_tpu_torch import io as tio

from test_torch_image_formats import _image, poster
from test_torch_image_formats_more import tga_file

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
NPY_MODES = ("F", "I", "I;16", "I;16L", "I;16B")


def _rng(seed):
    return np.random.default_rng(seed)


def _pil_bytes(img, fmt, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def _pil_open(data: bytes):
    im = Image.open(io.BytesIO(data))
    im.load()
    return im


def _native(im: Image.Image) -> np.ndarray:
    a = np.asarray(im)
    return a.astype(a.dtype.newbyteorder("=")) if a.dtype.byteorder == ">" \
        else a


def assert_native_equal(got: tmode.ModeImage, im: Image.Image, name=""):
    """The port's mode and pixels are PIL's (a "1" image as 0 / 255, a "P"
    image by its indices)."""
    assert got.mode == im.mode, (name, got.mode, im.mode)
    want = _native(im)
    px = got.pixels
    if im.mode == "1":
        px = px == 255
    np.testing.assert_array_equal(px, want, err_msg=name)


def assert_reads_as_pil(data: bytes, name: str = "image", native=True):
    im = _pil_open(data)
    kind = tio.image_type(data)
    assert ("PPM" if kind == "PNM" else kind) == im.format, (name, kind)
    got = tio.decode_image(data, name)
    np.testing.assert_array_equal(tmode.to_rgb(got),
                                  np.asarray(im.convert("RGB")), name)
    np.testing.assert_array_equal(tmode.to_rgba(got),
                                  np.asarray(im.convert("RGBA")), name)
    if native:
        assert_native_equal(got, im, name)
    return got, im


# ---------------------------------------------------------------------------
# writers for what PIL does not write

def dds_header(w, h, pfflags, fourcc=b"\0\0\0\0", bitcount=0,
               masks=(0, 0, 0, 0)) -> bytes:
    return (b"DDS " + struct.pack("<7I", 124, 0x100F, h, w, 0, 0, 0)
            + bytes(44) + struct.pack("<2I", 32, pfflags) + fourcc
            + struct.pack("<I", bitcount) + struct.pack("<4I", *masks)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))


def dds_blocks(w, h, body: bytes, fourcc=None, dxgi=None) -> bytes:
    if dxgi is not None:
        return (dds_header(w, h, 4, b"DX10")
                + struct.pack("<5I", dxgi, 3, 0, 1, 0) + body)
    return dds_header(w, h, 4, fourcc) + body


def bc7_mode6(rgba: np.ndarray) -> bytes:
    """A BC7 encoder of mode 6 only (one subset, 7-bit RGBA ends with an
    end's p-bit 0, 4-bit indices): each block's channel-wise minimum and
    maximum as ends, each texel projected on their line."""
    h, w = rgba.shape[:2]
    bw, bh = -(-w // 4), -(-h // 4)
    pad = np.pad(rgba, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)),
                 mode="edge").astype(np.int64)
    blocks = pad.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(
        -1, 16, 4)
    e0 = blocks.min(1) >> 1
    e1 = blocks.max(1) >> 1
    d = (e1 - e0)[:, None, :] * 2
    t = ((blocks - 2 * e0[:, None, :]) * d).sum(-1) / np.maximum(
        (d * d).sum(-1), 1)
    idx = np.clip(np.rint(t * 15), 0, 15).astype(np.int64)
    flip = idx[:, 0] >= 8
    e0[flip], e1[flip] = e1[flip].copy(), e0[flip].copy()
    idx[flip] = 15 - idx[flip]
    fields = [(1 << 6, 7)]
    out = []
    for b in range(len(blocks)):
        val, pos = 0, 0
        for v, n in fields + [(int(e[b, c]), 7) for c in range(4)
                              for e in (e0, e1)] + [(0, 1), (0, 1)] + [
                (int(idx[b, i]), 3 if i == 0 else 4) for i in range(16)]:
            val |= v << pos
            pos += n
        out.append(val.to_bytes(16, "little"))
    return b"".join(out)


def _packbits(row: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes((257 - (j - i + 1), row[i]))
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and (j + 1 >= n or row[j + 1] != row[j]):
            j += 1
        out += bytes((j - i - 1,)) + row[i:j]
        i = j
    return bytes(out)


def psd_file(planes: np.ndarray, cmode: int, bits: int, comp: int,
             palette=b"", channels=None, layers=False) -> bytes:
    """A PSD of planes [C, H, rowbytes] (colour mode `cmode`), raw or
    PackBits, with a resource and a layer section to skip when asked."""
    c, h, _ = planes.shape
    w = planes.shape[2] * (8 if bits == 1 else 1)
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits,
                                 cmode)
    head += struct.pack(">I", len(palette)) + palette
    res = b""
    lay = b""
    if layers:
        blob = b"resource"
        res = b"8BIM" + struct.pack(">H", 1005) + b"\x03abc" + \
            struct.pack(">I", len(blob)) + blob
        lay = struct.pack(">I", 8) + bytes(8)
    head += struct.pack(">I", len(res)) + res
    head += struct.pack(">I", len(lay)) + lay
    data = planes.astype(np.uint8)
    if comp == 0:
        return head + struct.pack(">H", 0) + data.tobytes()
    rows = [_packbits(data[k, y].tobytes()) for k in range(c)
            for y in range(h)]
    return (head + struct.pack(">H", 1)
            + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows))


def _icns_rle(ch: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(ch)
    while i < n:
        j = i
        while j + 1 < n and ch[j + 1] == ch[i] and j - i < 129:
            j += 1
        if j - i + 1 >= 3:
            out += bytes((j - i + 1 + 125, ch[i]))
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 2 < n and ch[j] == ch[j + 1]
                                             == ch[j + 2]):
            j += 1
        out += bytes((j - i - 1,)) + ch[i:j]
        i = j
    return bytes(out)


def icns_file(entries) -> bytes:
    body = b"".join(sig + struct.pack(">I", len(d) + 8) + d
                    for sig, d in entries)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def icns_rle(rgb: np.ndarray) -> bytes:
    return b"".join(_icns_rle(rgb[..., k].tobytes()) for k in range(3))


def blp1_jpeg(jpeg: bytes, w, h, alpha) -> bytes:
    """A BLP1 JPEG: the stream up to its first SOS as the shared header,
    the rest as the mipmap (at an offset past a gap)."""
    sos = jpeg.index(b"\xff\xda")
    head, rest = jpeg[:sos], jpeg[sos:]
    pre = b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
    at = len(pre) + 128 + 4 + len(head) + 6
    return (pre + struct.pack("<16I", at, *[0] * 15)
            + struct.pack("<16I", len(rest), *[0] * 15)
            + struct.pack("<I", len(head)) + head + bytes(6) + rest)


def blp2_dxt(w, h, aenc, alpha, body: bytes, seed=0) -> bytes:
    head = b"BLP2" + struct.pack("<ibbbbII", 1, 2, alpha, aenc, 0, w, h)
    at = 20 + 128 + 1024
    return (head + struct.pack("<16I", at, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15)
            + _rng(seed).integers(0, 256, 1024).astype(np.uint8).tobytes()
            + body)


def im_file(kind: str, w, h, body: bytes, lut: bytes = None) -> bytes:
    head = f"Image type: {kind}\r\nImage size (x*y): {w}*{h}\r\n".encode()
    if lut is not None:
        head += b"Lut: 1\r\n"
    return head.ljust(511, b"\0") + b"\x1a" + (lut or b"") + body


def _card(k, v) -> bytes:
    return (k.ljust(8) + "= " + str(v).rjust(20)).ljust(80).encode()


def fits_file(cards, body: bytes) -> bytes:
    h = b"".join(_card(k, v) for k, v in cards) + b"END".ljust(80)
    h = h.ljust(-(-len(h) // 2880) * 2880, b" ")
    return h + body + bytes(-len(body) % 2880)


def fits_gzip(img: np.ndarray, zbitpix: int) -> bytes:
    """A primary HDU with no data and a GZIP_1 tile-compressed image
    (one tile, 4-byte big-endian samples)."""
    heap = gzip.compress(img.astype(">i4").tobytes(), mtime=0)
    h, w = img.shape
    prim = fits_file([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)], b"")
    ext = [("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
           ("NAXIS1", 8), ("NAXIS2", 1), ("ZIMAGE", "T"),
           ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", zbitpix), ("ZNAXIS", 2),
           ("ZNAXIS1", w), ("ZNAXIS2", h)]
    hdr = b"".join(_card(k, v) for k, v in ext) + b"END".ljust(80)
    return prim + hdr.ljust(2880, b" ") + struct.pack(">ii", len(heap), 0) \
        + heap


def xpm_file(idx: np.ndarray, cols, cpp: int) -> bytes:
    h, w = idx.shape
    keys = ["".join(chr(35 + ((i // 88 ** k) % 88)) for k in range(cpp))
            for i in range(len(cols))]
    lines = ["/* XPM */", "static char *x[] = {",
             "/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(cols)} {cpp} ",']
    lines += [f'"{k} c {"None" if c is None else "#%06X" % c}",'
              for k, c in zip(keys, cols)]
    lines.append("/* pixels */")
    lines += ['"' + "".join(keys[i] for i in idx[y]) + '",' for y in range(h)]
    return ("\n".join(lines) + "\n};\n").encode()


def fli_chunk(kind, body: bytes) -> bytes:
    body += b"\0" * (len(body) % 2)
    return struct.pack("<IH", len(body) + 6, kind) + body


def fli_color(pal, kind=4, skip=0) -> bytes:
    return fli_chunk(kind, struct.pack("<H", 1) + bytes((skip, len(pal) % 256))
                     + np.asarray(pal, np.uint8).tobytes())


def fli_brun(img: np.ndarray) -> bytes:
    out = bytearray()
    for row in img.tolist():
        out.append(0)
        x, w = 0, len(row)
        while x < w:
            j = x
            while j + 1 < w and row[j + 1] == row[x] and j - x < 126:
                j += 1
            if j > x:
                out += bytes((j - x + 1, row[x]))
                x = j + 1
                continue
            j = x + 1
            while j < w and j - x < 127 and row[j] != row[j - 1]:
                j += 1
            out += bytes((256 - (j - x),)) + bytes(row[x:j])
            x = j
    return fli_chunk(15, bytes(out))


def fli_lc(img: np.ndarray, y0: int) -> bytes:
    out = bytearray(struct.pack("<HH", y0, img.shape[0]))
    for row in img.tolist():
        w = len(row)
        out.append(2)
        out += bytes((1, 3)) + bytes(row[1:4])
        out += bytes((0, (256 - (w - 4)) & 0xFF, row[4]))
    return fli_chunk(12, bytes(out))


def fli_ss2(img: np.ndarray, skip: int, last=None) -> bytes:
    h, w = img.shape
    out = bytearray(struct.pack("<H", h - skip))
    for y in range(skip, h):
        row = img[y].tolist()
        words = [65536 - skip] if y == skip and skip else []
        if last is not None:
            words.append(0x8000 | last)
        n = (w - 4) // 2
        pk = bytes((0, 2)) + bytes(row[0:4]) + bytes((0, 256 - n)) + bytes(
            row[4:6])
        out += b"".join(struct.pack("<H", v) for v in words) + struct.pack(
            "<H", 2) + pk
    return fli_chunk(7, bytes(out))


def fli_file(w, h, chunks, magic=0xAF12) -> bytes:
    body = b"".join(chunks)
    frame = struct.pack("<IHH", 16 + len(body), 0xF1FA, len(chunks)) + \
        bytes(8) + body
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), magic, 1, w, h,
                     8, 0, 5)
    return bytes(head) + frame


def _sun_rle(b: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(b)
    while i < n:
        j = i
        while j + 1 < n and b[j + 1] == b[i] and j - i < 255:
            j += 1
        if j - i + 1 >= 3:
            out += bytes((0x80, j - i, b[i]))
            i = j + 1
        elif b[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(b[i])
            i += 1
    return bytes(out)


def sun_file(w, h, depth, kind, rows: bytes, cmap=b"") -> bytes:
    body = _sun_rle(rows) if kind == 2 else rows
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind,
                       1 if cmap else 0, len(cmap)) + cmap + body


def sun_rows(px: np.ndarray, depth: int, rle: bool) -> bytes:
    """Rows of packed pixels [H, W(, C)], padded to 16 bits unless RLE."""
    h = px.shape[0]
    if depth < 8:
        v = px.reshape(h, -1).astype(np.int64)
        bits = ((v[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
            h, -1)
        rows = np.packbits(bits.astype(np.uint8), axis=1)
    else:
        rows = px.reshape(h, -1).astype(np.uint8)
    if not rle and rows.shape[1] % 2:
        rows = np.pad(rows, ((0, 0), (0, 1)))
    return rows.tobytes()


def dcx_file(pages) -> bytes:
    at = 4 + 4 * (len(pages) + 1)
    offs = []
    for p in pages:
        offs.append(at)
        at += len(p)
    return struct.pack("<I", 0x3ADE68B1) + struct.pack(
        f"<{len(pages) + 1}I", *offs, 0) + b"".join(pages)


def pcd_file(ycc: np.ndarray, orient: int) -> bytes:
    """A PCD: "PCD_" at 2048 with the orientation byte, the base image's
    row pairs (Y, Y, C1, C2) at 96 x 2048."""
    d = bytearray(96 * 2048)
    d[2048:2052] = b"PCD_"
    d[2048 + 1538] = orient
    y, c1, c2 = ycc
    pairs = [np.concatenate([y[2 * k], y[2 * k + 1], c1[k], c2[k]])
             for k in range(256)]
    return bytes(d) + np.stack(pairs).astype(np.uint8).tobytes()


def iptc_field(rec, ds, body: bytes) -> bytes:
    if len(body) < 0x8000:
        return bytes((0x1C, rec, ds)) + struct.pack(">H", len(body)) + body
    return bytes((0x1C, rec, ds, 0x84)) + struct.pack(">I", len(body)) + body


def iptc_file(w, h, layers, component, band, pixels: bytes) -> bytes:
    out = iptc_field(1, 90, b"\x1b%G") + iptc_field(2, 5, b"title")
    out += iptc_field(3, 20, struct.pack(">H", w))
    out += iptc_field(3, 30, struct.pack(">H", h))
    out += iptc_field(3, 60, bytes((layers, component)))
    if band is not None:
        out += iptc_field(3, 65, bytes((band,)))
    out += iptc_field(3, 120, bytes((1,)))
    half = len(pixels) // 2
    return out + iptc_field(8, 10, pixels[:half]) + iptc_field(
        8, 10, pixels[half:])


def gbr_file(px: np.ndarray, version: int) -> bytes:
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    name = b"brush\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(name), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(name), 2, w, h, depth) + \
            b"GIMP" + struct.pack(">I", 25)
    return head + name + px.astype(np.uint8).tobytes()


def mcidas_file(px: np.ndarray, nbytes: int, prefix: int = 4) -> bytes:
    h, w = px.shape
    words = [0] * 64
    words[1] = 4                                # word 2: the "version" 4
    words[8], words[9], words[10] = h, w, nbytes
    words[13], words[14] = 1, prefix            # bands, line prefix
    words[33] = 256                             # word 34: data offset
    dt = {1: "u1", 2: ">u2", 4: ">i4"}[nbytes]
    rows = b"".join(bytes(prefix) + px[y].astype(dt).tobytes()
                    for y in range(h))
    return struct.pack(">64i", *words) + rows[prefix:] + bytes(prefix)


def pixar_file(rgb: np.ndarray) -> bytes:
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def xv_file(idx: np.ndarray) -> bytes:
    h, w = idx.shape
    return (b"P7 332\n#XVVERSION:Version 2.28\n#IMGINFO:GIF89a\n"
            b"#END_OF_COMMENTS\n" + b"%d %d 255\n" % (w, h)
            + idx.astype(np.uint8).tobytes())


def imt_file(px: np.ndarray) -> bytes:
    h, w = px.shape
    return (b"* an IM Tools image\nwidth %d\nheight %d\npixel n8\n\x0c"
            % (w, h)) + px.astype(np.uint8).tobytes()


def ftex_file(fmt, w, h, payload: bytes) -> bytes:
    return (b"FTEX" + struct.pack("<6i", 0, w, h, 1, 1, fmt)
            + struct.pack("<i", 32) + struct.pack("<i", len(payload))
            + payload)


def random_blocks(n: int, size: int, seed: int, mode_bits=None) -> bytes:
    """Random BCn blocks; BC7 blocks spread over its 8 modes and the
    reserved one when `mode_bits` is 7, BC6H endpoints kept small."""
    rng = _rng(seed)
    b = rng.integers(0, 256, (n, size)).astype(np.int64)
    if mode_bits == 7:
        m = np.arange(n) % 9
        b[:, 0] = np.where(m < 8, ((b[:, 0] << (m + 1)) | (1 << m)) & 255, 0)
    elif mode_bits == 6:
        codes = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15,
                          19])
        c = codes[np.arange(n) % len(codes)]
        b[:, 1:10] &= rng.integers(0, 256, (n, 9))
        b[:, 0] = np.where(c < 2, (b[:, 0] & 0xFC) | c, (b[:, 0] & 0xE0) | c)
    return b.astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# the fixtures: name -> maker, a set a directory under tests/data

def _dds_fixtures():
    img = _image(29, 23, 201)
    rgba = np.dstack([img, _rng(202).integers(0, 256, img.shape[:2])]
                     ).astype(np.uint8)
    pim, pa = Image.fromarray(img), Image.fromarray(rgba)

    def masked(bitcount, masks, flags, seed):
        n = 23 * 29 * bitcount // 8
        body = _rng(seed).integers(0, 256, n).astype(np.uint8).tobytes()
        return dds_header(29, 23, flags, bitcount=bitcount,
                          masks=tuple(masks) + (0,) * (4 - len(masks))) + body

    return {
        "rgb.dds": lambda: _pil_bytes(pim, "DDS"),
        "rgba.dds": lambda: _pil_bytes(pa, "DDS"),
        "l.dds": lambda: _pil_bytes(pim.convert("L"), "DDS"),
        "la.dds": lambda: _pil_bytes(pa.convert("LA"), "DDS"),
        "dxt1.dds": lambda: _pil_bytes(pa, "DDS", pixel_format="DXT1"),
        "dxt3.dds": lambda: _pil_bytes(pa, "DDS", pixel_format="DXT3"),
        "dxt5.dds": lambda: _pil_bytes(pa, "DDS", pixel_format="DXT5"),
        "bc5_dx10.dds": lambda: _pil_bytes(pim, "DDS", pixel_format="BC5"),
        "dxt1_3colour.dds": lambda: dds_blocks(
            24, 24, random_blocks(36, 8, 203), b"DXT1"),
        "ati1.dds": lambda: dds_blocks(24, 22, random_blocks(36, 8, 204),
                                       b"ATI1"),
        "bc5s.dds": lambda: dds_blocks(24, 24, random_blocks(36, 16, 205),
                                       b"BC5S"),
        "bc6h_uf16.dds": lambda: dds_blocks(
            24, 24, random_blocks(36, 16, 206, 6), dxgi=95),
        "bc6h_sf16.dds": lambda: dds_blocks(
            24, 24, random_blocks(36, 16, 207, 6), dxgi=96),
        "bc7_modes.dds": lambda: dds_blocks(
            24, 23, random_blocks(36, 16, 208, 7), dxgi=98),
        "bc7_image.dds": lambda: dds_blocks(29, 23, bc7_mode6(rgba),
                                            dxgi=98),
        "r5g6b5.dds": lambda: masked(16, (0xF800, 0x7E0, 0x1F), 0x40, 209),
        "a4r4g4b4.dds": lambda: masked(16, (0xF00, 0xF0, 0xF, 0xF000),
                                       0x41, 210),
        "pal8.dds": lambda: dds_header(29, 23, 0x20, bitcount=8) + _rng(
            211).integers(0, 256, 1024 + 29 * 23).astype(np.uint8).tobytes(),
        "r8g8b8a8_dx10.dds": lambda: dds_blocks(29, 23, rgba.tobytes(),
                                                dxgi=28),
        "ftex_dxt1.ftc": lambda: ftex_file(0, 24, 24,
                                           random_blocks(36, 8, 212)),
        "ftex_rgb.ftu": lambda: ftex_file(1, 29, 23, img.tobytes()),
    }


def _blp_fixtures():
    img = _image(32, 16, 221)
    rgba = np.dstack([img, _rng(222).integers(0, 256, img.shape[:2])]
                     ).astype(np.uint8)
    pal = Image.fromarray(img).quantize(60)
    pala = Image.fromarray(rgba).quantize(
        40, method=Image.Quantize.FASTOCTREE)
    jpeg = _pil_bytes(Image.fromarray(img), "JPEG", quality=85)

    def dxt(w, h, aenc, alpha, seed):
        n = -(-w // 4) * -(-h // 4) * (8 if aenc == 0 else 16)
        return blp2_dxt(w, h, aenc, alpha, _rng(seed).integers(
            0, 256, n).astype(np.uint8).tobytes(), seed)

    return {
        "blp1_palette.blp": lambda: _pil_bytes(pal, "BLP",
                                               blp_version="BLP1"),
        "blp1_palette_alpha.blp": lambda: _pil_bytes(pala, "BLP",
                                                     blp_version="BLP1"),
        "blp2_palette.blp": lambda: _pil_bytes(pal, "BLP"),
        "blp2_palette_alpha.blp": lambda: _pil_bytes(pala, "BLP"),
        "blp1_jpeg.blp": lambda: blp1_jpeg(jpeg, 32, 16, 0),
        "blp1_jpeg_alpha.blp": lambda: blp1_jpeg(jpeg, 32, 16, 8),
        "blp2_dxt1.blp": lambda: dxt(32, 16, 0, 0, 223),
        "blp2_dxt1_alpha.blp": lambda: dxt(32, 16, 0, 1, 224),
        "blp2_dxt3.blp": lambda: dxt(32, 16, 1, 8, 225),
        "blp2_dxt5.blp": lambda: dxt(32, 16, 7, 8, 226),
        "blp2_dxt5_13x10.blp": lambda: dxt(13, 10, 7, 8, 227),
        "blp2_dxt3_no_alpha.blp": lambda: dxt(16, 8, 1, 0, 228),
    }


def _psd_fixtures():
    img = poster(32, 24, 231).transpose(2, 0, 1)
    a = _rng(232).integers(0, 256, (1, 24, 32))
    bits = np.packbits(_rng(233).integers(0, 2, (24, 37)), axis=1)[None]
    pal = _rng(234).integers(0, 256, 768).astype(np.uint8).tobytes()
    return {
        "rgb_raw.psd": lambda: psd_file(img, 3, 8, 0),
        "rgb_packbits_layers.psd": lambda: psd_file(img, 3, 8, 1,
                                                    layers=True),
        "rgba_packbits.psd": lambda: psd_file(np.concatenate([img, a]), 3,
                                              8, 1),
        "cmyk_packbits.psd": lambda: psd_file(np.concatenate([img, a]), 4,
                                              8, 1),
        "grey_raw.psd": lambda: psd_file(img[:1], 1, 8, 0),
        "palette.psd": lambda: psd_file(img[:1], 2, 8, 1, pal),
        "bitmap.psd": lambda: psd_file(bits, 0, 1, 1),
        "extra_channel.psd": lambda: psd_file(np.concatenate([img[:1], a]),
                                              1, 8, 0),
    }


def _icns_fixtures():
    img = poster(32, 32, 241)
    mask = _rng(242).integers(0, 256, (32, 32)).astype(np.uint8)
    small = np.ascontiguousarray(img[::2, ::2])
    png = _pil_bytes(Image.fromarray(np.dstack([poster(64, 64, 243),
                                                mask.repeat(2, 0).repeat(
                                                    2, 1)])), "PNG")
    return {
        "rle_mask.icns": lambda: icns_file([(b"il32", icns_rle(img)),
                                            (b"l8mk", mask.tobytes())]),
        "raw_no_mask.icns": lambda: icns_file([(b"is32", small.tobytes())]),
        "two_sizes.icns": lambda: icns_file([
            (b"is32", icns_rle(small)), (b"s8mk", mask[::2, ::2].tobytes()),
            (b"il32", icns_rle(img))]),
        "png_entry.icns": lambda: icns_file([(b"il32", icns_rle(img)),
                                             (b"icp6", png)]),
    }


def _im_fixtures():
    img = _image(23, 17, 251)
    pim = Image.fromarray(img)
    rng = _rng(252)
    f = ((img[..., 0].astype(np.float32) - 90) * 1.75)
    i32 = rng.integers(-2 ** 31, 2 ** 31, (17, 23)).astype(np.int32)
    raw = rng.integers(0, 256, 23 * 17 * 8).astype(np.uint8).tobytes()
    lut = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    return {
        "rgb.im": lambda: _pil_bytes(pim, "IM"),
        "rgba.im": lambda: _pil_bytes(pim.convert("RGBA"), "IM"),
        "l.im": lambda: _pil_bytes(pim.convert("L"), "IM"),
        "la.im": lambda: _pil_bytes(pim.convert("LA"), "IM"),
        "bits.im": lambda: _pil_bytes(pim.convert("1"), "IM"),
        "palette.im": lambda: _pil_bytes(pim.quantize(30), "IM"),
        "cmyk.im": lambda: _pil_bytes(pim.convert("CMYK"), "IM"),
        "ycc.im": lambda: _pil_bytes(pim.convert("YCbCr"), "IM"),
        "int32.im": lambda: _pil_bytes(Image.fromarray(i32, "I"), "IM"),
        "float.im": lambda: _pil_bytes(Image.fromarray(f, "F"), "IM"),
        "i16b.im": lambda: im_file("L 16B image", 23, 17, raw),
        "f16s.im": lambda: im_file("L 16S image", 23, 17, raw),
        "bits12.im": lambda: im_file("L*12 image", 23, 17, raw),
        "rgb3.im": lambda: im_file("RGB3 image", 23, 17, raw),
        "b4_lut.im": lambda: im_file("B4 image", 23, 17, raw, lut),
        "pa_lut.im": lambda: im_file("LA image", 23, 17, raw, lut),
        "rgbx.im": lambda: im_file("RGBX image", 23, 17, raw),
        "imt.imt": lambda: imt_file(img[..., 1]),
    }


def _sci_fixtures():
    rng = _rng(261)
    f = (rng.standard_normal((19, 27)) * 80 + 100).astype(np.float32)
    spi = _pil_bytes(Image.fromarray(f, "F"), "SPIDER")
    n = len(spi) - 4 * f.size
    le = np.frombuffer(spi[:n], ">f4").astype("<f4").tobytes() + \
        f.astype("<f4").tobytes()
    u8 = _image(27, 19, 262)[..., 0]
    i16 = rng.integers(-300, 3000, (19, 27))
    i32 = rng.integers(-2 ** 31, 2 ** 31, (19, 27))

    def fits(bp, arr):
        return fits_file([("SIMPLE", "T"), ("BITPIX", bp), ("NAXIS", 2),
                          ("NAXIS1", 27), ("NAXIS2", 19)], arr.tobytes())

    return {
        "be.spider": lambda: spi,
        "le.spider": lambda: le,
        "u8.fits": lambda: fits(8, u8.astype(">u1")),
        "i16.fits": lambda: fits(16, i16.astype(">i2")),
        "i32.fits": lambda: fits(32, i32.astype(">i4")),
        "f32_le.fits": lambda: fits(-32, f.astype("<f4")),
        "f64.fits": lambda: fits(-64, f.astype(">f8")),
        "gzip_u8.fits": lambda: fits_gzip(u8.astype(np.int64), 8),
        "gzip_i16.fits": lambda: fits_gzip(i16, 16),
        "gzip_i32.fits": lambda: fits_gzip(i32, 32),
    }


def _xpm_fixtures():
    rng = _rng(271)
    cols = [int(c) for c in rng.integers(0, 1 << 24, 20)]
    cols300 = [int(c) for c in rng.integers(0, 1 << 24, 300)]
    return {
        "cpp1.xpm": lambda: xpm_file(rng.integers(0, 20, (17, 21)), cols, 1),
        "cpp2.xpm": lambda: xpm_file(_rng(272).integers(0, 20, (17, 21)),
                                     cols, 2),
        "rgb300.xpm": lambda: xpm_file(_rng(273).integers(0, 300, (17, 21)),
                                       cols300, 2),
        "none.xpm": lambda: xpm_file(_rng(274).integers(0, 5, (9, 11)),
                                     cols[:5] + [None], 2),
    }


def _fli_fixtures():
    w, h = 30, 22
    img = np.repeat(_rng(281).integers(0, 60, (h, 8)), 4, 1)[:, :w].astype(
        np.uint8)
    pal = _rng(282).integers(0, 256, (60, 3))
    pal64 = _rng(283).integers(0, 64, (60, 3))
    return {
        "brun.fli": lambda: fli_file(w, h, [fli_color(pal), fli_brun(img)],
                                     0xAF11),
        "copy_color64.flc": lambda: fli_file(w, h, [
            fli_color(pal64, 11, 3), fli_chunk(16, img.tobytes())]),
        "copy_lc.flc": lambda: fli_file(w, h, [
            fli_color(pal), fli_chunk(16, img.tobytes()),
            fli_lc(img[3:9, ::-1].copy(), 3)]),
        "black_ss2.flc": lambda: fli_file(w, h, [
            fli_color(pal), fli_chunk(16, img.tobytes()), fli_chunk(13, b""),
            fli_ss2(img, 2, last=17)]),
        "grey_brun.fli": lambda: fli_file(w, h, [fli_brun(img)]),
    }


def _sun_fixtures():
    img = poster(28, 20, 291)
    rng = _rng(292)
    idx4 = rng.integers(0, 16, (20, 28))
    idx8 = np.repeat(rng.integers(0, 200, (20, 7)), 4, 1)
    bits = rng.integers(0, 2, (20, 29))
    cmap = rng.integers(0, 256, 3 * 200).astype(np.uint8).tobytes()
    cmap16 = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    bgr = img[..., ::-1]
    bgrx = np.concatenate([bgr, np.zeros((20, 28, 1), np.uint8)], -1)
    rgbx = np.concatenate([img, np.zeros((20, 28, 1), np.uint8)], -1)
    return {
        "d1.ras": lambda: sun_file(29, 20, 1, 1, sun_rows(bits, 1, False)),
        "d1_rle.ras": lambda: sun_file(29, 20, 1, 2, sun_rows(bits, 1, True)),
        "d4_grey.ras": lambda: sun_file(28, 20, 4, 1,
                                        sun_rows(idx4, 4, False)),
        "d4_cmap_rle.ras": lambda: sun_file(28, 20, 4, 2,
                                            sun_rows(idx4, 4, True), cmap16),
        "d8_cmap.ras": lambda: sun_file(28, 20, 8, 1,
                                        sun_rows(idx8, 8, False), cmap),
        "d8_rle.ras": lambda: sun_file(28, 20, 8, 2, sun_rows(idx8, 8, True)),
        "d24_bgr_rle.ras": lambda: sun_file(28, 20, 24, 2,
                                            sun_rows(bgr, 24, True)),
        "d24_rgb.ras": lambda: sun_file(28, 20, 24, 3,
                                        sun_rows(img, 24, False)),
        "d32_bgrx.ras": lambda: sun_file(28, 20, 32, 1,
                                         sun_rows(bgrx, 32, False)),
        "d32_rgbx.ras": lambda: sun_file(28, 20, 32, 3,
                                             sun_rows(rgbx, 32, False)),
    }


def _dcx_fixtures():
    img = _image(25, 18, 301)
    pim = Image.fromarray(img)
    return {
        "rgb_two_pages.dcx": lambda: dcx_file([
            _pil_bytes(pim, "PCX"), _pil_bytes(pim.convert("L"), "PCX")]),
        "palette.dcx": lambda: dcx_file([_pil_bytes(pim.quantize(40),
                                                    "PCX")]),
        "mono.dcx": lambda: dcx_file([_pil_bytes(pim.convert("1"), "PCX")]),
    }


def _pcd_fixtures():
    y = np.repeat(np.repeat(_rng(311).integers(0, 256, (16, 24)), 32, 0), 32,
                  1)
    c = np.repeat(np.repeat(_rng(312).integers(60, 200, (2, 8, 12)), 32, 1),
                  32, 2)
    return {"rot90.pcd": lambda: pcd_file((y, c[0], c[1]), 1)}


def _small_fixtures():
    img = _image(26, 18, 321)
    rng = _rng(322)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2])])
    grey = img[..., 0]
    return {
        "brush_grey.gbr": lambda: gbr_file(grey, 2),
        "brush_rgba_v1.gbr": lambda: gbr_file(rgba, 1),
        "u8.mcidas": lambda: mcidas_file(grey, 1),
        "u16.mcidas": lambda: mcidas_file(rng.integers(0, 65536, (18, 26)),
                                          2),
        "i32.mcidas": lambda: mcidas_file(_rng(323).integers(
            -2 ** 31, 2 ** 31, (18, 26)), 4),
        "rgb.pxr": lambda: pixar_file(img),
        "thumb.xv": lambda: xv_file(_rng(324).integers(0, 256, (18, 26))),
        "grey.iim": lambda: iptc_file(26, 18, 1, 0, None, grey.tobytes()),
        "one_band_rgb.iim": lambda: iptc_file(26, 18, 3, 1, 2,
                                              img[..., 2].tobytes()),
    }


def _restore_fixtures():
    """The restore folder: 256x256 files that only the new readers decode,
    under the dataset's extensions."""
    p = [poster(256, 256, 330 + k) for k in range(8)]
    rgba0 = np.dstack([p[1], np.full((256, 256), 255, np.uint8)])
    quant = Image.fromarray(p[6]).quantize(256)
    grey = p[7][..., 1].astype(np.float32) + 0.5
    return {
        "psd_packbits.png": lambda: psd_file(p[0].transpose(2, 0, 1), 3, 8,
                                             1),
        "dds_bc7.jpg": lambda: dds_blocks(256, 256, bc7_mode6(rgba0),
                                          dxgi=98),
        "dds_dxt1.bmp": lambda: _pil_bytes(Image.fromarray(p[2]), "DDS",
                                           pixel_format="DXT1"),
        "blp2_palette.webp": lambda: _pil_bytes(Image.fromarray(
            p[3]).quantize(256), "BLP"),
        "im_rgb.ppm": lambda: _pil_bytes(Image.fromarray(p[4]), "IM"),
        "sun_rle.jpeg": lambda: sun_file(256, 256, 24, 2, sun_rows(
            p[5][..., ::-1], 24, True)),
        "fli_brun.png": lambda: fli_file(256, 256, [
            fli_color(np.asarray(quant.getpalette(), np.uint8).reshape(
                -1, 3)[:256]), fli_brun(np.asarray(quant))]),
        "fits_f32.jpg": lambda: fits_file([
            ("SIMPLE", "T"), ("BITPIX", -32), ("NAXIS", 2), ("NAXIS1", 256),
            ("NAXIS2", 256)], grey[::-1].astype("<f4").tobytes()),
    }


FIXTURE_SETS = {"dds": _dds_fixtures, "blp": _blp_fixtures,
                "psd": _psd_fixtures, "icns": _icns_fixtures,
                "im": _im_fixtures, "sci": _sci_fixtures,
                "xpm": _xpm_fixtures, "fli": _fli_fixtures,
                "sun": _sun_fixtures, "dcx": _dcx_fixtures,
                "pcd": _pcd_fixtures, "small": _small_fixtures,
                "restore17": _restore_fixtures}
# --image in chip_smoke's phase 16: a 256x256 PackBits PSD
IMAGE_PSD = ("psd", "restore_256.psd", lambda: psd_file(
    poster(256, 256, 340).transpose(2, 0, 1), 3, 8, 1))


def pil_png_name(name: str) -> str:
    return os.path.splitext(name)[0] + "_pil.png"


def pil_npy_name(name: str) -> str:
    return os.path.splitext(name)[0] + "_pil.npy"


def _items(sub):
    items = list(FIXTURE_SETS[sub]().items())
    if sub == IMAGE_PSD[0]:
        items.append(IMAGE_PSD[1:])
    return items


def make_fixtures(root: str) -> None:
    """Write each fixture under root/<set>/, PIL's convert("RGBA") of it
    beside it as `<stem>_pil.png` and, for the modes PNG cannot hold, its
    pixels as `<stem>_pil.npy`."""
    for sub in FIXTURE_SETS:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        stems = [os.path.splitext(n)[0] for n, _ in _items(sub)]
        assert len(set(stems)) == len(stems), sub
        for name, make in _items(sub):
            data = make()
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(data)
            im = _pil_open(data)
            Image.fromarray(np.asarray(im.convert("RGBA"))).save(
                os.path.join(root, sub, pil_png_name(name)))
            if im.mode in NPY_MODES:
                np.save(os.path.join(root, sub, pil_npy_name(name)),
                        _native(im))


def _all_fixtures():
    return [(sub, n) for sub in FIXTURE_SETS for n, _ in _items(sub)]


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
    npy = os.path.join(DATA, sub, pil_npy_name(name))
    assert os.path.exists(npy) == (im.mode in NPY_MODES), name
    if im.mode in NPY_MODES:
        np.testing.assert_array_equal(got.pixels, np.load(npy))


def test_fixtures_are_what_make_fixtures_writes(tmp_path):
    make_fixtures(str(tmp_path))
    for sub in FIXTURE_SETS:
        assert sorted(os.listdir(tmp_path / sub)) == sorted(
            n for n in os.listdir(os.path.join(DATA, sub))), sub
    for sub, name in _all_fixtures():
        for n in (name, pil_png_name(name), pil_npy_name(name)):
            committed = os.path.join(DATA, sub, n)
            if not os.path.exists(committed):
                continue
            made = str(tmp_path / sub / n)
            if n.endswith("_pil.png"):
                np.testing.assert_array_equal(tio.load_png(committed),
                                              tio.load_png(made))
            else:
                assert open(committed, "rb").read() == open(made,
                                                            "rb").read(), n


def test_plugin_walk_is_pils_image_id():
    # Image.ID in a fresh interpreter, as `Image.open` first fills it: the
    # preinit plugins, then the rest as Image.init imports them
    out = subprocess.run(
        [sys.executable, "-c", "from PIL import Image; Image.preinit(); "
         "Image.init(); print(' '.join(Image.ID))"],
        capture_output=True, text=True, check=True).stdout.split()
    names = [n for n, _, _ in tio._PLUGINS]
    assert [("PPM" if n == "PNM" else n).upper() for n in names] == out


@pytest.mark.parametrize("n,fmt,size,mode_bits", [
    (1, "", 8, None), (2, "", 16, None), (3, "", 16, None), (4, "", 8, None),
    (5, "", 16, None), (5, "BC5S", 16, None), (6, "", 16, 6),
    (6, "BC6HS", 16, 6), (7, "", 16, 7)])
def test_bcn_blocks_match_pil(n, fmt, size, mode_bits):
    # 600 random blocks (BC6H: every mode code, the reserved ones too; BC7:
    # every mode and the reserved first byte), a ragged edge
    body = random_blocks(600, size, 400 + n, mode_bits)
    w, h = 4 * 30 - 3, 4 * 20 - 2
    if n in (6, 7) or fmt:
        dxgi = {(5, "BC5S"): 84, (6, ""): 95, (6, "BC6HS"): 96,
                (7, ""): 98}[(n, fmt)]
        data = dds_blocks(w, h, body, dxgi=dxgi)
    else:
        data = dds_blocks(w, h, body, [b"DXT1", b"DXT3", b"DXT5", b"BC4U",
                                       b"BC5U"][n - 1])
    got = tbcn.decode(data, w, h, n, fmt, len(data) - len(body))
    want = np.asarray(_pil_open(data))
    np.testing.assert_array_equal(got[..., 0] if n == 4 else got, want)


def test_bc7_encoder_round_trip_is_close():
    # the fixtures' BC7 encoder is a real one (mode 6): the decode is near
    # the image it encodes
    img = np.dstack([poster(32, 32, 9), np.full((32, 32), 255, np.uint8)])
    got = tbcn.decode(bc7_mode6(img), 32, 32, 7)
    assert np.abs(got.astype(int) - img).max() <= 12


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("depth", [0, 1, 4, 8])
def test_blp_palette_alpha_depths_read_as_pil(version, depth):
    # the alpha plane after the indices (depth bits a pixel, counted in the
    # mipmap's length): PIL reads the mipmap's bytes through the palette
    # and keeps the palette's alpha, whatever the depth
    img = Image.fromarray(np.dstack([_image(16, 8, 5), _rng(6).integers(
        0, 256, (8, 16))]).astype(np.uint8)).quantize(
            20, method=Image.Quantize.FASTOCTREE)
    data = bytearray(_pil_bytes(img, "BLP", blp_version=version))
    plane = _rng(7).integers(0, 256, -(-16 * 8 * depth // 8)).astype(
        np.uint8).tobytes()
    if version == "BLP1":
        struct.pack_into("<I", data, 8, depth)
        struct.pack_into("<I", data, 28 + 64, 16 * 8 + len(plane))
    else:
        data[9] = depth
        struct.pack_into("<I", data, 20 + 64, 16 * 8 + len(plane))
    got, im = assert_reads_as_pil(bytes(data) + plane, version)
    assert im.mode == ("RGBA" if depth else "RGB")


@pytest.mark.parametrize("kind", ["YCbCr", "PhotoYCC"])
def test_colour_tables_match_pil(kind):
    # every (Cb, Cr) pair at 17 luma levels, ends included, against PIL's
    # YCbCr -> RGB and its "YCC;P" (PCD) unpacker
    from pointdreamer_tpu_torch import pcd as tpcd

    y, cb, cr = np.meshgrid(np.r_[0:256:16, 255], np.arange(256),
                            np.arange(256), indexing="ij")
    ycc = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(-1, 4096, 3)
    if kind == "YCbCr":
        want = Image.frombytes("YCbCr", (4096, len(ycc)), ycc.tobytes()
                               ).convert("RGB")
        got = tmode.ycbcr_to_rgb(ycc)
    else:
        want = Image.frombytes("RGB", (4096, len(ycc)), ycc.tobytes(),
                               "raw", "YCC;P")
        got = tpcd.ycc_to_rgb(*(ycc[..., k].astype(np.int64)
                                for k in range(3)))
    np.testing.assert_array_equal(got, np.asarray(want))


def _tga(ident=b"", w=6, h=5, cmap=None, kind=2, start=0):
    """A top-down TGA of seeded pixels: 24-bit, or indices into a 24-bit
    colour map (`cmap`: RGB bytes) at `start`."""
    rng = _rng(len(ident) + w)
    if cmap is None:
        return tga_file(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                        kind, 24, ident=ident)
    entries = np.frombuffer(cmap, np.uint8).reshape(-1, 3)
    idx = rng.integers(0, len(entries), (h, w, 1)).astype(np.uint8)
    return tga_file(idx + start % 256, kind, 8, cmap=entries, start=start,
                    ident=ident)


def _collisions():
    """name -> bytes: files an accept-less plugin (IM, IMT, IPTC, PCD,
    SPIDER) looks at before TGA, and files that fall through a plugin's
    header checks."""
    im_ident = (b"ame: x\r\nImage size (x*y): 3*2\r\nImage type: RGB image\r\n"
                b"\x1a")
    tga_im = _tga(im_ident.ljust(ord("N"), b"\0"))
    big = _tga(w=40, h=40)
    pcx = bytearray(128)
    pcx[0:4] = bytes((10, 5, 1, 8))
    struct.pack_into("<4H", pcx, 4, 5, 0, 0, 3)
    pcd = bytearray(big + bytes(96 * 2048 + 3 * 768 * 256 - len(big)))
    pcd[2048:2052] = b"PCD_"
    return {
        # IM takes a TGA whose id field is an IM header
        "tga_as_im": tga_im,
        # a line feed in the first 100 bytes: IM's and IMT's parsers reject
        "tga_newline": _tga(b"a\nb: c"),
        # 0x1C first: IPTC reads a 1:1 field, fails on the next, TGA takes
        # the file
        "tga_iptc_fields": _tga(b"\x1c" * 0x1C, cmap=bytes(range(48)),
                                kind=1),
        # a TGA long enough to be tried as a SPIDER header and rejected
        "tga_spider_sized": big,
        # "PCD_" at 2048: PCD takes it before TGA
        "tga_as_pcd": bytes(pcd),
        # PSD at 16 bits: PIL has no mode, goes on (and nothing takes it)
        "psd_16bit": psd_file(np.zeros((3, 2, 4)), 3, 16, 0),
        # a PCX whose box is empty falls through, TGA is not it either
        "pcx_empty_box": bytes(pcx),
        # FITS without NAXIS: a KeyError, PIL goes on
        "fits_no_naxis": fits_file([("SIMPLE", "T"), ("BITPIX", 8)],
                                   bytes(16)),
        # ICNS whose size runs past the file: struct.error, PIL goes on
        "icns_truncated": b"icns" + struct.pack(">I", 100) + b"is32",
        # a DCX with an empty directory
        "dcx_empty": struct.pack("<II", 0x3ADE68B1, 0),
        # an XV thumbnail and an XPM without their size lines
        "xpm_no_header": b"/* XPM */\nstatic char *x[] = {\n};\n",
        # SUN at an unsupported depth
        "sun_depth_16": struct.pack(">8I", 0x59A66A95, 2, 2, 16, 8, 1, 0, 0)
        + bytes(8),
        # GBR of zero width
        "gbr_zero_width": struct.pack(">5I", 20, 1, 0, 3, 1),
        # FLI with a non-zero reserved header field
        "fli_bad_reserved": fli_file(4, 2, [fli_chunk(13, b"")])[:20]
        + b"\1\1" + fli_file(4, 2, [fli_chunk(13, b"")])[22:],
    }


@pytest.mark.parametrize("name", list(_collisions()))
def test_crafted_collision_takes_pils_plugin(name):
    data = _collisions()[name]
    try:
        im = _pil_open(data)
    except Exception as e:
        pil = e
    else:
        pil = None
    kind = tio.image_type(data)
    if pil is None:
        assert ("PPM" if kind == "PNM" else kind) == im.format, (name, kind)
        got = tio.decode_image(data, name)
        np.testing.assert_array_equal(tmode.to_rgba(got),
                                      np.asarray(im.convert("RGBA")))
        return
    with pytest.raises(Exception):
        tio.decode_image(data, name + ".bin")


def test_iptc_long_field_raises_where_pil_raises():
    # a TGA beginning 0x1C, tag 1:1 and a length byte above 132: PIL's
    # IPTC plugin raises OSError instead of going on to TGA
    data = _tga(b"\x1c" * 0x1C, cmap=bytes(range(48)), kind=1, start=0x87)
    assert data[:4] == b"\x1c\x01\x01\x87"
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data))
    assert tio.image_type(data) == "IPTC"
    with pytest.raises(OSError):
        tio.decode_image(data)


def _refusals():
    img = Image.fromarray(_image(32, 32, 99))
    return {
        "JPEG2000": lambda: _pil_bytes(img, "JPEG2000"),
        "JPEG2000_codestream": lambda: _pil_bytes(img, "JPEG2000",
                                                  no_jp2=True),
        "AVIF": lambda: _pil_bytes(img, "AVIF", quality=60),
        "EPS": lambda: _pil_bytes(img, "EPS"),
        "MPEG": lambda: b"\x00\x00\x01\xb3" + bytes((0x02, 0x00, 0x18)) +
        bytes(20),
        "WMF": lambda: (b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack(
            "<4hH", 0, 0, 400, 300, 1440) + bytes(6) + b"\x01\x00\t\x00"
            + bytes(18)),
        "EMF": lambda: (b"\x01\x00\x00\x00" + bytes(4) + struct.pack(
            "<8i", 0, 0, 100, 80, 0, 0, 2000, 1600) + b" EMF" + bytes(8)),
        "BUFR": lambda: b"BUFR" + bytes(40),
        "GRIB": lambda: b"GRIB\0\0\0\x01" + bytes(40),
        "HDF5": lambda: b"\x89HDF\r\n\x1a\n" + bytes(40),
    }


@pytest.mark.parametrize("name", list(_refusals()))
def test_identified_formats_refused_naming_the_type(name):
    # PIL identifies each, and no later plugin of the port takes the file.
    # JPEG 2000 and AVIF the port reads as PIL reads them; PIL decodes
    # none of the rest
    data = _refusals()[name]()
    fmt = Image.open(io.BytesIO(data)).format
    assert tio.image_type(data) == fmt
    if fmt in ("JPEG2000", "AVIF"):
        assert_reads_as_pil(data, name)
    else:
        with pytest.raises(OSError):
            _pil_open(data)
        with pytest.raises(OSError, match=fmt):
            tio.decode_image(data, "a.png")


def test_icns_jpeg2000_entry_raises_naming_it():
    # a JPEG 2000 icon entry reads as PIL reads it (jpeg2000.py, then
    # "RGBA")
    j2k = _pil_bytes(Image.fromarray(_image(64, 64, 98)), "JPEG2000")
    data = icns_file([(b"icp6", j2k)])
    assert _pil_open(data).size == (64, 64)
    assert tio.image_type(data) == "ICNS"
    got, im = assert_reads_as_pil(data, "icns_jpeg2000")
    assert got.mode == im.mode == "RGBA"


def test_restore_folder_batches_match_jax(tmp_path):
    # the slice as a whole: the restore dataset over files only the new
    # readers decode, bit-equal to the JAX package's (PIL's) batches
    from pointdreamer_tpu.models.diffusion import datasets as jds
    from pointdreamer_tpu_torch.models.diffusion import datasets as tds

    src = os.path.join(DATA, "restore17")
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
    assert kinds == ["BLP", "DDS", "DDS", "FITS", "FLI", "IM", "PSD", "SUN"]
