"""PyTorch port, image input by content: `io.load_image` tells formats
apart as PIL's `Image.open` does (a PNG under `.JPEG` reads as PNG), and
reads GIF (`gif.py`) and TIFF (`tiff.py`) bit-equal to PIL 12.1, in each
mode (`imagemode.py`: `load_image`, `load_rgb_uint8`, `load_rgba_uint8`
are PIL's pixels, convert("RGB") and convert("RGBA")).  PIL writes GIFs
and strip TIFFs; the variants it cannot write (local colour tables,
frames off the screen's origin, tiles, planar data, Predictor 2, 16-bit
samples, BigTIFF, associated alpha) come from the small writers here,
and PIL's decode of each is the oracle.  Each variant PIL refuses raises
in the port too, naming the tag or value.  Also the committed fixtures
under tests/data/{gif,tiff,png,timing}/ that `chip_smoke.py` decodes on
the machine without PIL, and the restore CLI over them against the JAX
CLI."""
import hashlib
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import gif as tgif
from pointdreamer_tpu_torch import imagemode as tmode
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import tiff as ttiff

from test_torch_ddnm_restore import STEPS, _same_outputs, tiny_models  # noqa

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TIMING = os.path.join(DATA, "timing")


def _rng(seed):
    return np.random.default_rng(seed)


def _image(w, h, seed):
    """Smooth ramps plus noise, RGB uint8."""
    rng = _rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
    return np.clip(base + rng.integers(0, 55, (h, w, 3)), 0,
                   255).astype(np.uint8)


def poster(w, h, seed):
    """A posterised photo (8 levels a channel, 4 x 4 pixel cells): flat
    regions that LZW packs, as in charts and screenshots."""
    from test_torch_webp import photo

    small = photo(w // 4, h // 4, seed) >> 5 << 5
    return np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.uint8)


def pil_natural(im: Image.Image) -> np.ndarray:
    """What `io.load_image` returns for a PIL image: its pixels, grey as
    [H, W, 1], a palette expanded (RGBA when it has a transparent index),
    a transparent grey level as alpha, CMYK as RGB, premultiplied alpha
    undone, 16-bit grey clipped."""
    m = im.mode
    trans = im.info.get("transparency")
    if m == "P":
        return np.asarray(im.convert("RGBA" if trans is not None else "RGB"))
    if m == "L" and trans is not None:
        return np.asarray(im.convert("LA"))
    if m in ("1", "L") or m.startswith("I;16"):
        return np.asarray(im.convert("L"))[..., None]
    if m == "CMYK":
        return np.asarray(im.convert("RGB"))
    if m == "RGBa":
        return np.asarray(im.convert("RGBA"))
    return np.asarray(im)


def _write(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def assert_reads_as_pil(path):
    """load_image, load_rgb_uint8 and load_rgba_uint8 of the file equal
    PIL's natural pixels, convert("RGB") and convert("RGBA")."""
    im = Image.open(path)
    im.load()
    np.testing.assert_array_equal(tio.load_image(path), pil_natural(im))
    np.testing.assert_array_equal(tio.load_rgb_uint8(path),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(tio.load_rgba_uint8(path),
                                  np.asarray(im.convert("RGBA")))
    return im


# ---------------------------------------------------------------------------
# a GIF writer: one frame, LZW codes of the indices


def gif_lzw(idx: bytes, min_bits: int, clear_every=None) -> bytes:
    """GIF LZW (LSB-first codes), a clear code first and when the table is
    full (or every `clear_every` codes)."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
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

    size = min_bits + 1
    table = {bytes((i,)): i for i in range(clear)}
    nxt = end + 1
    put(clear, size)
    cur = b""
    emitted = 0
    for b in idx:
        s = cur + bytes((b,))
        if s in table:
            cur = s
            continue
        put(table[cur], size)
        emitted += 1
        if nxt < 4096 and not (clear_every and emitted % clear_every == 0):
            table[s] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            put(clear, size)
            table = {bytes((i,)): i for i in range(clear)}
            nxt = end + 1
            size = min_bits + 1
        cur = bytes((b,))
    if cur:
        put(table[cur], size)
    put(end, size)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_file(frame, palette, screen=None, offset=(0, 0), local=False,
             interlace=False, transparency=None, min_bits=None,
             version=b"GIF89a", clear_every=None):
    """A one-frame GIF of indices `frame` [h, w] with `palette` [n, 3]
    (n a power of two) as the global or local colour table."""
    h, w = frame.shape
    sw, sh = screen or (w, h)
    n = len(palette)
    bits = max(1, (n - 1).bit_length())
    pal = np.zeros((1 << bits, 3), np.uint8)
    pal[:n] = palette
    out = bytearray(version + struct.pack("<HH", sw, sh))
    out += bytes(((0x80 | (bits - 1)) if not local else 0, 0, 0))
    if not local:
        out += pal.tobytes()
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes((1, 0, 0, transparency, 0))
    out += b"\x2c" + struct.pack("<HHHH", offset[0], offset[1], w, h)
    flags = (0x40 if interlace else 0) | ((0x80 | (bits - 1)) if local else 0)
    out.append(flags)
    if local:
        out += pal.tobytes()
    rows = np.arange(h)
    if interlace:
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])
    mb = min_bits or max(2, bits)
    data = gif_lzw(frame[rows].astype(np.uint8).tobytes(), mb, clear_every)
    out.append(mb)
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes((len(chunk),)) + chunk
    out += b"\x00\x3b"
    return bytes(out)


# ---------------------------------------------------------------------------
# a TIFF writer: one page of samples, strips or tiles, the four codecs


def packbits(raw: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        j = i
        while j + 1 < n and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes((257 - (j - i + 1), raw[i]))
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and (j + 1 >= n or raw[j + 1] != raw[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes((j - i - 1,)) + raw[i:j]
        i = j
    return bytes(out)


def tiff_lzw(raw: bytes) -> bytes:
    """TIFF LZW: MSB-first codes, clear first, the code width one code
    early, a clear before the table passes 4094."""
    out = bytearray()
    acc = nacc = 0

    def put(code, size):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

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
        elif nxt > (1 << size) - 1:
            size += 1
        cur = bytes((b,))
    if cur:
        put(table[cur], size)
        nxt += 1
        if nxt > (1 << size) - 1 and size < 12:
            size += 1
    put(257, size)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _pack_rows(samples, bits, order):
    """samples [rows, width, spp] -> bytes, rows padded to whole bytes."""
    rows, width, spp = samples.shape
    if bits == 16:
        return samples.astype(order + "u2").tobytes()
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    flat = samples.reshape(rows, width * spp).astype(np.uint8)
    bitarr = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
    bitarr = bitarr.reshape(rows, -1)
    return np.packbits(bitarr, axis=1).tobytes()


def tiff_file(samples, photometric, bits, order="<", big=False, extra=(),
              planar=1, tile=None, rows_per_strip=None, compression=1,
              predictor=1, colormap=None, extra_tags=None, encode=None,
              sample_dtype=None):
    """A one-page TIFF of samples [H, W, spp] (ints; or of `sample_dtype`,
    such as "i4" or "f4", packed in the file's byte order), each chunk
    compressed by `encode` where given."""
    H, W, spp = samples.shape
    enc = encode or {1: lambda b: b, 32773: packbits, 5: tiff_lzw,
                     8: lambda b: zlib.compress(b),
                     32946: lambda b: zlib.compress(b)}[compression]

    def chunk_bytes(s):
        if sample_dtype is not None:
            return enc(s.astype(order + sample_dtype).tobytes())
        s = s.astype(np.int64)
        if predictor == 2:
            dt = np.uint16 if bits == 16 else np.uint8
            d = s.copy()
            d[:, 1:] = s[:, 1:] - s[:, :-1]
            s = d.astype(dt).astype(np.int64)
        return enc(_pack_rows(s, bits, order))

    planes = [samples[..., p:p + 1] for p in range(spp)] if planar == 2 \
        else [samples]
    chunks = []
    if tile:
        tw, th = tile
        for pl in planes:
            for ty in range(0, H, th):
                for tx in range(0, W, tw):
                    t = np.zeros((th, tw, pl.shape[2]), np.int64)
                    part = pl[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(chunk_bytes(t))
    else:
        rps = rows_per_strip or H
        for pl in planes:
            for y in range(0, H, rps):
                chunks.append(chunk_bytes(pl[y:y + rps]))
    body = b"".join(chunks)
    offsets, o = [], 0
    for c in chunks:
        offsets.append(o)
        o += len(c)
    tags = {256: (4, [W]), 257: (4, [H]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    if tile:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
        off_tag, cnt_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or H])
        off_tag, cnt_tag = 273, 279
    tags.update(extra_tags or {})
    head = 16 if big else 8
    data_off = head
    tags[off_tag] = (16 if big else 4, [data_off + x for x in offsets])
    tags[cnt_tag] = (16 if big else 4, [len(c) for c in chunks])
    ifd_off = data_off + len(body)
    ifd_off += ifd_off & 1
    fmts = {3: "H", 4: "I", 16: "Q"}
    entry = 20 if big else 12
    n = len(tags)
    ext_off = ifd_off + (8 if big else 2) + n * entry + (8 if big else 4)
    ifd = bytearray(struct.pack(order + ("Q" if big else "H"), n))
    ext = bytearray()
    field = 8 if big else 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(f"{order}{len(vals)}{fmts[typ]}", *vals)
        if big:
            ifd += struct.pack(order + "HHQ", tag, typ, len(vals))
        else:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals))
        if len(raw) <= field:
            ifd += raw + bytes(field - len(raw))
        else:
            ifd += struct.pack(order + ("Q" if big else "I"),
                               ext_off + len(ext))
            ext += raw + bytes(len(raw) & 1)
    ifd += bytes(8 if big else 4)
    bo = b"II" if order == "<" else b"MM"
    if big:
        header = bo + struct.pack(order + "HHHQ", 43, 8, 0, ifd_off)
    else:
        header = bo + struct.pack(order + "HI", 42, ifd_off)
    out = header + body + bytes(ifd_off - data_off - len(body)) + ifd + ext
    return bytes(out)


def _pil_bytes(img, fmt, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def _grey_ramp(n):
    return np.repeat(np.arange(n)[:, None], 3, 1).astype(np.uint8)


# ---------------------------------------------------------------------------
# fixtures: name -> bytes (their PIL decodes are stored beside them as PNG)

def _gif_fixtures():
    rng = _rng(7)
    fr = rng.integers(0, 16, (23, 31)).astype(np.uint8)
    pal = rng.integers(0, 255, (16, 3)).astype(np.uint8)
    return {
        "pil_photo.gif": lambda: _pil_bytes(Image.fromarray(
            _image(48, 40, 1)), "GIF"),
        "pil_transparent.gif": lambda: _pil_bytes(Image.fromarray(
            _image(40, 30, 2)).quantize(16), "GIF", transparency=3,
            interlace=False),
        "local_offset.gif": lambda: gif_file(
            fr, pal, screen=(50, 40), offset=(7, 5), local=True,
            interlace=True, transparency=5),
        "grey_ramp.gif": lambda: gif_file(fr, _grey_ramp(16)),
        "restore_256.gif": lambda: _pil_bytes(Image.fromarray(
            poster(256, 256, 11)), "GIF"),
    }


def _tiff_fixtures():
    img = _image(48, 40, 3).astype(np.int64)
    s16 = img * 257 + _rng(4).integers(0, 256, img.shape)
    a = _rng(5).integers(0, 256, img.shape[:2] + (1,))
    a[0, :6], a[1, :6] = 0, 255
    assoc = np.concatenate([img * a // 255, a], -1)
    cmap = list(_rng(6).integers(0, 65536, 768))
    pil = Image.fromarray(_image(48, 40, 8))
    return {
        "pil_raw.tif": lambda: _pil_bytes(pil, "TIFF", compression="raw"),
        "pil_packbits.tif": lambda: _pil_bytes(pil, "TIFF",
                                               compression="packbits"),
        "pil_lzw.tif": lambda: _pil_bytes(pil, "TIFF",
                                          compression="tiff_lzw"),
        "pil_deflate.tif": lambda: _pil_bytes(
            pil, "TIFF", compression="tiff_adobe_deflate"),
        "tiles_lzw_be.tif": lambda: tiff_file(img, 2, 8, ">", tile=(16, 16),
                                              compression=5),
        "planar_deflate.tif": lambda: tiff_file(
            img, 2, 8, planar=2, rows_per_strip=16, compression=32946),
        "pred16_lzw.tif": lambda: tiff_file(s16, 2, 16, predictor=2,
                                            rows_per_strip=10, compression=5),
        "grey16_be.tif": lambda: tiff_file(s16[..., :1] >> 4, 1, 16, ">",
                                           compression=8, predictor=2),
        "bigtiff_tiles.tif": lambda: tiff_file(img, 2, 8, big=True,
                                               tile=(32, 16), compression=8),
        "miniswhite_1bit.tif": lambda: tiff_file(
            (img[..., :1] > 120).astype(np.int64), 0, 1, compression=32773),
        "palette_lzw.tif": lambda: tiff_file(img[..., :1], 3, 8,
                                             colormap=cmap, compression=5),
        "assoc_alpha.tif": lambda: tiff_file(assoc, 2, 8, extra=(1,),
                                             compression=32946),
        "restore_256_lzw.tif": lambda: _pil_bytes(Image.fromarray(
            poster(256, 256, 12)), "TIFF", compression="tiff_lzw"),
    }


def _png_fixtures():
    # a PNG under a JPEG name, as the ImageNet training set holds one
    return {"png_named.JPEG": lambda: _pil_bytes(Image.fromarray(
        _image(40, 32, 9)), "PNG")}


FIXTURE_SETS = {"gif": _gif_fixtures, "tiff": _tiff_fixtures,
                "png": _png_fixtures}
TIMING_FIXTURES = {
    "tiff_lzw_512x384.tif": lambda: _pil_bytes(Image.fromarray(
        poster(512, 384, 13)), "TIFF", compression="tiff_lzw"),
    "gif_512x384.gif": lambda: _pil_bytes(Image.fromarray(
        poster(512, 384, 14)), "GIF"),
}


def make_fixtures(root: str, timing_root=None) -> None:
    """Write each fixture under root/{gif,tiff,png}/ and PIL's natural
    decode of it (`pil_natural`) as PNG beside it (`name` with `.png` for
    its extension); with `timing_root`, the 512x384 timing fixtures and
    the SHA-256 of PIL's natural decode."""
    for sub, fixtures in FIXTURE_SETS.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for name, make in fixtures().items():
            data = make()
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(data)
            Image.fromarray(_png_ready(pil_natural(Image.open(
                io.BytesIO(data))))).save(
                os.path.join(root, sub, os.path.splitext(name)[0] + ".png"))
    if timing_root is not None:
        os.makedirs(timing_root, exist_ok=True)
        for name, make in TIMING_FIXTURES.items():
            data = make()
            with open(os.path.join(timing_root, name), "wb") as f:
                f.write(data)
            digest = hashlib.sha256(pil_natural(Image.open(io.BytesIO(
                data))).tobytes()).hexdigest()
            with open(os.path.join(timing_root, os.path.splitext(name)[0]
                                   + ".sha256"), "w") as f:
                f.write(digest + "\n")


def _png_ready(a: np.ndarray):
    return a[..., 0] if a.shape[-1] == 1 else a


# ---------------------------------------------------------------------------
# the fault: a decoder by content, not by extension

def _samples_of_each_format():
    img = _image(20, 12, 5)
    pim = Image.fromarray(img)
    return {
        "PNG": _pil_bytes(pim, "PNG"),
        "JPEG": _pil_bytes(pim, "JPEG", quality=85),
        "GIF": _pil_bytes(pim, "GIF"),
        "TIFF": _pil_bytes(pim, "TIFF", compression="tiff_lzw"),
        "BMP": _pil_bytes(pim, "BMP"),
        "WEBP": _pil_bytes(pim, "WEBP", quality=80),
        "PNM": _pil_bytes(pim, "PPM"),
    }


@pytest.mark.parametrize("fmt", ["PNG", "JPEG", "GIF", "TIFF", "BMP",
                                 "WEBP", "PNM"])
@pytest.mark.parametrize("ext", [".JPEG", ".png", ".gif", ".tif", ".bin",
                                 ""])
def test_decoder_picked_by_content(fmt, ext, tmp_path):
    data = _samples_of_each_format()[fmt]
    assert tio.image_type(data) == fmt
    path = _write(tmp_path, "img" + ext, data)
    assert Image.open(path).format == ("PPM" if fmt == "PNM" else fmt)
    assert_reads_as_pil(path)


def test_png_named_jpeg_reads_as_png(tmp_path):
    # the ImageNet training set's n02105855_2933.JPEG is a PNG; before the
    # port picked decoders by content this raised "not a JPEG"
    path = os.path.join(DATA, "png", "png_named.JPEG")
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    im = assert_reads_as_pil(path)
    assert im.format == "PNG"
    # and a JPEG named .png reads as a JPEG
    jpeg = _samples_of_each_format()["JPEG"]
    assert_reads_as_pil(_write(tmp_path, "photo.png", jpeg))


def test_extension_decides_only_where_content_says_nothing(tmp_path):
    # no signature: the extension's decoder says what is wrong; no
    # signature and no known extension: the file is named
    junk = b"\x00\x01\x02\x03 not an image"
    with pytest.raises(ValueError, match="not a PNG"):
        tio.load_image(_write(tmp_path, "a.png", junk))
    with pytest.raises(ValueError, match="not a GIF"):
        tio.load_image(_write(tmp_path, "a.gif", junk))
    path = _write(tmp_path, "a.xyz", junk)
    with pytest.raises(ValueError, match="a.xyz: unknown image type"):
        tio.load_image(path)
    with pytest.raises(Exception):
        Image.open(path)


# ---------------------------------------------------------------------------
# modes and PIL's conversions

def test_cmyk_conversion_is_pillows():
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, k) for k in
                                  (3, 5, 7, 11)], indexing="ij"),
                    -1).reshape(1, -1, 4).astype(np.uint8)
    im = Image.frombytes("CMYK", (grid.shape[1], 1), grid.tobytes())
    got = tmode.ModeImage("CMYK", grid)
    np.testing.assert_array_equal(tmode.to_rgb(got),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(tmode.to_rgba(got),
                                  np.asarray(im.convert("RGBA")))


@pytest.mark.parametrize("mode", ["RGBa", "I;16", "I;16B", "1", "LA", "L",
                                  "P", "P_trans", "L_trans"])
def test_mode_conversions_are_pils(mode):
    rng = _rng(len(mode))
    h, w = 7, 300
    if mode == "RGBa":
        px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        px[0, :3, 3] = (0, 255, 1)
        im = Image.frombytes("RGBa", (w, h), px.tobytes())
        got = tmode.ModeImage("RGBa", px)
    elif mode.startswith("I;16"):
        px = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        px[0, :4] = (0, 255, 256, 65535)
        dt = "<u2" if mode == "I;16" else ">u2"
        im = Image.frombytes(mode, (w, h), px.astype(dt).tobytes())
        got = tmode.ModeImage("I;16", px)
    elif mode == "1":
        bits = rng.integers(0, 2, (h, w)).astype(np.uint8)
        im = Image.fromarray(bits.astype(bool))
        got = tmode.ModeImage("1", bits * 255)
    elif mode == "LA":
        px = rng.integers(0, 256, (h, w, 2)).astype(np.uint8)
        im = Image.fromarray(px, "LA")
        got = tmode.ModeImage("LA", px)
    elif mode.startswith("L"):
        px = rng.integers(0, 256, (h, w)).astype(np.uint8)
        im = Image.fromarray(px, "L")
        trans = None
        if mode == "L_trans":
            trans = int(px[0, 0])
            im.info["transparency"] = trans
        got = tmode.ModeImage("L", px, None, trans)
    else:
        px = rng.integers(0, 40, (h, w)).astype(np.uint8)
        pal = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        im = Image.fromarray(px, "P")
        im.putpalette(pal.tobytes())
        full = np.zeros((256, 3), np.uint8)
        full[:40] = pal
        trans = 5 if mode == "P_trans" else None
        if trans is not None:
            im.info["transparency"] = trans
        got = tmode.ModeImage("P", px, full, trans)
    np.testing.assert_array_equal(tmode.to_rgb(got),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(tmode.to_rgba(got),
                                  np.asarray(im.convert("RGBA")))
    np.testing.assert_array_equal(tmode.natural(got), pil_natural(im))


def test_pnm_bitmaps_read_as_mode_1(tmp_path):
    bits = _rng(3).integers(0, 2, (9, 13)).astype(bool)
    p4 = _write(tmp_path, "a.pbm", _pil_bytes(Image.fromarray(bits), "PPM"))
    assert open(p4, "rb").read(2) == b"P4"
    assert_reads_as_pil(p4)
    rows = "\n".join("".join("1" if not b else "0" for b in r)
                     for r in bits)
    p1 = _write(tmp_path, "b.pbm", b"P1\n# a comment\n13 9\n"
                + rows.encode())
    im = assert_reads_as_pil(p1)
    assert im.mode == "1"
    np.testing.assert_array_equal(np.asarray(im), bits)
    assert tio.read_image(p1).mode == "1"


# ---------------------------------------------------------------------------
# GIF

def _gif_cases():
    rng = _rng(0)
    fr = rng.integers(0, 16, (23, 31)).astype(np.uint8)
    pal = rng.integers(0, 255, (16, 3)).astype(np.uint8)
    big = rng.integers(0, 256, (200, 150)).astype(np.uint8)
    pal256 = rng.integers(0, 255, (256, 3)).astype(np.uint8)
    two = rng.integers(0, 2, (9, 13)).astype(np.uint8)
    img = _image(45, 37, 1)
    return {
        "pil_rgb": lambda: _pil_bytes(Image.fromarray(img), "GIF"),
        "pil_grey": lambda: _pil_bytes(Image.fromarray(img[..., 0]), "GIF"),
        "pil_transparent": lambda: _pil_bytes(
            Image.fromarray(img).quantize(16), "GIF", transparency=3),
        "pil_not_interlaced": lambda: _pil_bytes(
            Image.fromarray(img).quantize(16), "GIF", interlace=False),
        "global": lambda: gif_file(fr, pal),
        "local_interlaced": lambda: gif_file(fr, pal, local=True,
                                             interlace=True),
        "offset_transparent": lambda: gif_file(
            fr, pal, screen=(50, 40), offset=(7, 5), transparency=5),
        "frame_past_screen": lambda: gif_file(fr, pal, screen=(20, 20),
                                              offset=(3, 4)),
        "grey_ramp": lambda: gif_file(fr, _grey_ramp(16)),
        "grey_ramp_transparent": lambda: gif_file(fr, _grey_ramp(16),
                                                  transparency=2),
        "full_table": lambda: gif_file(big, pal256),
        "clear_codes": lambda: gif_file(big, pal256, clear_every=300),
        "two_colours": lambda: gif_file(
            two, np.array([[0, 0, 0], [255, 255, 255]], np.uint8),
            min_bits=2),
        "interlaced_3_rows": lambda: gif_file(fr[:3], pal, interlace=True),
        "gif87a": lambda: gif_file(fr, pal, version=b"GIF87a"),
    }


@pytest.mark.parametrize("case", list(_gif_cases()))
def test_gif_bit_equal_to_pil(case, tmp_path):
    data = _gif_cases()[case]()
    im = assert_reads_as_pil(_write(tmp_path, "a.gif", data))
    got = tgif.decode_gif(data)
    assert got.mode == im.mode and got.transparency == im.info.get(
        "transparency")
    np.testing.assert_array_equal(got.pixels, np.asarray(im))


def test_truncated_gif_raises_as_pil(tmp_path):
    rng = _rng(3)
    fr = rng.integers(0, 16, (23, 31)).astype(np.uint8)
    pal = rng.integers(0, 255, (16, 3)).astype(np.uint8)
    data = gif_file(fr, pal)
    head = data[:13 + 3 * 16 + 10]           # screen, palette, descriptor
    assert head[-10:-9] == b"\x2c"
    short = gif_lzw(fr.tobytes()[:300], 4)
    data = head + bytes((4, len(short))) + short + b"\x00\x3b"
    with pytest.raises(OSError, match="truncated"):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="300 of the frame's 713"):
        tio.load_image(_write(tmp_path, "a.gif", data))


def test_gif_writer_holds_the_frame():
    # the writer is right, so PIL's reading of it is a fair oracle
    rng = _rng(1)
    fr = rng.integers(0, 16, (23, 31)).astype(np.uint8)
    pal = rng.integers(0, 255, (16, 3)).astype(np.uint8)
    im = Image.open(io.BytesIO(gif_file(fr, pal, screen=(40, 30),
                                        offset=(2, 3), local=True,
                                        interlace=True)))
    np.testing.assert_array_equal(np.asarray(im)[3:26, 2:33], fr)


# ---------------------------------------------------------------------------
# TIFF

def _tiff_cases():
    rng = _rng(2)
    img = _image(45, 37, 3).astype(np.int64)
    s16 = img * 257 + rng.integers(0, 256, img.shape)
    a = rng.integers(0, 256, img.shape[:2] + (1,))
    a[0, :5], a[1, :5] = 0, 255
    pm = np.concatenate([img * a // 255, a], -1)
    cmap = list(rng.integers(0, 65536, 48))
    cases = {}
    for comp in (1, 32773, 5, 8, 32946):
        for order in "<>":
            k = f"{comp}{'le' if order == '<' else 'be'}"
            cases.update({
                f"rgb_strips_{k}": (img, 2, 8, dict(order=order,
                                                    rows_per_strip=7)),
                f"rgb_tiles_{k}": (img, 2, 8, dict(order=order,
                                                   tile=(16, 16))),
                f"rgb_planar_{k}": (img, 2, 8, dict(order=order, planar=2,
                                                    rows_per_strip=10)),
                f"rgb16_pred_{k}": (s16, 2, 16, dict(order=order,
                                                     predictor=2,
                                                     rows_per_strip=5)),
                f"grey16_pred_{k}": (s16[..., :1], 1, 16,
                                     dict(order=order, predictor=2)),
                f"grey8_white_pred_{k}": (img[..., :1], 0, 8,
                                          dict(order=order, predictor=2)),
                f"bit_white_tiles_{k}": ((img[..., :1] > 100).astype(int), 0,
                                         1, dict(order=order, tile=(16, 16))),
                f"grey2_{k}": (img[..., :1] >> 6, 1, 2, dict(order=order)),
                f"palette4_{k}": (img[..., :1] >> 4, 3, 4,
                                  dict(order=order, colormap=cmap)),
                f"assoc_alpha_{k}": (pm, 2, 8, dict(order=order,
                                                    extra=(1,))),
                f"rgba_planar_{k}": (pm, 2, 8, dict(order=order, extra=(2,),
                                                    planar=2)),
                f"rgbx_{k}": (pm, 2, 8, dict(order=order, extra=(0,))),
                f"assoc_alpha16_{k}": (np.concatenate([s16, s16[..., :1]],
                                                      -1), 2, 16,
                                       dict(order=order, extra=(1,))),
                f"la_{k}": (pm[..., [0, 3]], 1, 8, dict(order=order,
                                                        extra=(2,))),
            })
            if comp != 1:
                cases[f"assoc_alpha_planar_{k}"] = (pm, 2, 8, dict(
                    order=order, extra=(1,), planar=2))
            if order == "<":
                cases[f"grey16_white_{k}"] = (s16[..., :1], 0, 16, {})
                cases[f"bigtiff_planar_tiles_{k}"] = (img, 2, 8, dict(
                    planar=2, tile=(16, 32), big=True))
    return cases


@pytest.mark.parametrize("case", list(_tiff_cases()))
def test_tiff_bit_equal_to_pil(case, tmp_path):
    samples, photo, bits, opts = _tiff_cases()[case]
    comp = int(case.rsplit("_", 1)[1][:-2])
    data = tiff_file(samples, photo, bits, compression=comp, **opts)
    im = assert_reads_as_pil(_write(tmp_path, "a.tif", data))
    got = ttiff.decode_tiff(data)
    want = np.asarray(im)
    if im.mode == "1":
        want = want.astype(np.uint8) * 255
    np.testing.assert_array_equal(got.pixels, want)


@pytest.mark.parametrize("comp", ["raw", "packbits", "tiff_lzw",
                                  "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "1", "LA"])
def test_pil_written_tiffs_bit_equal(comp, mode, tmp_path):
    img = Image.fromarray(_image(37, 29, 4))
    img = {"RGBA": lambda: img.convert("RGBA"), "L": lambda: img.convert(
        "L"), "P": lambda: img.convert("P"), "1": lambda: img.convert("1"),
        "LA": lambda: img.convert("LA")}.get(mode, lambda: img)()
    assert_reads_as_pil(_write(tmp_path, "a.tiff", _pil_bytes(
        img, "TIFF", compression=comp)))


def test_tiff_lzw_writer_round_trips():
    raw = bytes(_rng(5).integers(0, 256, 30000).astype(np.uint8)) + \
        bytes(20000)
    assert ttiff.lzw_decode(tiff_lzw(raw)) == raw
    assert ttiff.packbits_decode(packbits(raw)) == raw


@pytest.mark.parametrize("tag,value,match", [
    (259, 7, "Compression 7 \\(JPEG\\)"),
    (259, 3, "Compression 3 \\(CCITT Group 3 fax\\)"),
    (259, 4, "Compression 4 \\(CCITT Group 4 fax\\)"),
    (317, 3, "Predictor 3 \\(floating point\\)"),
    (262, 6, "PhotometricInterpretation 6 \\(YCbCr\\)"),
    (262, 5, "PhotometricInterpretation 5 \\(CMYK"),
    (266, 2, "FillOrder 2"),
    (274, 6, "Orientation 6"),
    (339, 3, "SampleFormat"),
])
def test_tiff_unsupported_raise_naming_tag(tag, value, match, tmp_path):
    # each of these tags was refused; PIL 12.1 reads the CMYK, YCbCr,
    # FillOrder 2 and Orientation 6 pages (YCbCr uncompressed as its raw
    # reader misreads it, as RGBX), and the port reads them bit-equal; the
    # rest PIL refuses, and the port raises naming the tag
    img = _image(16, 8, 6).astype(np.int64)
    spp = {(262, 5): 4}.get((tag, value), 3)
    samples = np.concatenate([img, img[..., :1]], -1)[..., :spp]
    data = tiff_file(samples, 2, 8, compression=5 if tag == 317 else 1,
                     extra_tags={tag: (3, [value])})
    try:
        Image.open(io.BytesIO(data)).load()
    except Exception:
        with pytest.raises((NotImplementedError, ValueError), match=match):
            ttiff.decode_tiff(data)
    else:
        assert (tag, value) in ((262, 5), (262, 6), (266, 2), (274, 6))
        assert_reads_as_pil(_write(tmp_path, "a.tif", data))


@pytest.mark.parametrize("case", ["bigtiff_be", "planar16", "grey16_white_be",
                                  "assoc_alpha_planar_raw"])
def test_tiff_pil_refuses_port_refuses(case):
    img = _image(16, 8, 7).astype(np.int64)
    data = {
        "bigtiff_be": lambda: tiff_file(img, 2, 8, ">", big=True),
        "planar16": lambda: tiff_file(img[..., :1] * 3, 1, 16, planar=2,
                                      extra_tags={277: (3, [2]),
                                                  258: (3, [16, 16])}),
        "grey16_white_be": lambda: tiff_file(img[..., :1], 0, 16, ">"),
        "assoc_alpha_planar_raw": lambda: tiff_file(
            np.concatenate([img, img[..., :1]], -1), 2, 8, extra=(1,),
            planar=2),
    }[case]()
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises((NotImplementedError, ValueError)):
        ttiff.decode_tiff(data)


# ---------------------------------------------------------------------------
# the committed fixtures

def _same_file(committed, made):
    """Byte-equal; a TIFF that libtiff wrote may differ in bytes its IFD
    leaves undefined, so there the PIL decodes must be equal."""
    a, b = open(committed, "rb").read(), open(made, "rb").read()
    if committed.endswith(".tif") and a != b:
        np.testing.assert_array_equal(pil_natural(Image.open(committed)),
                                      pil_natural(Image.open(made)))
    else:
        assert a == b, committed


def test_fixtures_are_what_make_fixtures_writes(tmp_path):
    make_fixtures(str(tmp_path), str(tmp_path / "timing"))
    for sub, fixtures in FIXTURE_SETS.items():
        for name in fixtures():
            committed = os.path.join(DATA, sub, name)
            _same_file(committed, str(tmp_path / sub / name))
            png = os.path.splitext(committed)[0] + ".png"
            np.testing.assert_array_equal(
                tio.load_image(committed),
                tio.load_png(png).reshape(tio.load_image(committed).shape))
            assert_reads_as_pil(committed)
    for name in TIMING_FIXTURES:
        stem = os.path.splitext(name)[0]
        for f in (name, stem + ".sha256"):
            _same_file(os.path.join(TIMING, f), str(tmp_path / "timing" / f))


@pytest.mark.parametrize("name,shape", [("tiff_lzw_512x384.tif",
                                         (384, 512, 3)),
                                        ("gif_512x384.gif", (384, 512, 3))])
def test_timing_fixture_hashes(name, shape):
    got = tio.load_image(os.path.join(TIMING, name))
    want = open(os.path.join(TIMING, os.path.splitext(name)[0]
                             + ".sha256")).read().strip()
    assert got.shape == shape
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


def test_restore_cli_reads_the_new_inputs_as_jax_does(tiny_models, tmp_path,
                                                      monkeypatch):
    # the slice end to end: the restore CLI over a folder of CMYK,
    # arithmetic and lossless JPEGs and a PNG named .JPEG, and --image on a
    # 256x256 LZW TIFF, against the JAX CLI (PIL's decodes)
    import shutil

    from pointdreamer_tpu.cli import ddnm_restore as jcli
    from pointdreamer_tpu_torch.cli import ddnm_restore as tcli

    root = tmp_path / "imgs"
    os.makedirs(root)
    for f in ("cmyk.jpg", "arith_prog.jpg", "lossless.jpg"):
        shutil.copy(os.path.join(DATA, "jpeg", f), root / f)
    shutil.copy(os.path.join(DATA, "png", "png_named.JPEG"),
                root / "png_named.JPEG")
    runs = [["--image_dir", str(root), "--batch", "4"],
            ["--image", os.path.join(DATA, "tiff", "restore_256_lzw.tif")]]
    for k, src in enumerate(runs):
        argv = src + ["--dataset", "IMAGENET", "--deg", "sr4", "--steps",
                      str(STEPS)]
        jout, tout = tmp_path / f"jax{k}", tmp_path / f"port{k}"
        # --image writes the file --out names, --image_dir into the folder
        name = "" if k == 0 else "out.png"
        if name:
            os.makedirs(jout)
            os.makedirs(tout)
        monkeypatch.setattr("sys.argv", ["ddnm_restore"] + argv
                            + ["--out", str(jout / name)])
        jcli.main()
        tcli.main(argv + ["--device", "cpu", "--out", str(tout / name)])
        assert len(_same_outputs(jout, tout)) == (8 if k == 0 else 2)
