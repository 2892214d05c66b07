"""PyTorch port, Zstandard (zstd.py) and ZSTD-compressed TIFF (tiff.py's
Compression 50000), against libzstd 1.5.7 and PIL 12.1 (libtiff 4.7.1).

`zstd.decompress` is held to the libzstd that Pillow bundles (driven
through ctypes) at every level class: its fast negative levels (raw and
RLE blocks, raw literals), level 1 to 19 (Huffman literals in 1 and 4
streams with direct and FSE-coded weights, treeless literals, the
predefined, RLE, FSE and repeat sequence modes, the repeat offsets),
each frame with and without its XXH64 checksum; a frame that fails its
checksum and one that needs a dictionary raise.  The TIFFs under
tests/data/zstd/ are what `make_fixtures` writes: PIL's (libtiff's ZSTD
codec, one frame a strip, Predictor 1 and 2: libtiff undoes the
predictor for ZSTD) and the writers' (libzstd frames with checksums, in
tiles, and at a fast level in strips with Predictor 2); each decodes
bit-equal to PIL, its convert("RGBA") committed beside it as `<stem>_pil.png`, its
"I;16" pixels as `<stem>_pil.npy`."""
import ctypes as C
import functools
import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import tiff as ttiff
from pointdreamer_tpu_torch import zstd

from test_torch_image_formats import _image, tiff_file
from test_torch_image_formats_rest import (NPY_MODES, _native, _pil_bytes,
                                           assert_reads_as_pil, pil_npy_name,
                                           pil_png_name)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@functools.lru_cache(None)
def _libzstd():
    import PIL

    lib = C.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                        "pillow.libs", "libzstd-*"))[0])
    lib.ZSTD_compressBound.restype = C.c_size_t
    lib.ZSTD_createCCtx.restype = C.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [C.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.ZSTD_compress2.restype = C.c_size_t
    lib.ZSTD_compress2.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t,
                                   C.c_char_p, C.c_size_t]
    lib.ZSTD_isError.argtypes = [C.c_size_t]
    return lib


def zstd_frame(data: bytes, level: int = 3, checksum: bool = False) -> bytes:
    """One frame by libzstd (ZSTD_c_compressionLevel 100,
    ZSTD_c_checksumFlag 201)."""
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        lib.ZSTD_CCtx_setParameter(cctx, 100, level)
        lib.ZSTD_CCtx_setParameter(cctx, 201, int(checksum))
        buf = C.create_string_buffer(lib.ZSTD_compressBound(len(data)))
        n = lib.ZSTD_compress2(cctx, buf, len(buf), data, len(data))
        assert not lib.ZSTD_isError(n)
        return buf.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def skippable(payload: bytes) -> bytes:
    return (0x184D2A53).to_bytes(4, "little") + len(payload).to_bytes(
        4, "little") + payload


def zstd_tiff(arr, predictor=1, **opts) -> bytes:
    """PIL's ZSTD TIFF (libtiff's codec)."""
    mode = "I;16" if arr.dtype == np.uint16 else None
    img = Image.fromarray(arr) if mode is None else Image.frombuffer(
        "I;16", arr.shape[::-1], arr.astype("<u2").tobytes(), "raw", "I;16",
        0, 1)
    return _pil_bytes(img, "TIFF", compression="zstd",
                      tiffinfo={317: predictor}, **opts)


def _fixtures():
    rgb = _image(13, 10, 230)
    mid = _image(37, 29, 231)
    rgba = np.dstack([_image(17, 9, 232), _image(17, 9, 233)[..., :1]])
    grey16 = (_image(19, 20, 234)[..., 0].astype(np.uint16) * 251 + 7)

    def frames(level, checksum):
        return lambda b: zstd_frame(b, level, checksum)

    return {
        "rgb_13x10.tif": lambda: zstd_tiff(rgb),
        "rgb_pred2.tif": lambda: zstd_tiff(mid, predictor=2),
        "l_1x23.tif": lambda: zstd_tiff(_image(23, 1, 237)[..., 0]),
        "rgba_pred2.tif": lambda: zstd_tiff(rgba, predictor=2),
        "i16_pred2.tif": lambda: zstd_tiff(grey16, predictor=2),
        "strips.tif": lambda: zstd_tiff(mid, predictor=2, strip_size=256),
        "tiles_checksum.tif": lambda: tiff_file(
            mid.astype(np.int64), 2, 8, tile=(16, 16), compression=50000,
            encode=frames(19, True)),
        "strips_fast_pred2.tif": lambda: tiff_file(
            mid.astype(np.int64), 2, 8, rows_per_strip=8, compression=50000,
            predictor=2, encode=frames(-5, True)),
    }


FIXTURES = {"zstd": _fixtures}


def make_fixtures(root: str) -> None:
    """Write each fixture under root/zstd/, PIL's convert("RGBA") beside
    it as `<stem>_pil.png` and its "I;16" pixels as `<stem>_pil.npy`."""
    os.makedirs(os.path.join(root, "zstd"), exist_ok=True)
    for name, make in _fixtures().items():
        data = make()
        with open(os.path.join(root, "zstd", name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        im.load()
        Image.fromarray(np.asarray(im.convert("RGBA"))).save(
            os.path.join(root, "zstd", pil_png_name(name)))
        if im.mode in NPY_MODES:
            np.save(os.path.join(root, "zstd", pil_npy_name(name)),
                    _native(im))


# ---------------------------------------------------------------------------
# zstd frames against libzstd


def _payloads():
    rng = np.random.default_rng(240)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"zstd", b"tiff"]
    return {
        "text": b" ".join(words[i] for i in rng.integers(0, 6, 20000)),
        "random": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        "small_alphabet": rng.integers(0, 4, 100000, dtype=np.uint8)
        .tobytes(),
        "image_rows": _image(200, 150, 241).tobytes(),
        "runs": b"\x00" * 5000 + b"\x07" * 3000 + bytes(range(256)) * 4,
        "empty": b"",
        "one": b"a",
    }


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_decompress_matches_libzstd(level, checksum):
    for name, data in _payloads().items():
        frame = zstd_frame(data, level, checksum)
        assert zstd.decompress(frame) == data, (name, level)


def test_the_first_frame_alone_is_read():
    # as libtiff reads a strip: the frames after the first are not read,
    # and a skippable frame gives nothing
    a, b = b"first frame " * 40, bytes(range(200))
    assert zstd.decompress(zstd_frame(a, 3, True) + zstd_frame(b, 1)) == a
    assert zstd.decompress(skippable(b"x" * 10) + zstd_frame(b, 1)) == b""
    with pytest.raises(zstd.ZstdError, match="skippable"):
        zstd.decompress(skippable(b"x" * 10)[:12])


def test_bad_checksum_raises():
    frame = bytearray(zstd_frame(b"checked content " * 100, 3, True))
    assert zstd.decompress(bytes(frame)) == b"checked content " * 100
    frame[-1] ^= 0x55
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    # the frame checksums of libzstd hold the low 32 bits
    for n in (1, 3, 4, 7, 8, 31, 32, 33, 100):
        data = bytes(range(n))
        frame = zstd_frame(data, 3, True)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(
            frame[-4:], "little")


def test_dictionary_frame_raises_naming_it():
    # a single-segment frame of one raw block "abc" (content size 3),
    # without and with a 1-byte dictionary ID
    magic, block = b"\x28\xb5\x2f\xfd", b"\x19\x00\x00abc"
    assert zstd.decompress(magic + b"\x20\x03" + block) == b"abc"
    with pytest.raises(NotImplementedError, match="dictionary 42"):
        zstd.decompress(magic + b"\x21\x2a\x03" + block)


# ---------------------------------------------------------------------------
# ZSTD TIFFs as PIL reads them


@functools.lru_cache(None)
def _read(name):
    with open(os.path.join(DATA, "zstd", name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_committed_zstd_tiff_reads_as_pil(name):
    data = _read(name)
    got, im = assert_reads_as_pil(data, name)
    from pointdreamer_tpu_torch import imagemode

    np.testing.assert_array_equal(imagemode.to_rgba(got), tio.load_png(
        os.path.join(DATA, "zstd", pil_png_name(name))))
    npy = os.path.join(DATA, "zstd", pil_npy_name(name))
    assert os.path.exists(npy) == (im.mode in NPY_MODES), name
    if im.mode in NPY_MODES:
        np.testing.assert_array_equal(got.pixels, np.load(npy))


def test_fixtures_are_what_make_fixtures_writes(tmp_path):
    make_fixtures(str(tmp_path))
    assert sorted(os.listdir(tmp_path / "zstd")) == sorted(
        os.listdir(os.path.join(DATA, "zstd")))
    for name in _fixtures():
        # libtiff leaves some IFD bytes undefined: compared by decode
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(DATA, "zstd", name))),
            np.asarray(Image.open(str(tmp_path / "zstd" / name))))
        np.testing.assert_array_equal(
            tio.load_png(os.path.join(DATA, "zstd", pil_png_name(name))),
            tio.load_png(str(tmp_path / "zstd" / pil_png_name(name))))


def test_zstd_predictor_undone_as_libtiff():
    # libtiff undoes horizontal differencing for ZSTD strips: the data
    # of rgb_pred2.tif is differenced, PIL's pixels are not
    img = _image(37, 29, 231)
    data = zstd_tiff(img, predictor=2)
    got = ttiff.decode_tiff(data)
    np.testing.assert_array_equal(got.pixels, img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)


def test_tiff_webp_still_raises_naming_it():
    img = _image(16, 8, 7).astype(np.int64)
    data = tiff_file(img, 2, 8, encode=lambda b: b,
                     extra_tags={259: (3, [50001])})
    with pytest.raises(NotImplementedError,
                       match="Compression 50001 \\(WebP\\)"):
        ttiff.decode_tiff(data)


def test_strip_reads_its_first_frame_as_libtiff():
    # libtiff's ZSTD codec reads one frame a strip: a second frame is not
    # read, and a strip that starts with a skippable frame gives nothing
    img = _image(16, 8, 242).astype(np.int64)
    two = tiff_file(img, 2, 8, compression=50000, encode=lambda b: (
        zstd_frame(b, 3) + zstd_frame(b"never read", 1)))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(two))),
                                  img)
    np.testing.assert_array_equal(ttiff.decode_tiff(two).pixels, img)
    for encode in (lambda b: skippable(b"x") + zstd_frame(b, 3),
                   lambda b: zstd_frame(b[:100], 3) + zstd_frame(b[100:])):
        data = tiff_file(img, 2, 8, compression=50000, encode=encode)
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        with pytest.raises(ValueError):
            ttiff.decode_tiff(data)
