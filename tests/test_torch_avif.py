"""The port's AVIF reader (`avif.py`, the AV1 decoder `av1_*.py`,
`avif_rgb.py`) against Pillow 12.1 (libavif 1.3.0: dav1d 1.5.1 decodes,
libyuv 1909 converts) and the JAX package.

Fixtures under tests/data/avif/ and tests/data/restore19/ come from PIL's
own encoder under its save options and `advanced=` aom options, and, for
what PIL cannot write (10 and 12 bits, superres, grids, other matrices,
segmentation), from the system libaom / rav1e through ctypes
(`torch_avif_tools`), wrapped by the test's AVIF writer.  Each is
committed with PIL's decode beside it (`<stem>_pil.png`, "RGB" or
"RGBA"), so chip_smoke.py checks them on the card's host, where PIL is
absent.  Regenerate them with

    PYTHONPATH=.:tests python -c "import test_torch_avif as a;
    a.make_fixtures('tests/data')"

Two oracles: the decoded Y / U / V / alpha planes are held bit-equal to
dav1d's (through the `dav1d_*` functions Pillow's libavif exports), and
the RGB / RGBA to PIL's.
"""
from __future__ import annotations

import functools
import io
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

import torch_avif_tools as T
from pointdreamer_tpu_torch import avif
from pointdreamer_tpu_torch import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def natural(w, h, seed):
    """A smooth image with texture and an edge (as a photo has)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / 17.0 + yy / 23.0),
                  128 + 90 * np.cos(xx / 11.0 - yy / 29.0),
                  128 + 80 * np.sin((xx + yy) / 31.0)], -1)
    a += r.normal(0, 8, (h, w, 3))
    a[h // 3:h // 2, w // 4:w // 2] += 60
    return np.clip(a, 0, 255).astype(np.uint8)


def screen(w, h, seed):
    """Repeated noise tiles on a flat field (palette and IntraBC)."""
    r = np.random.default_rng(seed)
    tile = (r.random((32, 32, 3)) * 255).astype(np.uint8)
    a = np.full((h, w, 3), 200, np.uint8)
    for y, x in ((0, 0), (0, 64), (8, 136), (96, 16), (100, 180),
                 (160, 72), (130, 110)):
        if y + 32 <= h and x + 32 <= w:
            a[y:y + 32, x:x + 32] = tile
    a[40:48, 200:232] = (20, 40, 220)
    return a


def blocks(w, h, seed):
    """High-contrast regions (segmentation, large transforms)."""
    r = np.random.default_rng(seed)
    a = np.full((h, w, 3), 128.0)
    yy, xx = np.mgrid[0:h, 0:w]
    a[:, :w // 4] = r.normal(128, 70, (h, w // 4, 3))
    a[:, w // 4:w // 2] = (40 + 0.5 * xx[:, w // 4:w // 2])[..., None]
    a[h // 2:, w // 2:] = r.normal(128, 25, (h - h // 2, w - w // 2, 3))
    a[:h // 2, 3 * w // 4:] = 230
    return np.clip(a, 0, 255).astype(np.uint8)


def bands(w, h, seed):
    """Flat horizontal bands 16 rows high (64 x 16 blocks)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    band = yy // 16
    a = np.stack([60 + band * 20 + 0.2 * xx, 200 - band * 15 + 0.1 * xx,
                  100 + (band * 37) % 60 + 0.05 * xx], -1)
    return np.clip(a + r.normal(0, 1.5, (h, w, 3)), 0, 255).astype(np.uint8)


def rgba(w, h, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.dstack([natural(w, h, seed),
                   np.clip((xx * 11 + yy * 7) % 256 + r.normal(0, 20, (h, w)),
                           0, 255).astype(np.uint8)])
    a[:, :6, 3] = 0
    a[-4:, :, 3] = 255
    return a


def pil_avif(arr, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "AVIF", **opts)
    return buf.getvalue()


def _exif(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def _icc():
    from PIL import ImageCms
    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def _aom(arr, bd=8, ssx=1, ssy=1, **kw):
    return T.aom_encode(T.rgb_to_yuv(arr, ssx, ssy, bd), bd, ssx, ssy, **kw)


def _grid():
    big = natural(128, 128, 40)
    tiles = [_aom(big[r * 64:r * 64 + 64, c * 64:c * 64 + 64], usage=0,
                  speed=6, cq_level=30) for r in range(2) for c in range(2)]
    return T.write_avif(tiles, grid=(2, 2, 120, 100), nclx=(1, 13, 6, 1))


def _hbd_rgba(bd, ss, prem):
    """10- / 12-bit colour with a 10- / 12-bit alpha item (coded in limited
    range, as libaom writes it: PIL expands it)."""
    mx = (1 << bd) - 1
    color = _aom(natural(46, 38, 28 + bd), bd, ss, ss, cq_level=30)
    a = np.tile(np.linspace(0, mx, 46).astype(np.uint16), (38, 1))
    half = np.full((19, 23), 1 << (bd - 1), np.uint16)
    alpha = T.aom_encode([a, half, half], bd, 1, 1,
                         options={"lossless": "1"})
    return T.write_avif(color, alpha, prem=prem)


def _recolour(data, nclx):
    return T.rewrite_colr(data, nclx)


_N = natural(96, 72, 1)


def _fixtures():
    n = _N
    return {
        # PIL's save options
        "q0.avif": lambda: pil_avif(n, quality=0),
        "q35.avif": lambda: pil_avif(n, quality=35),
        "q60.avif": lambda: pil_avif(n, quality=60),
        "q85_odd.avif": lambda: pil_avif(natural(45, 37, 2), quality=85),
        "q100_lossless.avif": lambda: pil_avif(natural(40, 32, 3),
                                               quality=100),
        "speed0.avif": lambda: pil_avif(natural(160, 136, 4), quality=50,
                                        speed=0),
        "speed3.avif": lambda: pil_avif(natural(160, 136, 5), quality=50,
                                        speed=3),
        "speed10.avif": lambda: pil_avif(n, quality=50, speed=10),
        "ss400.avif": lambda: pil_avif(n, quality=70, subsampling="4:0:0"),
        "ss422.avif": lambda: pil_avif(natural(45, 37, 6), quality=70,
                                       subsampling="4:2:2"),
        "ss444.avif": lambda: pil_avif(n, quality=70, subsampling="4:4:4"),
        "limited.avif": lambda: pil_avif(natural(45, 37, 7), quality=70,
                                         range="limited"),
        "limited400.avif": lambda: pil_avif(n, quality=70, range="limited",
                                            subsampling="4:0:0"),
        "rgba.avif": lambda: pil_avif(rgba(47, 33, 8), quality=70),
        "rgba_prem.avif": lambda: pil_avif(rgba(47, 33, 9), quality=70,
                                           alpha_premultiplied=True),
        "rgba444_prem.avif": lambda: pil_avif(
            rgba(40, 30, 10), quality=60, subsampling="4:4:4",
            alpha_premultiplied=True),
        "tiles.avif": lambda: pil_avif(natural(300, 200, 11), quality=40,
                                       tile_rows=1, tile_cols=1),
        "autotiling.avif": lambda: pil_avif(natural(96, 64, 12), quality=40,
                                            autotiling=True),
        "exif_rot.avif": lambda: pil_avif(n[:32, :40], quality=60,
                                          exif=_exif(6)),
        "exif_mirror.avif": lambda: pil_avif(n[:32, :40], quality=60,
                                             exif=_exif(2)),
        "icc.avif": lambda: pil_avif(n[:32, :40], quality=60,
                                     icc_profile=_icc()),
        "avis.avif": lambda: _pil_sequence(),
        # aom through PIL's advanced=
        "qm.avif": lambda: pil_avif(n, quality=60, advanced={
            "enable-qm": "1", "qm-min": "0", "qm-max": "8"}),
        "grain.avif": lambda: pil_avif(natural(120, 100, 13), quality=60,
                                       advanced={"film-grain-test": "1"}),
        "grain444.avif": lambda: pil_avif(
            natural(64, 48, 14), quality=60, subsampling="4:4:4",
            advanced={"film-grain-test": "10"}),
        "screen.avif": lambda: pil_avif(screen(256, 192, 15), quality=80,
                                        subsampling="4:4:4",
                                        advanced={"tune-content": "screen"}),
        "screen420.avif": lambda: pil_avif(
            screen(256, 192, 16), quality=85, speed=2,
            advanced={"tune-content": "screen"}),
        "cdef.avif": lambda: pil_avif(n, quality=50,
                                      advanced={"enable-cdef": "1"}),
        "restoration.avif": lambda: pil_avif(
            natural(200, 136, 17), quality=30, speed=0,
            advanced={"enable-restoration": "1"}),
        "deltaq_lf.avif": lambda: pil_avif(
            natural(200, 136, 18), quality=50,
            advanced={"deltaq-mode": "2", "delta-lf-mode": "1"}),
        "sb128.avif": lambda: pil_avif(natural(260, 140, 19), quality=50,
                                       speed=4, advanced={"sb-size": "128"}),
        "tx64.avif": lambda: pil_avif(
            np.repeat(np.repeat(natural(64, 48, 20), 4, 0), 4, 1)[:192],
            quality=20, speed=2),
        "tx64x32.avif": lambda: pil_avif(np.ascontiguousarray(np.repeat(
            np.repeat(natural(64, 48, 21), 4, 0), 4, 1)[:192].transpose(
                1, 0, 2)), quality=10, speed=0),
        "tx64x16.avif": lambda: pil_avif(bands(128, 128, 0), quality=20,
                                         speed=0),
        "reduced_tx.avif": lambda: pil_avif(
            n, quality=60, advanced={"reduced-tx-type-set": "1"}),
        # libaom / rav1e through ctypes, in the test's AVIF writer
        "bd10_420.avif": lambda: T.write_avif(
            _aom(natural(45, 37, 21), 10, cq_level=30)),
        "bd10_444.avif": lambda: T.write_avif(
            _aom(natural(40, 32, 22), 10, 0, 0, cq_level=30)),
        "bd12_422.avif": lambda: T.write_avif(
            _aom(natural(45, 37, 23), 12, 1, 0, cq_level=30)),
        "bd12_444.avif": lambda: T.write_avif(
            _aom(natural(40, 32, 24), 12, 0, 0, cq_level=30)),
        "bd10_rgba_prem.avif": lambda: _hbd_rgba(10, 1, True),
        "bd12_rgba.avif": lambda: _hbd_rgba(12, 1, False),
        "bd12_rgba444_prem.avif": lambda: _hbd_rgba(12, 0, True),
        "superres.avif": lambda: T.write_avif(
            _aom(natural(208, 144, 25), usage=0, speed=4, cq_level=32,
                 options={"enable-restoration": "1"},
                 superres_kf_denominator=11)),
        "segmentation.avif": lambda: T.write_avif(T.rav1e_encode(
            T.rgb_to_yuv(blocks(256, 192, 26), 1, 1),
            {"speed": 6, "quantizer": 120})),
        "grid.avif": _grid,
        "mc_bt709_limited.avif": lambda: _recolour(
            pil_avif(n[:40, :48], quality=70), (1, 1, 1, 0)),
        "mc_identity.avif": lambda: _recolour(
            pil_avif(n[:40, :48], quality=70, subsampling="4:4:4"),
            (1, 13, 0, 1)),
        "mc_ycgco.avif": lambda: _recolour(
            pil_avif(n[:40, :48], quality=70), (2, 2, 8, 1)),
        "mc_bt2020_derived.avif": lambda: _recolour(
            pil_avif(n[:40, :48], quality=70), (9, 16, 12, 1)),
        "mc_smpte240_10bit.avif": lambda: T.write_avif(
            _aom(natural(40, 32, 27), 10, cq_level=30), nclx=(7, 7, 7, 0)),
    }


def _pil_sequence():
    frames = [Image.fromarray(natural(48, 40, 30 + i)) for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   quality=60)
    return buf.getvalue()


def _restore_fixtures():
    """The restore folder: 8 AVIFs under the dataset's extensions."""
    p = [natural(64, 48, 50 + k) for k in range(8)]
    return {
        "a_q60.png": lambda: pil_avif(p[0], quality=60),
        "b_444.jpg": lambda: pil_avif(p[1], quality=70, subsampling="4:4:4"),
        "c_rgba.jpeg": lambda: pil_avif(rgba(64, 48, 58), quality=60),
        "d_10bit.bmp": lambda: T.write_avif(_aom(p[3], 10, cq_level=30)),
        "e_grain.webp": lambda: pil_avif(p[4], quality=60, advanced={
            "film-grain-test": "1"}),
        "f_lossless.ppm": lambda: pil_avif(p[5], quality=100),
        "g_422.png": lambda: pil_avif(p[6], quality=50,
                                      subsampling="4:2:2"),
        "h_screen.jpg": lambda: pil_avif(screen(64, 48, 59), quality=80,
                                         advanced={"tune-content": "screen"}),
    }


FIXTURE_SETS = {"avif": _fixtures, "restore19": _restore_fixtures}
# chip_smoke phase 18: --image (256 x 256) and the timing fixture
CARD_ONLY = {
    ("avif", "restore_256.avif"): lambda: pil_avif(natural(256, 256, 60),
                                                   quality=60),
}
TIMING = ("timing", "avif_q60_512x384.avif",
          lambda: pil_avif(natural(512, 384, 61), quality=60))


def pil_png_name(name):
    return os.path.splitext(name)[0] + "_pil.png"


def make_fixtures(root: str) -> None:
    """Write each fixture under root/<set>/ with PIL's decode (its mode,
    "RGB" or "RGBA") beside it as `<stem>_pil.png`; the timing fixture
    with the SHA-256 of PIL's decoded bytes."""
    import hashlib
    for sub, fn in FIXTURE_SETS.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        items = list(fn().items()) + [(n, f) for (s, n), f in
                                      CARD_ONLY.items() if s == sub]
        for name, make in items:
            data = make()
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(data)
            im = Image.open(io.BytesIO(data))
            Image.fromarray(np.asarray(im)).save(
                os.path.join(root, sub, pil_png_name(name)))
    sub, name, make = TIMING
    data = make()
    with open(os.path.join(root, sub, name), "wb") as f:
        f.write(data)
    pix = np.asarray(Image.open(io.BytesIO(data))).tobytes()
    with open(os.path.join(root, sub, os.path.splitext(name)[0] +
                           ".sha256"), "w") as f:
        f.write(hashlib.sha256(pix).hexdigest() + "\n")


def _committed(sub):
    return sorted(FIXTURE_SETS[sub]())


@functools.lru_cache(None)
def _read(sub, name):
    with open(os.path.join(DATA, sub, name), "rb") as f:
        return f.read()


def _pil_png(sub, name):
    return np.asarray(Image.open(os.path.join(DATA, sub,
                                              pil_png_name(name))))


# ---------------------------------------------------------------------------
# every fixture as PIL reads it, its planes as dav1d decodes them


@pytest.mark.parametrize("sub,name", [(s, n) for s in FIXTURE_SETS
                                      for n in _committed(s)])
def test_fixture_reads_as_pil(sub, name):
    data = _read(sub, name)
    im = Image.open(io.BytesIO(data))
    pil = np.asarray(im)
    np.testing.assert_array_equal(pil, _pil_png(sub, name))
    assert tio.image_type(data) == "AVIF" == im.format
    got = tio.decode_image(data, name)
    assert got.mode == im.mode
    np.testing.assert_array_equal(got.pixels, pil)
    from pointdreamer_tpu_torch import imagemode
    np.testing.assert_array_equal(imagemode.to_rgb(got),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(imagemode.to_rgba(got),
                                  np.asarray(im.convert("RGBA")))


@pytest.mark.parametrize("name", _committed("avif"))
def test_planes_bit_equal_to_dav1d(name):
    f = avif.parse(_read("avif", name))
    color, alpha, _, _ = avif._select(f)
    for src in (color, alpha):
        if src is None:
            continue
        streams = [src[1]] if src[0] == "av1" else src[5]
        for s in streams:
            from pointdreamer_tpu_torch.av1_decoder import decode_av1
            got = decode_av1(s).planes
            want = T.dav1d_planes(s)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, name)


def test_fixtures_are_what_make_fixtures_writes(tmp_path):
    # the cheap ones are made again here (PIL's encoder is deterministic);
    # the timing fixture's digest is PIL's decode of the committed file
    import hashlib
    fx = _fixtures()
    for name in ("q60.avif", "ss444.avif", "rgba.avif", "limited.avif"):
        assert fx[name]() == _read("avif", name), name
    sub, name, _ = TIMING
    pix = np.asarray(Image.open(io.BytesIO(_read(sub, name)))).tobytes()
    with open(os.path.join(DATA, sub, os.path.splitext(name)[0] +
                           ".sha256")) as f:
        assert f.read().strip() == hashlib.sha256(pix).hexdigest()
    names = set(os.listdir(os.path.join(DATA, "avif")))
    for n in _committed("avif") + ["restore_256.avif"]:
        assert n in names and pil_png_name(n) in names, n


# ---------------------------------------------------------------------------
# the slice as a whole, against the JAX package


def test_restore19_folder_matches_jax(tmp_path):
    from pointdreamer_tpu.core import io as jio
    from pointdreamer_tpu.models.diffusion import datasets as jds
    from pointdreamer_tpu_torch.models.diffusion import datasets as tds

    names = _committed("restore19")
    root = tmp_path / "imgs"
    os.makedirs(root)
    for n in names:
        shutil.copy(os.path.join(DATA, "restore19", n), root / n)
    jd = jds.ImageFolderDataset(str(root), 256)
    td = tds.ImageFolderDataset(str(root), 256)
    assert td.files == jd.files and len(td.files) == 8
    for k in range(len(td.files)):
        np.testing.assert_array_equal(td[k], jd[k])
    for n in names + ["rgba_prem.avif", "bd12_444.avif", "grid.avif"]:
        path = str(root / n) if n in names else os.path.join(DATA, "avif",
                                                             n)
        np.testing.assert_array_equal(tio.load_rgb(path), jio.load_rgb(path))
        np.testing.assert_array_equal(tio.load_rgba(path),
                                      jio.load_rgba(path))
    assert {tio.image_type(_read("restore19", n)) for n in names} == {"AVIF"}


# ---------------------------------------------------------------------------
# container: what libavif refuses, and what it ignores


@pytest.mark.parametrize("case", ["trunc_meta", "bad_brand", "no_meta",
                                  "not_ftyp_first"])
def test_parse_failures_go_on_to_the_next_plugin(case):
    base = _read("avif", "q60.avif")
    size, = struct.unpack(">I", base[:4])
    data = {
        "trunc_meta": base[:60],
        "bad_brand": base[:8] + b"mif1" + base[12:16] +
        b"mif1" * ((size - 16) // 4) + base[size:],
        "no_meta": base[:size] + struct.pack(">I4s", 8, b"free"),
        "not_ftyp_first": struct.pack(">I4s", 8, b"free") + base,
    }[case]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data))
    assert tio.image_type(data) == ""
    with pytest.raises(ValueError):
        tio.decode_image(data, "x.bin")


def test_truncated_item_data_raises_as_pil():
    data = _read("avif", "q60.avif")[:-10]
    im = Image.open(io.BytesIO(data))
    with pytest.raises(SyntaxError, match="Truncated data"):
        im.load()
    assert tio.image_type(data) == "AVIF"
    with pytest.raises(SyntaxError, match="Truncated data"):
        tio.decode_image(data, "x.bin")


@pytest.mark.parametrize("grid", [(2, 2, 60, 100), (2, 2, 121, 101)])
def test_invalid_grid_raises_as_pil(grid):
    f = avif.parse(_read("avif", "grid.avif"))
    tiles = [avif._item_data(f, f.items[t])
             for t in f.items[f.primary].refs[b"dimg"]]
    data = T.write_avif(tiles, grid=grid, nclx=(1, 13, 6, 1))
    with pytest.raises(RuntimeError, match="Invalid image grid"):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(RuntimeError, match="Invalid image grid"):
        tio.decode_image(data, "x.bin")


@pytest.mark.parametrize("mc,full", [(10, 1), (8, 0), (0, 1)])
def test_matrices_libavif_refuses_raise_as_pil(mc, full):
    # BT.2020 constant luminance, YCgCo in limited range, identity with
    # 4:2:0 chroma: libavif's reformat fails (RuntimeError), as here
    data = _recolour(_read("avif", "q60.avif"), (9, 13, mc, full))
    with pytest.raises(RuntimeError, match="Reformat failed"):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(RuntimeError, match="Reformat failed"):
        tio.decode_image(data, "x.bin")


@pytest.mark.parametrize("props", ["clap", "irot_imir", "no_colr", "idat",
                                   "iloc1", "iloc2"])
def test_container_variants_read_as_pil(props):
    stream = avif._item_data(*(lambda f: (f, f.items[f.primary]))(
        avif.parse(_read("avif", "bd10_444.avif"))))
    clap = T._box(b"clap", struct.pack(">IIIIIIII", 24, 1, 20, 1, 0, 1, 0,
                                        1))
    data = {
        "clap": lambda: T.write_avif(stream, extra_props=[clap]),
        "irot_imir": lambda: T.write_avif(stream, extra_props=[
            T._box(b"irot", b"\x01"), T._box(b"imir", b"\x01")]),
        "no_colr": lambda: T.write_avif(stream, nclx=None),
        "idat": lambda: T.write_avif(stream, idat=True),
        "iloc1": lambda: T.write_avif(stream, iloc_version=1),
        "iloc2": lambda: T.write_avif(stream, iloc_version=2),
    }[props]()
    im = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(tio.decode_image(data, "x").pixels,
                                  np.asarray(im))


def test_inter_frame_first_raises_naming_it():
    # rav1e writes a full sequence header: its key frame turned into an
    # inter frame (frame_type 1) is refused, naming it; dav1d fails on it
    from pointdreamer_tpu_torch import av1_obu as O
    from pointdreamer_tpu_torch.av1_decoder import decode_av1

    f = avif.parse(_read("avif", "segmentation.avif"))
    stream = avif._item_data(f, f.items[f.primary])
    out = b""
    for o in O.split_obus(stream):
        payload = o.data
        if o.type == O.OBU_FRAME:
            payload = bytes([(payload[0] & 0x9F) | 0x20]) + payload[1:]
        out += T._obu(o.type, payload)
    with pytest.raises(NotImplementedError, match="inter frame"):
        decode_av1(out)


def test_layered_stream_raises_naming_it():
    # operating point 0 with a nonzero idc (a layered stream, which no
    # encoder here writes): refused, naming it, rather than showing the
    # first layer where libavif shows the highest
    from pointdreamer_tpu_torch import av1_obu as O
    from pointdreamer_tpu_torch.av1_decoder import decode_av1

    f = avif.parse(_read("avif", "segmentation.avif"))
    stream = avif._item_data(f, f.items[f.primary])
    out = b""
    for o in O.split_obus(stream):
        payload = o.data
        if o.type == O.OBU_SEQUENCE_HEADER:
            seq = O.parse_sequence_header(payload)
            assert not seq.reduced_still_picture_header
            bits = int.from_bytes(payload, "big")
            n = len(payload) * 8
            # profile, still, reduced, timing (0), display delay (0),
            # count - 1 (0): operating_point_idc[0] starts at bit 12
            assert (bits >> (n - 8)) & 0x03 == 0
            bits |= 0x101 << (n - 24)
            payload = bits.to_bytes(len(payload), "big")
            assert O.parse_sequence_header(payload).operating_point_idc[
                0] == 0x101
        out += T._obu(o.type, payload)
    with pytest.raises(NotImplementedError, match="layered"):
        decode_av1(out)
