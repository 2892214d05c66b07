"""PyTorch port, the DDNM image-folder datasets (models/diffusion/
datasets.py with ops/resample.py) and the checkpoint registry
(models/diffusion/ckpt_util.py) against the JAX package on the CPU.

The JAX datasets preprocess through PIL; the port's numpy copy of PIL's
8-bit resampling gives the same uint8 crops, bit for bit: ImageNet's BOX
halving + BICUBIC + centre crop on 700x520 and 300x260 images, the fixed
CelebA crop + BICUBIC on a 178x218 face, CIFAR10's BILINEAR, read from
PNG, PPM and BMP.  `.jpg` and `.webp` files, which JAX reads through PIL,
decode as PIL decodes them (io.decode_jpeg, io.decode_webp); the BMP
variants PIL reads (palettes, RLE, 16-bit, bit fields) read as PIL reads
them.  ckpt_util runs over file:// URLs only."""
import hashlib
import os
import struct

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu.models.diffusion import ckpt_util as jckpt
from pointdreamer_tpu.models.diffusion import datasets as JD
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch.models.diffusion import ckpt_util as tckpt
from pointdreamer_tpu_torch.models.diffusion import datasets as TD
from pointdreamer_tpu_torch.ops import resample as R


def _img(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx * yy) / (w * h)], -1) * 180
    return np.clip(base + rng.integers(0, 76, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _folder(tmp_path, files):
    root = tmp_path / "imgs"
    os.makedirs(root, exist_ok=True)
    for name, (w, h, seed) in files.items():
        Image.fromarray(_img(w, h, seed)).save(root / name)
    return str(root)


@pytest.mark.parametrize("kind,size,files", [
    ("IMAGENET", 256, {"a.png": (700, 520, 0), "b.png": (300, 260, 1),
                       "c.ppm": (257, 300, 2), "d.bmp": (521, 515, 3)}),
    ("LSUN", 64, {"a.png": (700, 520, 4), "b.bmp": (75, 90, 5)}),
    ("CELEBA", 256, {"f1.png": (178, 218, 6), "f2.ppm": (178, 218, 7)}),
    ("CELEBA", 64, {"f1.png": (178, 218, 8), "small.png": (100, 90, 9)}),
    ("CIFAR10", 32, {"c1.png": (32, 32, 10), "c2.png": (50, 41, 11),
                     "c3.bmp": (20, 24, 12)}),
])
def test_crops_are_bit_equal_to_pil(kind, size, files, tmp_path):
    root = _folder(tmp_path, files)
    jd = JD.get_dataset(kind, root, image_size=size)
    td = TD.get_dataset(kind, root, image_size=size)
    assert td.files == jd.files and len(td) == len(files)
    for i, f in enumerate(jd.files):
        want = np.round(jd[i] * 255.0).astype(np.uint8)
        got = td.crop_uint8(i)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want, err_msg=f)
        np.testing.assert_array_equal(td[i], jd[i])
    (jn, jb), = list(jd.batches(8))
    (tn, tb), = list(td.batches(8))
    assert tn == jn
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("filt,pil", [("box", Image.BOX),
                                      ("bilinear", Image.BILINEAR),
                                      ("bicubic", Image.BICUBIC)])
def test_resize_is_bit_equal_to_pil(filt, pil):
    img = _img(97, 61, 13)
    for size in ((48, 30), (256, 161), (97, 20), (15, 61), (1, 1)):
        want = np.asarray(Image.fromarray(img).resize(size, resample=pil))
        np.testing.assert_array_equal(R.resize_uint8(img, size, filt), want)


def test_crop_pads_outside_the_image_black():
    img = _img(30, 20, 14)
    box = (-5, 3, 40, 25)
    want = np.asarray(Image.fromarray(img).crop(box))
    np.testing.assert_array_equal(R.crop_uint8(img, box), want)


def test_ascii_ppm_and_gray_images_read_as_pil_reads_them(tmp_path):
    img = _img(7, 5, 15)
    p = tmp_path / "a.ppm"
    body = " ".join(str(v) for v in img.reshape(-1))
    p.write_text(f"P3\n# a comment\n7 5\n255\n{body}\n")
    want = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(tio.load_rgb_uint8(str(p)), want)
    g = tmp_path / "g.png"
    Image.fromarray(img[..., 0]).save(g)
    np.testing.assert_array_equal(tio.load_rgb_uint8(str(g)),
                                  np.asarray(Image.open(g).convert("RGB")))


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".webp"])
def test_jpeg_and_webp_are_refused_by_name(ext, tmp_path):
    # both are read now: the port's dataset equals the JAX package's, and
    # the decode is PIL's (tests/test_torch_jpeg.py, test_torch_webp.py)
    root = _folder(tmp_path, {"a.png": (64, 64, 16)})
    bad = os.path.join(root, "z" + ext)
    Image.fromarray(_img(64, 64, 17)).save(bad)
    jd = JD.get_dataset("IMAGENET", root, image_size=32)
    td = TD.get_dataset("IMAGENET", root, image_size=32)
    assert len(jd) == 2 and td.files == jd.files
    for i in range(2):
        np.testing.assert_array_equal(td[i], jd[i])
    np.testing.assert_array_equal(tio.load_rgb_uint8(bad),
                                  np.asarray(Image.open(bad).convert("RGB")))
    assert len(TD.get_dataset("IMAGENET", root, image_size=32, limit=1)) == 1


# ---- BMP variants: a small BMP writer for what PIL cannot write

def _bmp(w, h, bpp, raster, comp=0, palette=None, masks=None, hsize=40,
         topdown=False):
    pal = b""
    if palette is not None:
        pal = b"".join(bytes((b, g, r)) + (b"" if hsize == 12 else b"\0")
                       for r, g, b in palette)
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, w, -h if topdown else h,
                           1, bpp, comp, len(raster), 2835, 2835, 0, 0)
        if hsize > 40:
            info += struct.pack("<IIII", *(masks or (0, 0, 0, 0))) \
                + bytes(hsize - 56)
    extra = struct.pack("<III", *masks[:3]) if hsize == 40 and masks \
        else b""
    off = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(raster), 0, 0, off) \
        + info + extra + pal + raster


def _bmp_rows(rows, bpp, topdown=False):
    out = b""
    for row in (rows if topdown else rows[::-1]):
        if bpp >= 8:
            b = np.asarray(row, np.uint8).tobytes()
        else:
            bits = (np.asarray(row)[:, None] >> np.arange(bpp - 1, -1, -1)) & 1
            b = np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes()
        out += b + bytes(-len(b) % 4)
    return out


_RLE8 = bytes([5, 7, 0, 3, 1, 2, 3, 0, 5, 9, 0, 0,      # run, odd absolute
               0, 4, 10, 11, 12, 13, 9, 200, 0, 0,
               0, 2, 1, 1, 1, 3, 3, 4, 0, 0,           # delta
               13, 77, 0, 1])
_RLE4 = bytes([5, 0x7A, 0, 5, 0x12, 0x34, 0x50, 0, 3, 0x9F, 0, 0,
               13, 0x1E, 0, 0, 0, 4, 0xAB, 0xCD, 9, 0x21, 0, 0]
              + [13, 0x45, 0, 0] * 4 + [0, 1])


def _bmp_case(case, rng):
    w, h = 13, 7
    if case.startswith(("pal", "grey")):
        bpp = int(case.split("_")[1])
        n = 1 << bpp
        pal = rng.integers(0, 256, (n, 3)).tolist()
        if case.startswith("grey"):
            pal = [(0, 0, 0), (255, 255, 255)] if n == 2 else [
                (i, i, i) for i in range(n)]
        rows = rng.integers(0, n, (h, w)).tolist()
        hsize = {"core": 12, "v5": 124}.get(case.split("_")[-1], 40)
        top = case.endswith("top")
        return _bmp(w, h, bpp, _bmp_rows(rows, bpp, top), palette=pal,
                    hsize=hsize, topdown=top)
    if case.startswith("rle"):
        rle4 = case == "rle4"
        pal = rng.integers(0, 256, (16 if rle4 else 256, 3)).tolist()
        return _bmp(w, h, 4 if rle4 else 8, _RLE4 if rle4 else _RLE8,
                    comp=2 if rle4 else 1, palette=pal)
    if case.startswith("16"):
        v = rng.integers(0, 1 << 16, (h, w))
        raster = b"".join(r.astype("<u2").tobytes() + bytes(-2 * w % 4)
                          for r in v[::-1])
        masks = {"16_555": None, "16_565": (0xF800, 0x7E0, 0x1F, 0),
                 "16_555bf": (0x7C00, 0x3E0, 0x1F, 0)}[case]
        return _bmp(w, h, 16, raster, comp=3 if masks else 0, masks=masks)
    v = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if case == "24":
        return _bmp(w, h, 24, b"".join(r[:, :3].tobytes() + bytes(-3 * w % 4)
                                       for r in v[::-1]))
    raster = b"".join(r.tobytes() for r in v[::-1])
    masks = {"32": None, "32_bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
             "32_rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
             "32_bgrx": (0xFF0000, 0xFF00, 0xFF, 0)}[case]
    return _bmp(w, h, 32, raster, comp=3 if masks else 0, masks=masks,
                hsize=124 if masks else 40)


@pytest.mark.parametrize("case", [
    "pal_1", "pal_4", "pal_8", "pal_1_core", "pal_4_v5", "pal_8_top",
    "grey_1", "grey_4", "grey_8", "rle8", "rle4", "16_555", "16_565",
    "16_555bf", "24", "32", "32_bgra", "32_rgba", "32_bgrx"])
def test_bmp_variants_read_as_pil_converts(case, tmp_path):
    p = str(tmp_path / "a.bmp")
    with open(p, "wb") as f:
        f.write(_bmp_case(case, np.random.default_rng(len(case))))
    im = Image.open(p)
    np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(tio.load_rgba_uint8(p),
                                  np.asarray(im.convert("RGBA")))


def test_truncated_rle_raises_as_pil_does(tmp_path):
    p = str(tmp_path / "a.bmp")
    with open(p, "wb") as f:
        f.write(_bmp(13, 7, 8, _RLE8[:12] + bytes([0, 1]), comp=1,
                     palette=[(i, 0, 0) for i in range(256)]))
    with pytest.raises(ValueError, match="not enough image data"):
        Image.open(p).load()
    with pytest.raises(ValueError, match="not enough image data"):
        tio.load_image(p)


def test_dataset_over_webp_and_progressive_jpeg_matches_jax(tmp_path):
    root = tmp_path / "imgs"
    os.makedirs(root)
    img = _img(90, 75, 18)
    Image.fromarray(img).save(root / "a.webp", quality=60)
    Image.fromarray(img).save(root / "b.webp", lossless=True)
    Image.fromarray(np.dstack([img, img[..., 0]])).save(root / "c.webp",
                                                        quality=70)
    Image.fromarray(img).save(root / "d.jpg", quality=80, progressive=True)
    Image.fromarray(img[..., 1]).save(root / "e.png", bits=4)
    for kind in ("LSUN", "CIFAR10"):
        jd = JD.get_dataset(kind, str(root), image_size=32)
        td = TD.get_dataset(kind, str(root), image_size=32)
        assert td.files == jd.files and len(td) == 5
        for i in range(5):
            np.testing.assert_array_equal(td[i], jd[i])


def test_missing_root_and_empty_folder(tmp_path):
    with pytest.raises(FileNotFoundError):
        TD.get_dataset("LSUN", str(tmp_path / "nope"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        TD.get_dataset("LSUN", str(tmp_path / "empty"))
    x = np.random.default_rng(0).random((4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(TD.data_transform(x), JD.data_transform(x))
    np.testing.assert_array_equal(TD.inverse_data_transform(x * 3 - 1),
                                  JD.inverse_data_transform(x * 3 - 1))


def test_ckpt_util_over_file_urls(tmp_path, monkeypatch):
    assert tckpt.CKPT_REGISTRY == jckpt.CKPT_REGISTRY
    blob = b"pretend-torch-checkpoint" * 1000
    src = tmp_path / "weights.pt"
    src.write_bytes(blob)
    url = "file://" + str(src)
    md5 = hashlib.md5(blob).hexdigest()
    assert tckpt.md5_hash(str(src)) == jckpt.md5_hash(str(src)) == md5
    monkeypatch.setitem(tckpt.CKPT_REGISTRY, "toy", (url, md5))
    root = str(tmp_path / "cache")
    p = tckpt.get_ckpt_path("toy", root=root)
    assert open(p, "rb").read() == blob
    assert p == os.path.join(root, "toy.pt")
    with open(p, "wb") as f:                  # a corrupt copy is refetched
        f.write(b"corrupt")
    assert tckpt.get_ckpt_path("toy", root=root, check=True) == p
    assert open(p, "rb").read() == blob
    monkeypatch.setitem(tckpt.CKPT_REGISTRY, "bad", (url, "0" * 32))
    with pytest.raises(IOError, match="md5 mismatch"):
        tckpt.get_ckpt_path("bad", root=str(tmp_path / "cache2"))
    assert not os.path.exists(tmp_path / "cache2" / "bad.pt.part")
    with pytest.raises(KeyError):
        tckpt.get_ckpt_path("nope")
