"""PyTorch port, the DDNM image-folder datasets (models/diffusion/
datasets.py with ops/resample.py) and the checkpoint registry
(models/diffusion/ckpt_util.py) against the JAX package on the CPU.

The JAX datasets preprocess through PIL; the port's numpy copy of PIL's
8-bit resampling gives the same uint8 crops, bit for bit: ImageNet's BOX
halving + BICUBIC + centre crop on 700x520 and 300x260 images, the fixed
CelebA crop + BICUBIC on a 178x218 face, CIFAR10's BILINEAR, read from
PNG, PPM and BMP.  `.jpg` files, which JAX reads through PIL, decode as
PIL decodes them (io.decode_jpeg); `.webp` files are refused by name.
ckpt_util runs over file:// URLs only."""
import hashlib
import os

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
    # JPEG is read now (bit-equal to PIL, tests/test_torch_jpeg.py); WebP
    # is still refused by name
    root = _folder(tmp_path, {"a.png": (64, 64, 16)})
    bad = os.path.join(root, "z" + ext)
    Image.fromarray(_img(64, 64, 17)).save(bad)
    assert len(JD.get_dataset("IMAGENET", root, image_size=32)) == 2
    if ext != ".webp":
        jd = JD.get_dataset("IMAGENET", root, image_size=32)
        td = TD.get_dataset("IMAGENET", root, image_size=32)
        assert td.files == jd.files
        for i in range(2):
            np.testing.assert_array_equal(td[i], jd[i])
        np.testing.assert_array_equal(
            tio.load_rgb_uint8(bad),
            np.asarray(Image.open(bad).convert("RGB")))
        return
    # the JAX package reads it through PIL; the port names the file and
    # the ROADMAP item instead of skipping it
    with pytest.raises(NotImplementedError, match=r"z\%s.*JPEG" % ext):
        TD.get_dataset("IMAGENET", root, image_size=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.load_rgb(bad)
    # --limit leaves it out, as it leaves it unread in the JAX package
    assert len(TD.get_dataset("IMAGENET", root, image_size=32, limit=1)) == 1


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
