"""PyTorch port, the JPEG decoder (jpeg.py, io.decode_jpeg; baseline and
progressive) against PIL (libjpeg-turbo) on the CPU: PIL encodes, and the
port's decode must be PIL's decode bit for bit.  Also the committed
fixtures under tests/data/jpeg/ and tests/data/timing/ (which
`chip_smoke.py` decodes on the machine without PIL) and the restore CLI
over a folder of one JPEG against the JAX CLI."""
import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import jpeg as tjpeg

from test_torch_ddnm_restore import STEPS, _same_outputs, tiny_models  # noqa

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
TIMING = os.path.join(os.path.dirname(FIXTURES), "timing")

# name: (width, height, grey, PIL save options)
FIXTURE_SPECS = {
    "420": (64, 48, False, dict(quality=75, subsampling=2)),
    "444": (40, 30, False, dict(quality=90, subsampling=0)),
    "grey": (33, 21, True, dict(quality=75)),
    "restart": (45, 37, False, dict(quality=75, subsampling=2,
                                    restart_marker_blocks=2)),
    "odd_422": (17, 23, False, dict(quality=50, subsampling=1)),
    "prog_420": (64, 48, False, dict(quality=75, subsampling=2,
                                     progressive=True)),
    "prog_444": (40, 30, False, dict(quality=90, subsampling=0,
                                     progressive=True)),
    "prog_grey": (33, 21, True, dict(quality=75, progressive=True)),
    "prog_restart": (45, 37, False, dict(quality=75, subsampling=2,
                                         restart_marker_blocks=2,
                                         progressive=True)),
}


def _image(w, h, seed, grey=False):
    """Smooth ramps plus noise, so that every block has AC terms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
    img = np.clip(base + rng.integers(0, 55, (h, w, 3)), 0, 255).astype(
        np.uint8)
    return img[..., 0] if grey else img


def _encode(img, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _port(data: bytes) -> np.ndarray:
    a = tjpeg.decode_jpeg(data)
    return np.repeat(a, 3, -1) if a.shape[-1] == 1 else a


def _timing_jpeg() -> bytes:
    from test_torch_webp import photo

    return _encode(photo(512, 384, 3), quality=80, progressive=True)


def make_fixtures(root: str, timing_root=None) -> None:
    """Write each fixture's JPEG and PIL's decode of it as PNG; with
    `timing_root`, also the 512x384 progressive timing fixture and the
    SHA-256 of PIL's decoded bytes."""
    os.makedirs(root, exist_ok=True)
    for k, (name, (w, h, grey, opts)) in enumerate(FIXTURE_SPECS.items()):
        data = _encode(_image(w, h, 100 + k, grey), **opts)
        with open(os.path.join(root, f"{name}.jpg"), "wb") as f:
            f.write(data)
        Image.fromarray(_pil(data)).save(os.path.join(root, f"{name}.png"))
    if timing_root is not None:
        os.makedirs(timing_root, exist_ok=True)
        data = _timing_jpeg()
        with open(os.path.join(timing_root, "jpeg_prog_512x384.jpg"),
                  "wb") as f:
            f.write(data)
        with open(os.path.join(timing_root, "jpeg_prog_512x384.sha256"),
                  "w") as f:
            f.write(hashlib.sha256(_pil(data).tobytes()).hexdigest() + "\n")


@pytest.mark.parametrize("w,h", [(17, 23), (64, 64), (333, 250)])
@pytest.mark.parametrize("sub", [0, 1, 2])
def test_decode_is_bit_equal_to_pil(w, h, sub):
    for q in (50, 75, 95) if (w, h) != (333, 250) else (75,):
        data = _encode(_image(w, h, w + sub + q), quality=q,
                       subsampling=sub)
        got = _port(data)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil(data), err_msg=str(q))


@pytest.mark.parametrize("case", ["grey", "restart", "restart_rows",
                                  "optimized", "411", "tiny"])
def test_decode_other_streams_bit_equal_to_pil(case):
    img = _image(45, 37, 7)
    data = {
        "grey": lambda: _encode(img[..., 0], quality=75),
        "restart": lambda: _encode(img, quality=75, subsampling=2,
                                   restart_marker_blocks=2),
        "restart_rows": lambda: _encode(img, quality=95, subsampling=1,
                                        restart_marker_rows=1),
        "optimized": lambda: _encode(img, quality=75, optimize=True),
        "411": lambda: _encode(img, quality=75, subsampling="4:1:1"),
        "tiny": lambda: _encode(img[:2, :3], quality=75),
    }[case]()
    got = tjpeg.decode_jpeg(data)
    if case == "grey":
        assert got.shape == (37, 45, 1)
    np.testing.assert_array_equal(_port(data), _pil(data))


def test_unsupported_frames_raise_by_name(tmp_path):
    img = _image(24, 16, 3)
    # progressive frames are read now: PIL's decode, bit for bit
    prog = _encode(img, quality=75, progressive=True)
    assert b"\xff\xc2" in prog
    np.testing.assert_array_equal(_port(prog), _pil(prog))
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    with pytest.raises(NotImplementedError, match="CMYK"):
        tjpeg.decode_jpeg(cmyk.getvalue())
    # arithmetic coding and 12-bit samples, by their frame headers
    base = bytearray(_encode(img, quality=75))
    sof = base.index(b"\xff\xc0")
    arith = bytearray(base)
    arith[sof + 1] = 0xC9
    with pytest.raises(NotImplementedError, match="arithmetic"):
        tjpeg.decode_jpeg(bytes(arith))
    twelve = bytearray(base)
    twelve[sof + 1] = 0xC1
    twelve[sof + 4] = 12
    with pytest.raises(NotImplementedError, match="12-bit"):
        tjpeg.decode_jpeg(bytes(twelve))
    with pytest.raises(ValueError, match="not a JPEG"):
        tjpeg.decode_jpeg(b"\x89PNG....")


@pytest.mark.parametrize("w,h", [(17, 23), (64, 64), (333, 250)])
@pytest.mark.parametrize("sub", [0, 1, 2])
def test_progressive_is_bit_equal_to_pil(w, h, sub):
    for q in (50, 75, 95) if (w, h) != (333, 250) else (75,):
        data = _encode(_image(w, h, w + sub + q), quality=q,
                       subsampling=sub, progressive=True)
        assert b"\xff\xc2" in data
        got = _port(data)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil(data), err_msg=str(q))


@pytest.mark.parametrize("case", ["grey", "restart", "restart_rows",
                                  "optimized", "411", "tiny"])
def test_progressive_other_streams_bit_equal_to_pil(case):
    img = _image(45, 37, 8)
    opts = dict(quality=75, progressive=True)
    data = {
        "grey": lambda: _encode(img[..., 0], **opts),
        "restart": lambda: _encode(img, subsampling=2,
                                   restart_marker_blocks=3, **opts),
        "restart_rows": lambda: _encode(img, subsampling=1,
                                        restart_marker_rows=1, **opts),
        "optimized": lambda: _encode(img, optimize=True, **opts),
        "411": lambda: _encode(img, subsampling="4:1:1", **opts),
        "tiny": lambda: _encode(img[:2, :3], **opts),
    }[case]()
    np.testing.assert_array_equal(_port(data), _pil(data))


def test_incomplete_progressive_raises_naming_block_smoothing():
    # a file cut after its third scan: libjpeg-turbo smooths the blocks of
    # such a file (jdcoefct.c), which the port does not do
    data = _encode(_image(48, 40, 6), quality=75, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) > 4
    cut = data[:sos[3]] + b"\xff\xd9"
    assert _pil(cut).shape == (40, 48, 3)
    with pytest.raises(NotImplementedError, match="block smoothing"):
        tjpeg.decode_jpeg(cut)
    # the first (DC) scan alone: smoothing too (no AC bits are known)
    with pytest.raises(NotImplementedError, match="block smoothing"):
        tjpeg.decode_jpeg(data[:sos[1]] + b"\xff\xd9")


def test_progressive_timing_fixture_hash():
    got = tio.load_image(os.path.join(TIMING, "jpeg_prog_512x384.jpg"))
    want = open(os.path.join(TIMING, "jpeg_prog_512x384.sha256")).read()
    assert got.shape == (384, 512, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want.strip()


def test_idct_matches_the_float_dct():
    # ISLOW against the exact inverse DCT: within one level (libjpeg's
    # accuracy), on random dequantised blocks
    rng = np.random.default_rng(0)
    coef = rng.integers(-200, 200, (50, 64)) * (rng.random((50, 64)) < 0.3)
    coef[:, 0] = rng.integers(-500, 500, 50)
    got = tjpeg.idct_islow(coef).astype(np.int64)
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(0.5), 1.0)
    basis = c[None, :] * np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi
                                / 16) / 2                    # [x, u]
    want = np.einsum("xu,nuv,yv->nxy", basis, coef.reshape(-1, 8, 8),
                     basis) + 128
    want = np.clip(np.round(want), 0, 255)
    assert np.abs(got - want).max() <= 1


def test_fixtures_decode_to_their_pil_pngs(tmp_path):
    # the committed files are what make_fixtures writes with this PIL
    make_fixtures(str(tmp_path), str(tmp_path / "timing"))
    for f in ("jpeg_prog_512x384.jpg", "jpeg_prog_512x384.sha256"):
        assert open(os.path.join(TIMING, f), "rb").read() == open(
            tmp_path / "timing" / f, "rb").read(), f
    total = 0
    for name in FIXTURE_SPECS:
        for ext in (".jpg", ".png"):
            committed = os.path.join(FIXTURES, name + ext)
            total += os.path.getsize(committed)
            if ext == ".jpg":
                assert open(committed, "rb").read() == open(
                    tmp_path / (name + ext), "rb").read(), name
        got = tio.load_rgb_uint8(os.path.join(FIXTURES, name + ".jpg"))
        np.testing.assert_array_equal(
            got, tio.load_png(os.path.join(FIXTURES, name + ".png")))
    assert total < 64 * 1024


def test_load_image_registers_jpeg_and_refuses_webp(tmp_path):
    # JPEG and WebP are both registered now: each reads as PIL reads it
    img = _image(20, 12, 5)
    for ext in (".jpg", ".jpeg", ".JPG"):
        p = str(tmp_path / ("a" + ext))
        Image.fromarray(img).save(p, "JPEG", quality=80)
        np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                      np.asarray(Image.open(p).convert(
                                          "RGB")))
    p = str(tmp_path / "a.webp")
    Image.fromarray(img).save(p, "WEBP", quality=80)
    np.testing.assert_array_equal(tio.load_image(p),
                                  np.asarray(Image.open(p)))
    np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                  np.asarray(Image.open(p).convert("RGB")))


def test_restore_cli_over_a_jpeg_folder_matches_jax(tiny_models, tmp_path,
                                                    monkeypatch):
    from pointdreamer_tpu.cli import ddnm_restore as jcli
    from pointdreamer_tpu_torch.cli import ddnm_restore as tcli

    root = tmp_path / "imgs"
    os.makedirs(root)
    Image.fromarray(_image(300, 260, 9)).save(root / "a.jpg", quality=85)
    argv = ["--image_dir", str(root), "--dataset", "IMAGENET", "--deg",
            "inpainting", "--batch", "1", "--steps", str(STEPS)]
    monkeypatch.setattr("sys.argv", ["ddnm_restore"] + argv
                        + ["--out", str(tmp_path / "jax")])
    jcli.main()
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert _same_outputs(tmp_path / "jax", tmp_path / "port") == [
        "a.png", "a_degraded.png"]
