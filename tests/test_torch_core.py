"""PyTorch port, host core: config loading, camera rig, PLY/OBJ/PNG IO.

Each port function is held against its pointdreamer_tpu twin on the same
numpy inputs."""
import glob
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from pointdreamer_tpu.core import camera as jcam
from pointdreamer_tpu.core import config as jcfg
from pointdreamer_tpu.core import io as jio
from pointdreamer_tpu_torch import camera as tcam
from pointdreamer_tpu_torch import config as tcfg
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import yamlread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_matches_jax_loader(path):
    # every field and the unknown-key bag must be identical
    j = jcfg.load_config(path)
    t = tcfg.load_config(path)
    assert tcfg.dataclasses.asdict(t) == jcfg.dataclasses.asdict(j)
    assert t.extra == j.extra


def test_config_subset_parser_scalars():
    got = yamlread.safe_load(
        "a: 'x'  # c\nb: True\nc: None\nd: [21, 11]\ne: 1.5\nf: 1e-2\n"
        "g: ~\nh: \"q # not a comment\"\n")
    assert got == {"a": "x", "b": True, "c": "None", "d": [21, 11],
                   "e": 1.5, "f": "1e-2", "g": None,
                   "h": "q # not a comment"}


def test_camera_rig_matches_jax():
    # eyes, NDC and linear depth of the 8-view fibonacci rig within 1e-6
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    j = jcam.make_camera_rig(8, 1.6, 512)
    t = tcam.make_camera_rig(8, 1.6, 512, device="cpu")
    np.testing.assert_allclose(t.eyes.numpy(), np.asarray(j.eyes), atol=1e-6)
    np.testing.assert_allclose(t.rot.numpy(), np.asarray(j.rot), atol=1e-6)
    jn, jd = j.transform(pts)
    tn, td = t.transform(torch.as_tensor(pts))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert t.tan_half_fov == j.tan_half_fov


def test_ply_obj_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.standard_normal((100, 3)).astype(np.float32)
    rgb = rng.random((100, 3)).astype(np.float32)
    tio.save_colored_pc_ply(xyz, rgb, str(tmp_path / "a.ply"))
    x1, c1 = tio.read_ply_xyzrgb(str(tmp_path / "a.ply"))
    x2, c2 = jio.read_ply_xyzrgb(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(x1, xyz)
    np.testing.assert_array_equal(c1, c2)

    faces = rng.integers(0, 100, (50, 3))
    uvs = rng.random((80, 2)).astype(np.float32)
    fuv = rng.integers(0, 80, (50, 3))
    tio.save_textured_obj(xyz, uvs, faces, fuv, str(tmp_path / "m.obj"))
    jio.save_textured_obj(xyz, uvs, faces, fuv, str(tmp_path / "j.obj"))
    assert (tmp_path / "m.obj").read_text().replace("m.mtl", "j.mtl") == \
        (tmp_path / "j.obj").read_text()
    a, b = tio.load_obj(str(tmp_path / "m.obj")), jio.load_obj(
        str(tmp_path / "j.obj"))
    for k in ("vertices", "faces", "uvs", "face_uv_idx"):
        np.testing.assert_array_equal(a[k], b[k])
    tio.save_obj(xyz, faces, str(tmp_path / "p.obj"))
    np.testing.assert_array_equal(
        tio.load_obj(str(tmp_path / "p.obj"))["faces"], faces)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip_and_pil(tmp_path, channels):
    # the port's zlib+struct PNGs decode identically under PIL, and the
    # port decodes PIL's (filtered) PNGs
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    with open(p, "wb") as f:
        f.write(tio.encode_png(img))
    pil = np.asarray(Image.open(p))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    np.testing.assert_array_equal(tio.load_png(p), img)
    q = str(tmp_path / "b.png")
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(
        q, optimize=True)
    np.testing.assert_array_equal(tio.load_png(q), img)


# ---- PNG variants PIL reads: a small PNG writer for what PIL cannot write

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _png_rows(v, depth):
    rows = []
    for row in v:
        flat = row.reshape(-1)
        if depth == 16:
            rows.append(flat.astype(">u2").tobytes())
        elif depth == 8:
            rows.append(flat.astype(np.uint8).tobytes())
        else:
            bits = (flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1
            rows.append(np.packbits(bits.reshape(-1).astype(
                np.uint8)).tobytes())
    return rows


def _png_filter(rows, bpp):
    """Filter types 0..4 in turn, row by row."""
    out, prev = b"", bytes(len(rows[0]))
    for y, r in enumerate(rows):
        ft = y % 5
        o = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pred = (0, a, b, (a + b) >> 1,
                    a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(
                        p - c) else b if abs(p - b) <= abs(p - c) else c)[ft]
            o[i] = (r[i] - pred) & 255
        out += bytes([ft]) + bytes(o)
        prev = r
    return out


def write_png(v, depth, ctype, interlace=0, plte=None, trns=None) -> bytes:
    h, w, c = v.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_png_filter(_png_rows(v[y0::dy, x0::dx], depth), bpp)
                       for x0, y0, dx, dy in _ADAM7
                       if v[y0::dy, x0::dx].size)
    else:
        raw = _png_filter(_png_rows(v, depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _png_chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(
        b"IEND", b"")


def _png_case(case, interlace, rng):
    kind, depth = case.split("_")[0], int(case.split("_")[1])
    v = rng.integers(0, 1 << depth, (11, 13, 1))
    if kind == "grey":
        return write_png(v, depth, 0, interlace)
    if kind == "greyclip":        # 16-bit grey above 255
        v = np.array([[0], [255], [256], [1000], [65535]])[None]
        return write_png(v, depth, 0, interlace)
    if kind in ("pal", "paltrns"):
        pal = rng.integers(0, 256, (1 << depth, 3))
        trns = bytes(rng.integers(0, 256, max(1, (1 << depth) // 2)).astype(
            np.uint8)) if kind == "paltrns" else None
        return write_png(v, depth, 3, interlace, plte=pal, trns=trns)
    if kind == "greytrns":        # a grey key: alpha 0 where it matches
        return write_png(rng.integers(0, 4, (11, 13, 1)) * 60, depth, 0,
                         interlace, trns=struct.pack(">H", 60))
    if kind == "rgbtrns":
        return write_png(rng.integers(0, 2, (11, 13, 3)) * 200, depth, 2,
                         interlace, trns=struct.pack(">3H", 200, 0, 200))
    c = {"rgb": 3, "ga": 2, "rgba": 4}[kind]
    return write_png(rng.integers(0, 1 << depth, (11, 13, c)), depth,
                     {"rgb": 2, "ga": 4, "rgba": 6}[kind], interlace)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("case", [
    "grey_1", "grey_2", "grey_4", "grey_8", "grey_16", "greyclip_16",
    "pal_1", "pal_2", "pal_4", "pal_8", "paltrns_1", "paltrns_4",
    "paltrns_8", "greytrns_8", "rgbtrns_8", "rgb_8", "rgb_16", "ga_8",
    "ga_16", "rgba_8", "rgba_16"])
def test_png_variants_read_as_pil_converts(case, interlace, tmp_path):
    # what PIL reads and converts, as load_rgb / load_rgba give it
    p = str(tmp_path / "a.png")
    with open(p, "wb") as f:
        f.write(_png_case(case, interlace, np.random.default_rng(
            len(case) + interlace)))
    im = Image.open(p)
    assert im.info.get("interlace", 0) == interlace
    np.testing.assert_array_equal(tio.load_rgb_uint8(p),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(tio.load_rgba_uint8(p),
                                  np.asarray(im.convert("RGBA")))
    np.testing.assert_array_equal(tio.load_rgb(p), jio.load_rgb(p))
    np.testing.assert_array_equal(tio.load_rgba(p), jio.load_rgba(p))


def test_save_rgb_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.random((20, 30, 3)).astype(np.float32)
    tio.save_rgb(torch.as_tensor(img), str(tmp_path / "t.png"),
                 flip_vertical=True)
    jio.save_rgb(img, str(tmp_path / "j.png"), flip_vertical=True)
    np.testing.assert_array_equal(tio.load_rgb(str(tmp_path / "t.png")),
                                  jio.load_rgb(str(tmp_path / "j.png")))
