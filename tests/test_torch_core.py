"""PyTorch port, host core: config loading, camera rig, PLY/OBJ/PNG IO.

Each port function is held against its pointdreamer_tpu twin on the same
numpy inputs."""
import glob
import os

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
    got = tcfg.parse_yaml_subset(
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


def test_save_rgb_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.random((20, 30, 3)).astype(np.float32)
    tio.save_rgb(torch.as_tensor(img), str(tmp_path / "t.png"),
                 flip_vertical=True)
    jio.save_rgb(img, str(tmp_path / "j.png"), flip_vertical=True)
    np.testing.assert_array_equal(tio.load_rgb(str(tmp_path / "t.png")),
                                  jio.load_rgb(str(tmp_path / "j.png")))
