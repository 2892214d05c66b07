"""PyTorch port, the data and debug tools (data/sample.py, mesh.py,
vis.py) against the JAX package's (data/sample.py, core/mesh.py,
core/vis.py) on the CPU."""
import io
import json
import struct

import numpy as np
import pytest
from PIL import Image

from pointdreamer_tpu.core import mesh as jmesh
from pointdreamer_tpu.core import vis as jvis
from pointdreamer_tpu.data import sample as jsample
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import mesh as tmesh
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch import vis as tvis
from pointdreamer_tpu_torch.data import sample as tsample
from pointdreamer_tpu_torch.pipeline import unwrap as tunwrap


@pytest.fixture(scope="module")
def cube():
    """The cube's textured mesh: the port's unwrap (the JAX package's,
    test_torch_pipeline.py) and a smooth random 64^2 texture."""
    v, f = synthetic.cube_mesh(4)
    uvs, fuv = tunwrap.unwrap(v, f, atlas_res=64)
    rng = np.random.default_rng(0)
    tex = np.clip(rng.random((64, 64, 3)) * 0.5
                  + np.linspace(0, 0.5, 64)[:, None, None], 0, 1)
    return v.astype(np.float32), f, uvs, fuv, tex.astype(np.float32)


# ---------------------------------------------------------------------------
# the sampler

def test_sampler_matches_jax(cube):
    v, f, uvs, fuv, tex = cube
    want = jsample.sample_colored_pc_from_mesh(v, f, uvs, fuv, tex, 5000, 3)
    got = tsample.sample_colored_pc_from_mesh(v, f, uvs, fuv, tex, 5000, 3,
                                              device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("coords", "normals", "uvs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["colors"], want["colors"], atol=1e-6,
                               rtol=0)
    grey = tsample.sample_colored_pc_from_mesh(v, f, n_points=10,
                                               device="cpu")
    np.testing.assert_array_equal(
        grey["colors"], jsample.sample_colored_pc_from_mesh(
            v, f, n_points=10)["colors"])


def test_sample_from_obj_matches_jax(cube, tmp_path):
    v, f, uvs, fuv, tex = cube
    obj = str(tmp_path / "m.obj")
    tmesh.Mesh(v, f, uvs, fuv, tex).write(obj)
    want = jsample.sample_from_obj(obj, 2000, 1,
                                   out_ply=str(tmp_path / "j.ply"))
    got = tsample.sample_from_obj(obj, 2000, 1,
                                  out_ply=str(tmp_path / "t.ply"),
                                  device="cpu")
    for k in ("coords", "normals", "uvs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["colors"], want["colors"], atol=1e-6,
                               rtol=0)
    xyz_j, rgb_j = tio.read_ply_xyzrgb(str(tmp_path / "j.ply"))
    xyz_t, rgb_t = tio.read_ply_xyzrgb(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(xyz_t, xyz_j)
    assert np.abs(rgb_t.astype(int) - rgb_j.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# GLB

def _chunks(path):
    data = open(path, "rb").read()
    n, _ = struct.unpack_from("<II", data, 12)
    js = json.loads(data[20:20 + n])
    m, _ = struct.unpack_from("<II", data, 20 + n)
    return js, data[28 + n:28 + n + m]


def _view(js, binary, i):
    v = js["bufferViews"][i]
    return binary[v["byteOffset"]:v["byteOffset"] + v["byteLength"]]


def test_glb_matches_jax(cube, tmp_path):
    v, f, uvs, fuv, tex = cube
    jmesh.Mesh(v, f, uvs, fuv, tex).write(str(tmp_path / "j.glb"))
    tmesh.Mesh(v, f, uvs, fuv, tex).write(str(tmp_path / "t.glb"))
    jj, jb = _chunks(tmp_path / "j.glb")
    tj, tb = _chunks(tmp_path / "t.glb")
    # the PNG encoders differ (PIL's and io.encode_png): the image's
    # length and the buffer's differ, nothing else
    img = jj["images"][0]["bufferView"]
    png_j, png_t = _view(jj, jb, img), _view(tj, tb, img)
    for js in (jj, tj):
        js["bufferViews"][img].pop("byteLength")
        js["buffers"][0].pop("byteLength")
    assert tj == jj
    for i in range(img):            # indices, positions, uvs
        assert _view(tj, tb, i) == _view(jj, jb, i), i
    want = np.asarray(Image.open(io.BytesIO(png_j)))
    np.testing.assert_array_equal(tio.decode_png(png_t), want)
    # read back: the unwelded vertices, the uvs v up, the texture
    back = tmesh.Mesh.load(str(tmp_path / "t.glb"))
    np.testing.assert_array_equal(back.vertices[back.faces], v[f])
    np.testing.assert_allclose(back.uvs[back.face_uv_idx], uvs[fuv],
                               atol=1e-6)
    np.testing.assert_array_equal(back.texture, want / np.float32(255.0))


def test_mesh_writes_obj_and_ply_as_jax(cube, tmp_path):
    v, f, uvs, fuv, tex = cube
    for pkg, root in ((jmesh, tmp_path / "j"), (tmesh, tmp_path / "t")):
        m = pkg.Mesh(v, f, uvs, fuv, tex)
        m.write(str(root / "m.obj"))
        m.write(str(root / "m.ply"))
    j, t = tmp_path / "j", tmp_path / "t"
    assert open(t / "m.obj").read() == open(j / "m.obj").read()
    assert open(t / "m.mtl").read() == open(j / "m.mtl").read()
    np.testing.assert_array_equal(tio.load_png(str(t / "m.png")),
                                  np.asarray(Image.open(j / "m.png")))
    for a, b in zip(tio.read_ply_xyzrgb(str(t / "m.ply")),
                    tio.read_ply_xyzrgb(str(j / "m.ply"))):
        np.testing.assert_array_equal(a, b)
    back = tmesh.Mesh.load(str(t / "m.obj"))
    np.testing.assert_array_equal(back.faces, f)
    with pytest.raises(ValueError, match="unknown mesh format"):
        tmesh.Mesh(v, f).write(str(tmp_path / "x.stl"))


# ---------------------------------------------------------------------------
# vis

def test_cat_images_matches_jax():
    rng = np.random.default_rng(2)
    imgs = [rng.random((10, 7, 3)).astype(np.float32),
            rng.random((6, 5)).astype(np.float32),
            rng.random((8, 4, 3)).astype(np.float32)]
    np.testing.assert_array_equal(tvis.cat_images(*imgs, pad=3),
                                  jvis.cat_images(*imgs, pad=3))


def test_viridis_table_matches_matplotlib():
    import matplotlib

    want = np.asarray(matplotlib.colormaps["viridis"](
        np.arange(256) / 255.0))[:, :3]
    assert tvis.VIRIDIS.shape == (256, 3)
    assert np.abs(tvis.VIRIDIS / 255.0 - want).max() <= 1 / 255
    # imshow's scaling: min -> entry 0, max -> entry 255
    a = np.array([[0.0, 1.0], [2.0, 4.0]])
    got = tvis.colormap(a)
    np.testing.assert_array_equal(got[0, 0], tvis.VIRIDIS[0] / np.float32(255))
    np.testing.assert_array_equal(got[1, 1],
                                  tvis.VIRIDIS[255] / np.float32(255))


def test_image_sheet_layout(tmp_path):
    rng = np.random.default_rng(3)
    imgs = [rng.random((30, 40, 3)).astype(np.float32),
            rng.random((25, 25)).astype(np.float32),
            (rng.random((13, 9, 4)) * 255).astype(np.uint8)]
    path = str(tmp_path / "sheet.png")
    tile, cols, pad = 64, 2, 4
    sheet = tvis.save_image_sheet(imgs, path, titles=["a", "bb", "ccc"],
                                  cols=cols, tile=tile)
    assert sheet.shape == (2 * (tile + tvis.FONT_H + 4 + pad) + pad,
                           cols * (tile + pad) + pad, 3)
    np.testing.assert_array_equal(tio.load_png(path), tio.to_uint8(sheet))
    for i, img in enumerate(imgs):
        rgb = tvis.as_rgb(img)
        r, c = divmod(i, cols)
        cy = pad + r * (tile + tvis.FONT_H + 4 + pad) + tvis.FONT_H + 4 \
            + tile // 2
        cx = pad + c * (tile + pad) + tile // 2
        s = tile / max(rgb.shape[:2])
        h, w = round(rgb.shape[0] * s), round(rgb.shape[1] * s)
        oy = cy - (pad + r * (tile + tvis.FONT_H + 4 + pad)
                   + tvis.FONT_H + 4 + (tile - h) // 2)
        ox = cx - (pad + c * (tile + pad) + (tile - w) // 2)
        want = rgb[int((oy + 0.5) * rgb.shape[0] / h),
                   int((ox + 0.5) * rgb.shape[1] / w)]
        np.testing.assert_array_equal(sheet[cy, cx], want)
        # the title: dark pixels in the strip above the tile
        strip = sheet[pad + r * (tile + tvis.FONT_H + 4 + pad):
                      pad + r * (tile + tvis.FONT_H + 4 + pad)
                      + tvis.FONT_H + 4,
                      pad + c * (tile + pad):pad + c * (tile + pad) + tile]
        assert (strip.max(-1) == 0).any()


def test_pointcloud_views_show_the_bounding_boxes(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.random((500, 3)) * np.array([2.0, 1.0, 0.5])
    rgb = rng.random((500, 3))
    res, size = 64, 1.0
    pic = tvis.save_pointcloud_views(xyz, rgb, str(tmp_path / "pc.png"),
                                     size=size, res=res)
    np.testing.assert_array_equal(tio.load_png(str(tmp_path / "pc.png")),
                                  tio.to_uint8(pic))
    pad, margin = 4, int(size) + 2
    for k, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
        panel = pic[pad:pad + res, pad + k * (res + pad):
                    pad + k * (res + pad) + res]
        ys, xs = np.nonzero((panel < 1.0).any(-1))
        col, row = tvis.panel_pixels(xyz[:, i], xyz[:, j], res, margin)
        r = int(size)
        assert (xs.min(), xs.max()) == (col.min() - r, col.max() + r)
        assert (ys.min(), ys.max()) == (row.min() - r, row.max() + r)
        # the longer side spans the panel but its margins
        assert max(col.max() - col.min(), row.max() - row.min()) \
            == res - 1 - 2 * margin
