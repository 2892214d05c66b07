"""PyTorch port, pipeline stages against their pointdreamer_tpu twins:
sparse views, the unwrap (chart masks, charts, packing), the atlas bake,
NBF unprojection and neighbour completion; then the slice as a whole, the
port's Pipeline against the JAX package's: `.ply` + cached
`_untextured_mesh.obj` -> textured OBJ/MTL/PNG, and `.ply` alone (the
mesh reconstructed by SPR) -> textured OBJ/MTL/PNG."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointdreamer_tpu.pipeline.optimize as jopt
import pointdreamer_tpu_torch.pipeline.optimize as topt
from pointdreamer_tpu.core.camera import make_camera_rig as jrig
from pointdreamer_tpu.core.config import load_config as jload
from pointdreamer_tpu.pipeline import complete as jcomplete
from pointdreamer_tpu.pipeline import inpaint as jinpaint
from pointdreamer_tpu.pipeline import project as jproject
from pointdreamer_tpu.pipeline import unproject as junproject
from pointdreamer_tpu.pipeline import unwrap as junwrap
from pointdreamer_tpu.pipeline.pipeline import Pipeline as JPipeline
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.camera import make_camera_rig as trig
from pointdreamer_tpu_torch.config import load_config as tload
from pointdreamer_tpu_torch.pipeline import complete as tcomplete
from pointdreamer_tpu_torch.pipeline import project as tproject
from pointdreamer_tpu_torch.pipeline import unproject as tunproject
from pointdreamer_tpu_torch.pipeline import unwrap as tunwrap
from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline as TPipeline

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rotated_cube(n_div=8, n_points=3000):
    """A cube turned off the axes (no view sees an edge exactly on a
    pixel centre), mesh + coloured cloud, normalized like the pipeline."""
    from scipy.spatial.transform import Rotation

    rot = Rotation.from_euler("xyz", [17, 29, 11], degrees=True
                              ).as_matrix().astype(np.float32)
    v, f = synthetic.cube_mesh(n_div)
    pts, col = synthetic.cube_cloud(n_points)
    return (v @ rot.T).astype(np.float32), f, (pts @ rot.T).astype(
        np.float32), col


@pytest.fixture
def eager_jump_flood(monkeypatch):
    """The JAX package's two jitted jump-flood fills, run with jit
    disabled.  XLA takes about a minute to compile each of their unrolled
    loops on the CPU and a few seconds to run them op by op; the fills are
    integer distances, selects and gathers, so the results are the same
    (every output file of a pipeline run compares equal)."""
    for mod, name in ((jcomplete, "_write_back_and_fill"),
                      (jinpaint, "inpaint_nearest")):
        def run(*a, _fn=getattr(mod, name), **k):
            with jax.disable_jit():
                return _fn(*a, **k)
        monkeypatch.setattr(mod, name, run)


def _t(x):
    return x if isinstance(x, float) else torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("n_points", [3000, 150])
def test_sparse_images_match(n_points):
    # the same projection into both make_sparse_images, 128 -> 64 (the
    # antialiased mask resize); 150 points force the shrink-to-fit path
    v, f, pts, col = _rotated_cube(8, n_points)
    proj = jproject.project_views(jrig(8, 1.6, 128), jnp.asarray(v),
                                  jnp.asarray(f.astype(np.int32)),
                                  jnp.asarray(pts), cull_backface=False)
    want = jproject.make_sparse_images(proj, jnp.asarray(col), 64)
    got = tproject.make_sparse_images(
        tproject.ProjectionData(*[_t(x) for x in proj]),
        torch.as_tensor(col), 64)
    if n_points == 150:
        assert (np.asarray(want.scale_factors) < 1).any()
    np.testing.assert_array_equal(got.hard_mask0.numpy(),
                                  np.asarray(want.hard_mask0))
    np.testing.assert_array_equal(got.hard_mask2.numpy(),
                                  np.asarray(want.hard_mask2))
    np.testing.assert_allclose(got.sparse_imgs.numpy(),
                               np.asarray(want.sparse_imgs), atol=1e-5)
    np.testing.assert_allclose(got.scale_factors.numpy(),
                               np.asarray(want.scale_factors), rtol=1e-6)


def test_project_views_match():
    # each package's own raster; masks/ids agree except at a few
    # silhouette pixels where l ~ 0 rounds differently (stated bound)
    v, f, pts, _ = _rotated_cube(8)
    j = jproject.project_views(jrig(8, 1.6, 128), jnp.asarray(v),
                               jnp.asarray(f.astype(np.int32)),
                               jnp.asarray(pts), cull_backface=True)
    t = tproject.project_views(trig(8, 1.6, 128, device="cpu"), torch.as_tensor(v),
                               torch.as_tensor(f), torch.as_tensor(pts),
                               cull_backface=True)
    for k in ("uv_centers", "uv_scales", "point_uvs", "point_depths"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), atol=1e-6)
    assert (t.hard_masks.numpy() != np.asarray(j.hard_masks)).mean() < 1e-4
    assert (t.point_validation.numpy()
            != np.asarray(j.point_validation)).mean() < 1e-3


def test_chart_mask_fill_equals_cv2():
    # the numpy fill against cv2.fillPoly + polylines on random charts:
    # zero differing pixels
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for trial in range(150):
        h, w = rng.integers(5, 80, 2)
        P = int(rng.integers(1, 40))
        if trial % 2:
            base = rng.integers(0, min(h, w) - 4, (P, 1, 2))
            tris = base + rng.integers(0, 5, (P, 3, 2))
        else:
            tris = np.stack([rng.integers(0, w, (P, 3)),
                             rng.integers(0, h, (P, 3))], -1)
        tris = tris.astype(np.int32)
        img = np.zeros((h, w), np.uint8)
        cv2.fillPoly(img, list(tris), 1)
        cv2.polylines(img, list(tris), True, 1)
        np.testing.assert_array_equal(tunwrap._fill_triangles_cv2(h, w, tris),
                                      img.astype(bool))


def test_unwrap_identical():
    v, f, _, _ = _rotated_cube(8)
    juv, jfuv = junwrap.unwrap(v, f, atlas_res=256)
    tuv, tfuv = tunwrap.unwrap(v, f, atlas_res=256)
    np.testing.assert_array_equal(tuv, juv)
    np.testing.assert_array_equal(tfuv, jfuv)


@pytest.fixture(scope="module")
def baked():
    # the mesh and atlas size of test_slice_matches_jax_pipeline, so the
    # JAX package's jitted completion compiles once for both
    v, f, pts, col = _rotated_cube(10, 4000)
    uv, fuv = junwrap.unwrap(v, f, atlas_res=256)
    j = junwrap.bake_atlas(jnp.asarray(v), jnp.asarray(f.astype(np.int32)),
                           uv, fuv, 256)
    t = tunwrap.bake_atlas(v, f, uv, fuv, 256, device="cpu")
    return v, f, pts, col, uv, fuv, j, t


def test_bake_atlas_matches(baked):
    # JAX bakes with the XLA tiled rasterizer, the port with K1's plain
    # version.  Coverage agrees but for chart-edge texels where l ~ 0
    # rounds to the other side (71 of 65536 texels here, bound 0.5%).
    # Depth is 1 everywhere, so a texel that two faces cover is an exact
    # z tie: there the ids may differ (60 here, bound 1%).  gb_pos agrees
    # within 5e-5 (measured 1.4e-5): the two rasterizers round the
    # barycentrics differently, and the affine form l = A x + B y + C sums
    # terms of size ~R/s for a face s texels across, so at R = 256 a few
    # f32 roundings put ~1e-5 on each l.
    *_, j, t = baked
    jm, tm = np.asarray(j["mask"]), t["mask"].numpy()
    assert (jm != tm).mean() < 5e-3
    both = jm & tm
    jf = np.asarray(j["per_atlas_pixel_face_id"])
    tf = t["per_atlas_pixel_face_id"].numpy()
    assert (jf[both] != tf[both]).mean() < 1e-2
    np.testing.assert_allclose(t["gb_pos"].numpy()[both],
                               np.asarray(j["gb_pos"])[both], atol=5e-5)


def test_unproject_and_complete_match(baked, eager_jump_flood):
    # the same bake, depths and views into both unproject and
    # complete_by_neighbors
    v, f, pts, col, uv, fuv, j, _ = baked
    rig_j = jrig(8, 1.6, 128)
    proj = jproject.project_views(rig_j, jnp.asarray(v),
                                  jnp.asarray(f.astype(np.int32)),
                                  jnp.asarray(pts), cull_backface=True)
    rng = np.random.default_rng(7)
    views = rng.random((8, 64, 64, 3)).astype(np.float32)
    scale = np.array([1, 0.9, 1, 1, 0.8, 1, 1, 1], np.float32)
    from pointdreamer_tpu.ops.raster import face_normals

    fn = face_normals(jnp.asarray(v), jnp.asarray(f.astype(np.int32)))
    args = (proj.mesh_depths, proj.uv_centers, proj.uv_scales, proj.padding,
            scale)
    ju = junproject.unproject(jnp.asarray(views), rig_j, fn, j["gb_pos"],
                              j["mask"], j["per_atlas_pixel_face_id"],
                              *args, kernel_sizes=(21,), view_res=64)
    tu = tunproject.unproject(
        torch.as_tensor(views), trig(8, 1.6, 128, device="cpu"), _t(fn), _t(j["gb_pos"]),
        _t(j["mask"]), _t(j["per_atlas_pixel_face_id"]),
        *[_t(a) for a in args], kernel_sizes=(21,), view_res=64)
    np.testing.assert_array_equal(tu.texel_view_id.numpy(),
                                  np.asarray(ju.texel_view_id))
    np.testing.assert_array_equal(tu.shrunk_visibility.numpy(),
                                  np.asarray(ju.shrunk_visibility))
    np.testing.assert_array_equal(tu.atlas_img.numpy(),
                                  np.asarray(ju.atlas_img))
    assert np.asarray(ju.atlas_painted).mean() > 0.1

    want = jcomplete.complete_by_neighbors(
        v, f, uv, fuv, ju.atlas_img, ju.atlas_painted, j["mask"],
        j["per_atlas_pixel_face_id"])
    got = tcomplete.complete_by_neighbors(
        v, f, uv, fuv, tu.atlas_img, tu.atlas_painted, _t(j["mask"]),
        _t(j["per_atlas_pixel_face_id"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


SMALL = dict(cam_res=128, res=64, xatlas_texture_res=256, optimize_iters=10)


def _write_inputs(d) -> str:
    """The rotated 10x10-gridded cube and 4000 coloured surface samples
    as `cube_untextured_mesh.obj` + `cube.ply`."""
    v, f, pts, col = _rotated_cube(10, 4000)
    os.makedirs(d, exist_ok=True)
    tio.save_obj(v, f, os.path.join(d, "cube_untextured_mesh.obj"))
    ply = os.path.join(d, "cube.ply")
    tio.save_colored_pc_ply(pts, col, ply)
    return ply


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return 10 * np.log10(1.0 / max(mse, 1e-20))


def _run(load, pipeline_cls, out, ply, **create_kw):
    cfg = load(os.path.join(REPO, "configs", "nearest.yaml"))
    cfg.output_path = out
    for k, v in SMALL.items():
        setattr(cfg, k, v)
    obj = pipeline_cls.create(cfg, **create_kw).recon_one_textured_mesh(ply)
    root = os.path.dirname(os.path.dirname(obj))
    rgba = tio.load_png(os.path.join(root, "others",
                                     "atlas_wo_background.png"))
    return dict(
        atlas=tio.load_rgb(obj[:-4] + ".png"), mask=rgba[..., 3] > 0,
        uvs=np.load(os.path.join(root, "geo", "unwrap_256.npz"))["uvs"],
        views=[tio.load_rgb(os.path.join(root, "others", f"{i}_{kind}.png"))
               for kind in ("sparse", "inpainted") for i in range(8)])


def test_slice_matches_jax_pipeline(tmp_path, monkeypatch,
                                    eager_jump_flood):
    # texture method 'nearest': jax.random and torch draw different DDNM
    # noise.  Both pipelines' optimize_color inputs are recorded, so the
    # stages before and after the optimizer are held apart.
    ply = _write_inputs(str(tmp_path / "in"))
    before = {}
    for name, mod, to_np in (("jax", jopt, np.asarray),
                             ("torch", topt, lambda t: t.numpy())):
        def record(atlas_img, *a, _f=mod.optimize_color, _n=name,
                   _to_np=to_np, **k):
            before[_n] = _to_np(atlas_img)
            return _f(atlas_img, *a, **k)
        monkeypatch.setattr(mod, "optimize_color", record)
    want = _run(jload, JPipeline, str(tmp_path / "jax"), ply)
    got = _run(tload, TPipeline, str(tmp_path / "torch"), ply, device="cpu")

    np.testing.assert_array_equal(got["uvs"], want["uvs"])
    for g, w in zip(got["views"], want["views"]):
        np.testing.assert_array_equal(g, w)          # 8-bit PNGs: exact
    # the bakes differ at chart-edge texels where l ~ 0 rounds to the
    # other side (16 of 65536 here)
    assert (got["mask"] != want["mask"]).mean() < 1e-3
    m = got["mask"] & want["mask"]
    # before the optimizer: unproject + completion agree to 75.6 dB
    assert _psnr(before["torch"][m], before["jax"][m]) >= 60.0
    # after 10 Adam steps: >= 40 dB (measured 40.30).  The optimizer's L1
    # sign gradient, normalized by Adam, turns a one-ulp change in a
    # pixel's residual into a full lr step: the JAX pipeline against
    # itself with 1e-7 noise on the optimizer's input reaches only
    # 39.5 dB, so this bar sits at the reference's own noise floor.
    assert _psnr(got["atlas"][m], want["atlas"][m]) >= 40.0


def _to_surface(p, v, f, chunk=256):
    """Distance from each point p [P,3] to the triangle mesh (v, f): the
    nearest of the in-plane projection (when it falls inside a face) and
    the three edge segments, over all faces."""
    a, b, c = (v[f[:, i]].astype(np.float64) for i in range(3))
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    out = []
    for q in np.array_split(p.astype(np.float64),
                            max(1, len(p) // chunk)):
        q = q[:, None, :]
        h = ((q - a) * n).sum(-1)                       # signed height
        x = q - h[..., None] * n                        # projection
        inside = np.ones(h.shape, bool)
        for u, w in ((a, b), (b, c), (c, a)):
            inside &= (np.cross(w - u, x - u) * n).sum(-1) >= 0
        d = np.where(inside, np.abs(h), np.inf)
        for u, w in ((a, b), (b, c), (c, a)):
            e = w - u
            t = np.clip(((q - u) * e).sum(-1) / np.maximum(
                (e * e).sum(-1), 1e-30), 0.0, 1.0)
            d = np.minimum(d, np.linalg.norm(q - u - t[..., None] * e,
                                             axis=-1))
        out.append(d.min(1))
    return np.concatenate(out)


def _surface_chamfer(m1, m2):
    """Symmetric mean distance of each mesh's vertices to the other's
    surface."""
    return 0.5 * (_to_surface(m1["vertices"], m2["vertices"],
                              m2["faces"]).mean()
                  + _to_surface(m2["vertices"], m1["vertices"],
                                m1["faces"]).mean())


def test_slice_without_cached_mesh_matches_jax_pipeline(tmp_path,
                                                        eager_jump_flood):
    # `.ply` alone: both pipelines reconstruct the mesh (geo_from 'POCO'
    # with no network -> SPR, grid 48, 2,000 faces), then texture it
    # (nearest, cam_res 128, res 64, atlas 128).  The two f32 Poisson
    # fields differ by the CG rounding (test_torch_geometry.py), and QEM's
    # collapse order follows: the meshes are compared by symmetric chamfer
    # (<= 1e-3), the mean distance of each mesh's vertices to the other's
    # surface.  Measured: 2,000 faces each, not the same face for face, so
    # the atlases (laid out on different meshes) are not compared.
    _, _, pts, col = _rotated_cube(10, 4000)
    d = str(tmp_path / "in")
    os.makedirs(d)
    ply = os.path.join(d, "cube.ply")
    tio.save_colored_pc_ply(pts, col, ply)
    small = dict(grid_res=48, target_face_num=2000, cam_res=128, res=64,
                 xatlas_texture_res=128, optimize_iters=10)
    objs = {}
    for name, load, cls, kw in (("jax", jload, JPipeline, {}),
                                ("torch", tload, TPipeline,
                                 dict(device="cpu"))):
        cfg = load(os.path.join(REPO, "configs", "nearest.yaml"))
        cfg.output_path = str(tmp_path / name)
        for k, v in small.items():
            setattr(cfg, k, v)
        with pytest.warns(UserWarning, match="falling back"):
            obj = cls.create(cfg, **kw).recon_one_textured_mesh(ply)
        for ext in (".obj", ".mtl", ".png"):
            assert os.path.exists(obj[:-4] + ext)
        objs[name] = obj
    want, got = (tio.load_obj(objs[k]) for k in ("jax", "torch"))
    assert abs(len(got["faces"]) - len(want["faces"])) \
        <= 0.01 * len(want["faces"])
    assert _surface_chamfer(got, want) <= 1e-3          # measured 3.0e-5
    if (len(got["faces"]) == len(want["faces"])
            and (got["faces"] == want["faces"]).all()):
        # identical face for face: the atlases then compare at the bar of
        # test_slice_matches_jax_pipeline (not the case in the measured
        # run, see above)
        a_t = tio.load_rgb(objs["torch"][:-4] + ".png")
        a_j = tio.load_rgb(objs["jax"][:-4] + ".png")
        assert _psnr(a_t, a_j) >= 40.0
    # the reconstructed mesh is kept as the shape's own stage cache
    own = tio.load_obj(os.path.join(os.path.dirname(os.path.dirname(
        objs["torch"])), "geo", "untextured.obj"))
    assert len(own["faces"]) == len(got["faces"])
    atlas = tio.load_rgb(objs["torch"][:-4] + ".png")
    assert atlas.shape == (128, 128, 3) and (atlas.max(-1) > 0).mean() > 0.3


def test_quant_int8_is_refused(monkeypatch):
    # the name dates from the slice that refused the flag; since the w8a8
    # UNet is ported, ddnm_quant_int8 reaches load_inpainter as the JAX
    # package passes it (quant_int8, quant_static), and without it the
    # inpainter is the fp one, whatever ddnm_quant_static says
    import pointdreamer_tpu_torch.models.diffusion as tdiff

    built = []

    def spy(*a, **kw):
        built.append(kw)
        return "inpainter"

    monkeypatch.setattr(tdiff, "load_inpainter", spy)
    cfg = tload(os.path.join(REPO, "configs", "default.yaml"))
    for static in (True, False):
        cfg.ddnm_quant_int8, cfg.ddnm_quant_static = True, static
        pipe = TPipeline.create(cfg, device="cpu",
                                allow_random_diffusion=True)
        assert pipe.inpainter == "inpainter"
        assert built[-1]["quant_int8"] is True
        assert built[-1]["quant_static"] is static
    cfg.ddnm_quant_int8, cfg.ddnm_quant_static = False, True
    pipe = TPipeline.create(cfg, device="cpu", allow_random_diffusion=True)
    assert pipe.inpainter == "inpainter" and len(built) == 3
    assert built[-1]["quant_int8"] is False
