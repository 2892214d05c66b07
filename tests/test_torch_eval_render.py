"""PyTorch port, eval/render.py against the JAX package on one seeded mesh:
the gridded cube (n_div 8: 768 faces), randomly perturbed, with seeded
UVs and a seeded 32^2 atlas, at 4 views x 64^2 (fibonacci rig) for the
four renderers, the textured one with and without `light_dir`; then
`render_mesh_dir` (20 blender views at 64^2) through OBJ + PNG.

The JAX package rasterizes on the CPU with XLA's `rasterize_tiled`, the
port with K1's plain version.  They agree on coverage, and on the face id
of every pixel but those where two faces' depths tie (the shared edges of
neighbouring faces); those pixels are counted, checked to be depth ties
(|z_jax - z_port| <= 1e-5), bounded (<= 1% of the covered pixels) and
left out.  Their barycentrics differ too: K1 evaluates each face's
affine coefficients, l = A x + B y + C (the formula of the Pallas binned
kernel it replaces), where XLA's path evaluates edge functions relative
to a corner; C cancels against A x + B y, by up to 1.5e-4 at 64^2 on
this mesh.  So each render is held, per pixel, within what the two
barycentrics dl (the largest |l_jax - l_port| of the pixel) allow, plus 1e-5 (fp32 interpolation):
- mask and coverage: exact; the normal render (per face): 1e-5;
- vertex colours in [0,1]: 3 dl + 1e-5;
- the textured render (32^2 atlas in [0,1], bilinear): 2 R 3 dl + 1e-5
  with R = 32, the shading a per-face factor <= 1;
- render_mesh_dir's PNGs: every 8-bit value within 1 LSB of the JAX
  package's, where dl allows no more than half an LSB; elsewhere within
  that bound, rounded up to whole LSBs.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.core import camera as jcam
from pointdreamer_tpu.eval import render as jrender
from pointdreamer_tpu.ops import raster as jraster
from pointdreamer_tpu_torch import camera as tcam
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.eval import render as trender
from pointdreamer_tpu_torch.ops import raster as traster


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    v, f = synthetic.cube_mesh(8)
    v = (v + rng.normal(0, 0.01, v.shape)).astype(np.float32)
    uvs = rng.random((len(v), 2)).astype(np.float32)
    atlas = rng.random((32, 32, 3)).astype(np.float32)
    colors = rng.random((len(v), 3)).astype(np.float32)
    return dict(v=v, f=f, uvs=uvs, fuv=f.copy(), atlas=atlas, colors=colors)


def _rigs(n=4, res=64, distribution="fibonacci_sphere"):
    return (jcam.make_camera_rig(n, res=res, distribution=distribution),
            tcam.make_camera_rig(n, res=res, distribution=distribution,
                                 device="cpu"))


@pytest.fixture(scope="module")
def face_ids(scene):
    """Both packages' face ids and z of the 4 x 64^2 views, and the pixels
    where they agree."""
    jr, tr = _rigs()
    ndc, depth = jr.transform(jnp.asarray(scene["v"]))
    want = jraster.rasterize_views(ndc, depth, jnp.asarray(scene["f"]), 64)
    ndc_t, depth_t = tr.transform(torch.as_tensor(scene["v"]))
    got = traster.rasterize_views(ndc_t, depth_t,
                                  torch.as_tensor(scene["f"]), 64)
    fj, ft = np.asarray(want.face_id), got.face_id.numpy()
    zj, zt = np.asarray(want.zbuf), got.zbuf.numpy()
    assert np.array_equal(fj >= 0, ft >= 0)
    differ = fj != ft
    covered = int((fj >= 0).sum())
    assert covered > 0.2 * fj.size
    # each differing pixel is a depth tie between the two faces
    assert np.abs(zj[differ] - zt[differ]).max(initial=0.0) <= 1e-5, \
        np.argwhere(differ)
    assert differ.sum() <= 0.01 * covered, np.argwhere(differ)
    dl = np.abs(np.asarray(want.bary) - got.bary.numpy()).max(-1)
    return ~differ, np.where(differ, 0.0, dl)


def _check(got, want, agree, lipschitz):
    keep, dl = agree
    err = np.abs(got - want).max(-1)
    assert (err <= lipschitz * dl + 1e-5)[keep].all()


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("light", [None, (0.3, -0.8, 0.5)],
                         ids=["unlit", "lambert"])
def test_textured_views_match(scene, face_ids, light):
    jr, tr = _rigs()
    want = np.asarray(jrender.render_textured_views(
        jr, jnp.asarray(scene["v"]), jnp.asarray(scene["f"]),
        jnp.asarray(scene["uvs"]), jnp.asarray(scene["fuv"]),
        jnp.asarray(scene["atlas"]),
        light_dir=None if light is None else jnp.asarray(light)))
    got = trender.render_textured_views(
        tr, _t(scene["v"]), _t(scene["f"]), _t(scene["uvs"]),
        _t(scene["fuv"]), _t(scene["atlas"]), light_dir=light).numpy()
    assert got.shape == want.shape == (4, 64, 64, 3)
    _check(got, want, face_ids, 2 * 32 * 3)


def test_vertex_color_normal_and_mask_views_match(scene, face_ids):
    jr, tr = _rigs()
    jv, jf = jnp.asarray(scene["v"]), jnp.asarray(scene["f"])
    tv, tf = _t(scene["v"]), _t(scene["f"])
    want = np.asarray(jrender.render_vertex_color_views(
        jr, jv, jf, jnp.asarray(scene["colors"])))
    got = trender.render_vertex_color_views(tr, tv, tf,
                                            _t(scene["colors"])).numpy()
    _check(got, want, face_ids, 3)
    want = np.asarray(jrender.render_normal_views(jr, jv, jf,
                                                  background=0.0))
    got = trender.render_normal_views(tr, tv, tf, background=0.0).numpy()
    _check(got, want, face_ids, 0)
    assert np.array_equal(
        trender.render_mask_views(tr, tv, tf).numpy(),
        np.asarray(jrender.render_mask_views(jr, jv, jf)))


def test_render_mesh_dir_matches_through_png(scene, tmp_path):
    # the barycentric bound of each pixel of the 20 blender views
    jr, tr = _rigs(20, 64, "blender")
    ndc, depth = jr.transform(jnp.asarray(scene["v"]))
    want = jraster.rasterize_views(ndc, depth, jnp.asarray(scene["f"]), 64)
    ndc_t, depth_t = tr.transform(torch.as_tensor(scene["v"]))
    got = traster.rasterize_views(ndc_t, depth_t,
                                  torch.as_tensor(scene["f"]), 64)
    same = np.asarray(want.face_id) == got.face_id.numpy()
    dl = np.abs(np.asarray(want.bary) - got.bary.numpy()).max(-1)
    lsb = np.where(same, np.ceil(2 * 32 * 3 * dl * 255 + 0.5), 255)

    obj = str(tmp_path / "mesh" / "model_normalized.obj")
    tio.save_textured_obj(scene["v"], scene["uvs"], scene["f"], scene["fuv"],
                          obj)
    tio.save_rgb(scene["atlas"], obj.replace(".obj", ".png"),
                 flip_vertical=True)
    want = jrender.render_mesh_dir(obj, str(tmp_path / "jax"), res=64)
    got = trender.render_mesh_dir(obj, str(tmp_path / "port"), res=64,
                                  device="cpu")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        [f"{i:03d}.png" for i in range(20)]
    for v, (g, w) in enumerate(zip(got, want)):
        a, b = tio.load_png(g).astype(int), tio.load_png(w).astype(int)
        assert a.shape == b.shape == (64, 64, 3)
        err = np.abs(a - b).max(-1)
        assert (err <= np.maximum(lsb[v], 1)).all(), np.argwhere(
            err > np.maximum(lsb[v], 1))
    assert (same.mean() >= 0.99) and (lsb <= 1).mean() >= 0.99
