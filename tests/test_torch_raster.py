"""PyTorch port, the plain versions of K1 and K4 (ops/raster.py) against
the JAX rasterizers: the Pallas binned kernel and the legacy full-stream
kernel in interpret mode, and the XLA tiled rasterizer (the JAX package's
CPU path); and the PD_USE_PALLAS_RASTER switch between the two routes.

Tolerances: face ids exact except at z ties (pixels where the two
candidates' depths agree within 1e-5); zbuf and barycentrics within 1e-5
on well-conditioned triangles (pixel-size 4..20, no slivers), where one
ulp of a coefficient moves l and z by less than that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.kernels.raster_pallas import (
    rasterize_pallas, rasterize_views_binned_pallas)
from pointdreamer_tpu.ops import raster as jr
from pointdreamer_tpu_torch.ops import raster as tr

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

V, RES, NV, NF = 2, 128, 600, 300


def _scene(seed=0):
    """Random small triangles (in NDC) with random depths per view."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.9, 0.9, (V, NF, 1, 2))
    size = rng.uniform(4, 20, (V, NF, 1, 1)) / (RES / 2)
    ang = rng.uniform(0, 2 * np.pi, (V, NF, 1, 1)) + np.array(
        [0.0, 2.1, 4.2])[None, None, :, None]
    off = np.concatenate([np.cos(ang), np.sin(ang)], -1) * size
    ndc = (c + off).reshape(V, NF * 3, 2).astype(np.float32)
    depth = np.repeat(rng.uniform(0.5, 3.0, (V, NF)), 3, axis=1)
    depth = (depth + rng.uniform(-0.1, 0.1, (V, NF * 3))).astype(np.float32)
    faces = np.arange(NF * 3).reshape(NF, 3).astype(np.int32)
    faces[1::2] = faces[1::2, ::-1]           # both windings
    return ndc, depth, faces


def _compare(j, t):
    jf, tf = np.asarray(j.face_id), t.face_id.numpy()
    jz, tz = np.asarray(j.zbuf), t.zbuf.numpy()
    diff = jf != tf
    ties = diff & (jf >= 0) & (tf >= 0) & np.isclose(jz, tz, rtol=0,
                                                     atol=1e-5)
    assert not (diff & ~ties).any(), (diff & ~ties).sum()
    same = ~diff & (jf >= 0)
    assert same.sum() > 1000
    np.testing.assert_allclose(tz[same], jz[same], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.bary.numpy()[same],
                               np.asarray(j.bary)[same], atol=1e-5, rtol=0)
    assert np.isinf(tz[tf < 0]).all()
    assert (t.bary.numpy()[tf < 0] == 0).all()


@pytest.mark.parametrize("cull", [False, True])
def test_raster_matches_pallas_binned(cull):
    ndc, depth, faces = _scene()
    j = rasterize_views_binned_pallas(jnp.asarray(ndc), jnp.asarray(depth),
                                      jnp.asarray(faces), RES, cull,
                                      interpret=True, side_list=256)
    t = tr.rasterize_views(torch.as_tensor(ndc), torch.as_tensor(depth),
                           torch.as_tensor(faces), RES, cull)
    _compare(j, t)


@pytest.mark.parametrize("cull", [False, True])
def test_raster_matches_xla_tiled(cull):
    ndc, depth, faces = _scene(1)
    j = jr.rasterize_views(jnp.asarray(ndc), jnp.asarray(depth),
                           jnp.asarray(faces), RES, cull_backface=cull)
    t = tr.rasterize_views(torch.as_tensor(ndc), torch.as_tensor(depth),
                           torch.as_tensor(faces), RES, cull)
    _compare(j, t)


def test_raster_exact_tie_goes_to_lower_face_id():
    # two coplanar copies of one triangle: every covered pixel is a z tie
    ndc = np.array([[[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]]], np.float32)
    depth = np.ones((1, 3), np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 2]], np.int32)
    t = tr.rasterize_views(torch.as_tensor(ndc), torch.as_tensor(depth),
                           torch.as_tensor(faces), 64)
    fid = t.face_id.numpy()
    assert (fid >= 0).sum() > 100 and set(np.unique(fid)) == {-1, 0}


def test_interpolate_and_face_normals():
    rng = np.random.default_rng(3)
    verts = rng.standard_normal((50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (40, 3)).astype(np.int32)
    attrs = rng.standard_normal((50, 4)).astype(np.float32)
    fid = rng.integers(-1, 40, (2, 16, 16)).astype(np.int32)
    bary = rng.random((2, 16, 16, 3)).astype(np.float32)
    got = tr.interpolate(torch.as_tensor(attrs), torch.as_tensor(faces),
                         torch.as_tensor(fid), torch.as_tensor(bary))
    want = jr.interpolate(jnp.asarray(attrs), jnp.asarray(faces),
                          jnp.asarray(fid), jnp.asarray(bary))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        tr.face_normals(torch.as_tensor(verts), torch.as_tensor(faces)
                        ).numpy(),
        np.asarray(jr.face_normals(jnp.asarray(verts), jnp.asarray(faces))),
        atol=1e-6)


@pytest.mark.parametrize("cull", [False, True])
def test_raster_legacy_matches_pallas_interpret(cull):
    # K4's plain version against rasterize_pallas(interpret=True) on the
    # JAX package's own K4 scene (80 random triangles, res 128): face ids
    # exact, barycentrics within 1e-6, zbuf within 1e-6 relative (z is
    # 0.45..2.05 here).  XLA's CPU backend contracts a*b - c*d into
    # fma(a, b, -(c*d)) (every barycentric of the interpret run equals
    # that form), the port keeps the kernel source's separate roundings,
    # so the two differ by a few ulp (measured 7.5e-7 bary, 1.2e-6 z).
    rng = np.random.default_rng(7)
    n = 80
    c = rng.uniform(-0.9, 0.9, (n, 1, 2))
    offs = rng.uniform(-0.2, 0.2, (n, 3, 2))
    tri = (c + offs).reshape(-1, 2).astype(np.float32)
    depth = rng.uniform(0.5, 2.0, (n, 1)).repeat(3, 1).reshape(-1)
    depth = (depth + rng.uniform(-0.05, 0.05, depth.shape)).astype(
        np.float32)
    faces = np.arange(n * 3).reshape(-1, 3).astype(np.int32)
    j = rasterize_pallas(jnp.asarray(tri), jnp.asarray(depth),
                         jnp.asarray(faces), 128, cull, interpret=True)
    t = tr.rasterize_legacy(tr.prepare_legacy(
        torch.as_tensor(tri)[None], torch.as_tensor(depth)[None],
        torch.as_tensor(faces), 128, cull), 128)
    jf, tf = np.asarray(j.face_id), t.face_id[0].numpy()
    np.testing.assert_array_equal(tf, jf)
    hit = jf >= 0
    assert hit.sum() > 1000
    np.testing.assert_allclose(t.zbuf[0].numpy()[hit],
                               np.asarray(j.zbuf)[hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.bary[0].numpy(), np.asarray(j.bary),
                               atol=1e-6, rtol=0)
    assert np.isinf(t.zbuf[0].numpy()[~hit]).all()


def test_rasterize_views_switch(monkeypatch):
    # PD_USE_PALLAS_RASTER=1, read at call time, sends res % 128 == 0 to
    # K4 and everything else to K1, as the JAX package's rasterize_views
    # does; the atlas bake always takes K1
    from pointdreamer_tpu_torch.pipeline import unwrap as tunwrap

    calls = []
    for name in ("rasterize_legacy", "rasterize_coefficients"):
        def spy(*a, _f=getattr(tr, name), _n=name):
            calls.append(_n)
            return _f(*a)
        monkeypatch.setattr(tr, name, spy)
    ndc, depth, faces = _scene(2)
    args = (torch.as_tensor(ndc), torch.as_tensor(depth),
            torch.as_tensor(faces))
    monkeypatch.setenv("PD_USE_PALLAS_RASTER", "1")
    k4 = tr.rasterize_views(*args, 128, True)
    tr.rasterize_views(*args, 64)
    assert calls == ["rasterize_legacy", "rasterize_coefficients"]
    k1 = tr.rasterize_binned(*args, 128, True)
    # the two routes agree on this scene but for z-tie pixels (as K1 does
    # against the Pallas kernels above)
    _compare(k1, k4)
    v = np.random.default_rng(0).random((30, 3)).astype(np.float32)
    f = np.arange(30).reshape(10, 3)
    uv = v[:, :2]
    del calls[:]
    tunwrap.bake_atlas(v, f, uv, f, 128, device="cpu")
    assert calls == ["rasterize_coefficients"]
    monkeypatch.delenv("PD_USE_PALLAS_RASTER")
    del calls[:]
    tr.rasterize_views(*args, 128)
    assert calls == ["rasterize_coefficients"]
