"""PyTorch port, the tri-plane colour field (models/texture_field) against
the JAX package on the CPU: the forward from the JAX init carried across,
the Adam fit, `fit_and_paint` and `get_textured_mesh`, on seeded numpy
clouds; then the port's own analogues of tests/test_texture_field.py.

What the fit comparisons measure: 20 Adam steps from the same weights.
Adam normalizes each gradient entry by its own magnitude, so an entry
whose gradient is a sum that cancels to rounding level (a plane texel
that two points pull opposite ways) takes a full lr step of either sign
on either side.  On a uniform random cloud few texels are such; on the
cube's surface samples, whose faces project onto the same plane texels,
many are (the predictions there drift apart by ~1e-1 in 20 steps), so
the clouds here are uniform."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.models.texture_field import triplane as jtf
from pointdreamer_tpu.pipeline import unwrap as junwrap
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.mesh import Mesh
from pointdreamer_tpu_torch.models.texture_field import triplane as ttf
from pointdreamer_tpu_torch.pipeline import unwrap as tunwrap

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_torch_thread():
    # the test workers share the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=512, seed=0, lo=-0.5, hi=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.random((n, 3)).astype(np.float32))


def _jax_init(seed=0):
    f = jtf.TriplaneColorField.init(jax.random.PRNGKey(seed))
    return f, ttf.triplane_from_jax(f, device="cpu")


def test_field_forward_matches_jax():
    # past [-0.5, 0.5] too: the clip to [0, 1] at xyz + 0.5
    jf, tf = _jax_init(3)
    xyz, _ = _cloud(2048, seed=1, lo=-0.6, hi=0.6)
    want = np.asarray(jtf.field_forward(jf, jnp.asarray(xyz)))
    with torch.no_grad():
        got = ttf.field_forward(tf, torch.as_tensor(xyz)).numpy()
    assert got.shape == (2048, 3)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert sum(p.numel() for p in tf.parameters()) == 409_283


def test_fit_color_field_matches_jax():
    # 20 steps at N = 512 (measured: losses within 3.0e-7 relative,
    # predictions within 1.2e-6)
    key = jax.random.PRNGKey(3)
    _, tf = _jax_init(3)
    xyz, rgb = _cloud(seed=0, lo=-0.6, hi=0.6)
    jfield, jloss = jtf.fit_color_field(key, jnp.asarray(xyz),
                                        jnp.asarray(rgb), iterations=20)
    tfield, tloss = ttf.fit_color_field(torch.as_tensor(xyz),
                                        torch.as_tensor(rgb), 20, init=tf)
    jloss = np.asarray(jloss)
    assert tloss.shape == (20,)
    np.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-5)
    assert jloss[-1] < jloss[0]
    q, _ = _cloud(1024, seed=9)
    want = np.asarray(jtf.field_forward(jfield, jnp.asarray(q)))
    with torch.no_grad():
        got = tfield(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the init the fit started from is left as it was
    with torch.no_grad():
        np.testing.assert_array_equal(
            tf.planes["xz"].numpy(), _jax_init(3)[1].planes["xz"].numpy())


def test_fit_and_paint_matches_jax():
    key = jax.random.PRNGKey(0)
    _, tf = _jax_init(0)
    xyz, rgb = _cloud(seed=2)
    rng = np.random.default_rng(4)
    R = 32
    atlas = rng.random((R, R, 3)).astype(np.float32)
    painted = rng.random((R, R)) < 0.5
    mask = rng.random((R, R)) < 0.8
    gb = rng.uniform(-0.5, 0.5, (R, R, 3)).astype(np.float32)
    want = np.asarray(jtf.fit_and_paint(
        jnp.asarray(atlas), jnp.asarray(painted), jnp.asarray(gb),
        jnp.asarray(mask), jnp.asarray(xyz), jnp.asarray(rgb),
        iterations=20, rng_key=key))
    got = ttf.fit_and_paint(
        torch.as_tensor(atlas), torch.as_tensor(painted), torch.as_tensor(gb),
        torch.as_tensor(mask), torch.as_tensor(xyz), torch.as_tensor(rgb),
        iterations=20, init=tf).numpy()
    unseen = mask & ~painted
    assert 0.2 < unseen.mean() < 0.6
    np.testing.assert_array_equal(got[~unseen], atlas[~unseen])
    np.testing.assert_allclose(got[unseen], want[unseen], atol=1e-4)
    assert np.abs(got[unseen] - atlas[unseen]).mean() > 0.1


def test_get_textured_mesh_matches_jax(monkeypatch):
    # the cube's mesh at R = 64, the field fitted (20 steps) to a uniform
    # cloud from the JAX init; the port's unwrap is the JAX package's
    # (test_torch_pipeline.py::test_unwrap_identical), its bake K1's
    # plain version against XLA's: coverage differs at chart-edge texels
    v, f = synthetic.cube_mesh(4)
    xyz, rgb = _cloud(seed=5)
    want = jtf.get_textured_mesh(v, f, xyz, rgb, atlas_res=64,
                                 iterations=20,
                                 rng_key=jax.random.PRNGKey(0))
    _, init = _jax_init(0)
    real = ttf.fit_color_field
    monkeypatch.setattr(ttf, "fit_color_field",
                        lambda *a, **k: real(*a, **{**k, "init": init}))
    got = ttf.get_textured_mesh(v, f, xyz, rgb, atlas_res=64, iterations=20,
                                device="cpu")
    assert isinstance(got, Mesh)
    np.testing.assert_array_equal(got.vertices, v)
    np.testing.assert_array_equal(got.faces, f)
    np.testing.assert_array_equal(got.uvs, want.uvs)
    np.testing.assert_array_equal(got.face_uv_idx, want.face_uv_idx)
    uvs, fuv = tunwrap.unwrap(v, f, atlas_res=64)
    jb = junwrap.bake_atlas(jnp.asarray(v), jnp.asarray(f), uvs, fuv, 64)
    tb = tunwrap.bake_atlas(v, f, uvs, fuv, 64, device="cpu")
    jmask, tmask = np.asarray(jb["mask"]), tb["mask"].numpy()
    # measured: the coverage differs at 16 texels of 4096
    assert (jmask != tmask).sum() <= 32 and (jmask & tmask).mean() > 0.3
    # texels both bakes cover at the same position: the field's own
    # difference.  Where the positions differ by rounding (the bake's
    # barycentrics, up to 1.4e-5), the field's slope adds to it (measured
    # 7 texels, up to 2.2e-4)
    same = (jmask & tmask & (np.abs(np.asarray(jb["gb_pos"])
                                    - tb["gb_pos"].numpy()).max(-1) <= 1e-6))
    assert same.sum() >= 0.95 * (jmask & tmask).sum()
    tex, jtex = got.texture, np.asarray(want.texture)
    assert tex.shape == (64, 64, 3) and np.isfinite(tex).all()
    np.testing.assert_allclose(tex[same], jtex[same], atol=1e-4)
    # the nearest fill carries the coverage differences outward: measured
    # 35 texels of 4096 past 1e-4 in all
    assert (np.abs(tex - jtex).max(-1) > 1e-4).mean() < 0.02


# ---- the port's analogues of tests/test_texture_field.py ------------------

def test_field_forward_shapes():
    gen = torch.Generator().manual_seed(0)
    f = ttf.TriplaneColorField(gen, device="cpu")
    with torch.no_grad():
        out = f(torch.zeros((10, 3))).numpy()
    assert out.shape == (10, 3)
    assert (np.abs(out) <= 1.0).all()
    # zero-initialised residual branches, the rest drawn from the generator
    assert all(float(f.decoder[f"block{b}_1"].w.abs().max()) == 0.0
               for b in range(5))
    g2 = ttf.TriplaneColorField(torch.Generator().manual_seed(0),
                                device="cpu")
    torch.testing.assert_close(g2.planes["yz"], f.planes["yz"])


def test_fit_learns_position_colors():
    rng = np.random.default_rng(0)
    xyz = (rng.random((600, 3)) - 0.5).astype(np.float32)
    rgb = (xyz + 0.5).astype(np.float32)          # colour = position
    field, losses = ttf.fit_color_field(
        torch.as_tensor(xyz), torch.as_tensor(rgb), iterations=150,
        generator=torch.Generator().manual_seed(1))
    losses = losses.numpy()
    assert losses[-1] < losses[0] * 0.5
    with torch.no_grad():
        pred = field(torch.as_tensor(xyz[:50])).numpy()
    err = np.abs(pred * 0.5 + 0.5 - rgb[:50]).mean()
    assert err < 0.2


def test_fit_and_paint_fills_unseen():
    rng = np.random.default_rng(0)
    xyz = torch.as_tensor((rng.random((300, 3)) - 0.5).astype(np.float32))
    rgb = torch.full((300, 3), 0.5)
    R = 16
    atlas = torch.zeros((R, R, 3))
    painted = torch.zeros((R, R), dtype=torch.bool)
    painted[:8] = True
    mask = torch.ones((R, R), dtype=torch.bool)
    gb = torch.zeros((R, R, 3))
    out = ttf.fit_and_paint(atlas, painted, gb, mask, xyz, rgb,
                            iterations=60,
                            generator=torch.Generator().manual_seed(0)
                            ).numpy()
    assert np.isfinite(out).all()
    # painted region untouched, unseen region written
    np.testing.assert_allclose(out[:8], 0.0)
    assert np.abs(out[8:] - 0.5).mean() < 0.4
