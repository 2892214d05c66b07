"""PyTorch port, geometry from the point cloud against the JAX package:
kNN, PCA + MST normals, the screened Poisson field, marching cubes, QEM,
the Hoppe fallback and `reconstruct_mesh` (SPR), on seeded numpy clouds
(a 4,000-point sphere and the cube's surface samples)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.native import qem as jqem
from pointdreamer_tpu.ops import iso as jiso
from pointdreamer_tpu.ops import knn as jknn
from pointdreamer_tpu.ops import sdf as jsdf
from pointdreamer_tpu.pipeline import geometry as jgeo
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.baselines import spr as tspr
from pointdreamer_tpu_torch.ops import iso as tiso
from pointdreamer_tpu_torch.ops import knn as tknn
from pointdreamer_tpu_torch.ops import qem as tqem
from pointdreamer_tpu_torch.ops import sdf as tsdf
from pointdreamer_tpu_torch.pipeline import geometry as tgeo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RES = 48
AXIS = np.linspace(tgeo.GRID_LO, tgeo.GRID_HI, RES, dtype=np.float32)


def _sphere(n=4000, seed=1):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * 0.5).astype(np.float32)


def _cloud(name):
    return _sphere() if name == "sphere" else synthetic.cube_cloud(4000)[0]


def _chamfer(a, b):
    """Symmetric chamfer: mean nearest-neighbour distance both ways."""
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


@pytest.fixture(scope="module")
def sphere_field():
    """The JAX package's oriented normals and SPR field on the sphere."""
    pts = _sphere()
    nrm = jsdf.estimate_oriented_normals(pts)
    p01 = (pts - tgeo.GRID_LO) / (tgeo.GRID_HI - tgeo.GRID_LO)
    chi = np.asarray(jsdf.poisson_indicator_grid(
        jnp.asarray(p01), jnp.asarray(nrm), res=RES, screen_weight=2.0))
    return pts, nrm, p01, chi


def test_knn_and_nearest_match():
    # fp32 distances from the same formula, summed in another order:
    # sorted distances within 1e-6; indices equal but where two
    # neighbours' distances agree to rounding and swap ranks (< 0.1%,
    # measured 2 of 8500)
    pts = _sphere()
    q = np.random.default_rng(2).uniform(-0.6, 0.6, (500, 3)).astype(
        np.float32)
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(pts), 17)
    td, ti = tknn.knn(torch.as_tensor(q), torch.as_tensor(pts), 17)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert (ti.numpy() != np.asarray(ji)).mean() < 1e-3
    jd1, ji1 = jknn.nearest(jnp.asarray(q), jnp.asarray(pts))
    td1, ti1 = tknn.nearest(torch.as_tensor(q), torch.as_tensor(pts))
    np.testing.assert_array_equal(ti1.numpy(), np.asarray(ji1))
    np.testing.assert_allclose(td1.numpy(), np.asarray(jd1), atol=1e-6)


def test_pca_normals_from_shared_knn_match():
    # the same kNN indices into both: within 1e-5 and the same sign
    pts = _sphere()
    _, idx = jknn.knn(jnp.asarray(pts), jnp.asarray(pts), 16)
    want = np.asarray(jsdf.pca_normals_from_idx(jnp.asarray(pts), idx))
    got = tsdf.pca_normals_from_idx(
        torch.as_tensor(pts), torch.as_tensor(np.array(idx)).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ((got * want).sum(-1) > 0).all()
    # estimate_normals_pca = its own kNN pass + the same PCA
    np.testing.assert_array_equal(
        tsdf.estimate_normals_pca(torch.as_tensor(pts)).numpy(),
        tsdf.pca_normals_from_idx(torch.as_tensor(pts), tknn.knn(
            torch.as_tensor(pts), torch.as_tensor(pts), 16)[1]).numpy())


@pytest.mark.parametrize("name", ["sphere", "cube"])
def test_oriented_normals_match(name):
    # each package's own kNN, PCA and MST: >= 99.9% sign agreement (on
    # the cube's flat sides the MST weights tie at 1e-9, so rounding may
    # pick another tree with the same orientation; compared by sign)
    pts = _cloud(name)
    want = jsdf.estimate_oriented_normals(pts)
    got = tsdf.estimate_oriented_normals(pts, device="cpu")
    assert ((got * want).sum(-1) > 0).mean() >= 0.999


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_poisson_indicator_grid_matches(sphere_field, dtype):
    # res 48, screen weight 2, 48 PCG iterations, the same points and
    # normals into both.  float64 on both sides (JAX with x64 enabled):
    # max |d| <= 1e-4 * max |chi| (measured 1.9e-6).  float32, the
    # pipeline's type: <= 1e-3 * max |chi| (measured 5.1e-4).  The f32
    # bar is the reference's own accuracy: the JAX package's CPU `vdot`
    # sums the CG inner products sequentially in f32 (1e-5 relative off),
    # and after 48 iterations its f32 field is 5.6e-4 * max |chi| from
    # its own float64 run (the port's 3.3e-4).
    pts, nrm, p01, chi32 = sphere_field
    if dtype == "float64":
        with jax.enable_x64(True):
            want = np.asarray(jsdf.poisson_indicator_grid(
                jnp.asarray(p01, jnp.float64), jnp.asarray(nrm, jnp.float64),
                res=RES, screen_weight=2.0))
        bar = 1e-4
    else:
        want, bar = chi32, 1e-3
    got = tsdf.poisson_indicator_grid(
        torch.as_tensor(p01.astype(dtype)), torch.as_tensor(nrm.astype(dtype)),
        res=RES, screen_weight=2.0).numpy()
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= bar * np.abs(want).max()


def test_marching_cubes_matches(sphere_field):
    # the JAX field into both: faces and edge keys exact, vertices within
    # 1e-6 (same interpolation formula, op for op)
    chi = sphere_field[3]
    jv, jf, jk = jiso.marching_cubes(chi, AXIS, return_edge_keys=True)
    tv, tf, tk = tiso.marching_cubes(chi, AXIS, return_edge_keys=True)
    assert len(jf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)


def test_qem_and_components_match(sphere_field):
    # the same welded mesh into both: QEM exact; largest_component exact;
    # taubin_smooth within 1e-6
    v, f = jiso.marching_cubes(sphere_field[3], AXIS)
    jv, jf = jqem.simplify(v, f, 2000)
    tv, tf = tqem.simplify(v, f, 2000)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    # a floater: a second, smaller copy beside the sphere
    v2 = np.concatenate([v, v * 0.2 + 0.3])
    f2 = np.concatenate([f, f + len(v)])
    for a, b in zip(tgeo.largest_component(v2, f2),
                    jgeo.largest_component(v2, f2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tgeo.taubin_smooth(jv, jf),
                               jgeo.taubin_smooth(jv, jf), atol=1e-6)


def test_hoppe_field_and_refinement_match():
    # the hoppe fallback at res 24 on the JAX normals: the banded field
    # within 1e-5 at >= 99.9% of the voxels and within 1e-3 at all (where
    # two candidates for the 8th neighbour tie to rounding, the packages
    # may take different ones), then marching
    # cubes + 10 bisection steps on the JAX field: faces exact, refined
    # vertices within 1e-5 at >= 99.9% and within one last bisection
    # interval (a grid edge / 2^10 = 3.9e-5) at all, for the same reason
    pts = _sphere(1000, seed=3)
    nrm = jsdf.estimate_oriented_normals(pts)
    res = 24
    axis = np.linspace(tgeo.GRID_LO, tgeo.GRID_HI, res, dtype=np.float32)
    pj, nj = jnp.asarray(pts), jnp.asarray(nrm)
    pt, nt = torch.as_tensor(pts), torch.as_tensor(nrm)

    def jfn(q):
        return jsdf.hoppe_sdf(q, pj, nj)

    def tfn(q):
        return tsdf.hoppe_sdf(q, pt, nt)

    want = jsdf.eval_sdf_on_grid_banded(jfn, pts, res, tgeo.GRID_LO,
                                        tgeo.GRID_HI)
    got = tsdf.eval_sdf_on_grid_banded(tfn, pts, res, tgeo.GRID_LO,
                                       tgeo.GRID_HI, device="cpu")
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.999
    np.testing.assert_allclose(got, want, atol=1e-3)
    jv, jf, jk = jiso.marching_cubes(want, axis, return_edge_keys=True)
    tv, tf, tk = tiso.marching_cubes(want, axis, return_edge_keys=True)
    np.testing.assert_array_equal(tf, jf)
    d = np.abs(tiso.refine_vertices_bisection(tfn, tv, tk, want, axis, 10,
                                              chunk=2048, device="cpu")
               - jiso.refine_vertices_bisection(jfn, jv, jk, want, axis, 10,
                                                chunk=2048))
    assert (d.max(1) <= 1e-5).mean() >= 0.999
    assert d.max() <= (axis[1] - axis[0]) / 2 ** 10 + 1e-6


@pytest.fixture(scope="module")
def sphere_meshes():
    """reconstruct_mesh(..., 'POCO', 48, 2000) on the sphere in both
    packages: with no network both warn and run SPR."""
    pts = _sphere()
    with pytest.warns(UserWarning, match="falling back"):
        want = jgeo.reconstruct_mesh(pts, "POCO", grid_res=RES,
                                     target_faces=2000)
    with pytest.warns(UserWarning, match="falling back"):
        got = tgeo.reconstruct_mesh(pts, "POCO", grid_res=RES,
                                    target_faces=2000, device="cpu")
    return pts, want, got


def test_reconstruct_mesh_spr_matches(sphere_meshes):
    # face counts within 1%, symmetric chamfer <= 1e-3 (the f32 fields
    # differ by the CG rounding above, so QEM's collapse order may too)
    pts, (jv, jf), (tv, tf) = sphere_meshes
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    assert _chamfer(tv, jv) <= 1e-3
    r = np.linalg.norm(tv, axis=1)
    assert 0.45 < np.median(r) < 0.55


def test_spr_baseline_is_reconstruct_mesh(sphere_meshes):
    pts, _, (tv, tf) = sphere_meshes
    v, f, none = tspr.recon_one_shape_SPR(pts, None, 2000, grid_res=RES,
                                          device="cpu")
    assert none is None
    np.testing.assert_array_equal(f, tf)
    np.testing.assert_array_equal(v, tv)


def test_spr_baseline_cli_writes_the_cloud_frame(tmp_path):
    # main(): normalize, reconstruct (grid 128), write the OBJ back in the
    # cloud's own coordinates (a sphere of radius 1.5 around (2, 0, -1))
    from pointdreamer_tpu_torch import io as tio

    pts = _sphere(2000, seed=5) * 3.0 + np.array([2.0, 0.0, -1.0],
                                                 np.float32)
    ply, out = str(tmp_path / "s.ply"), str(tmp_path / "s.obj")
    tio.save_colored_pc_ply(pts, np.full_like(pts, 0.5), ply)
    tspr.main(ply, out, 1000, device="cpu")
    m = tio.load_obj(out)
    assert 500 < len(m["faces"]) <= 1000
    r = np.linalg.norm(m["vertices"] - np.array([2.0, 0.0, -1.0]), axis=1)
    assert abs(np.median(r) - 1.5) < 0.05


def test_empty_surface_retries_with_hoppe(monkeypatch):
    # an all-positive Poisson field has no surface: warn and run 'hoppe'
    # (its banded field, marching cubes, bisection refinement, QEM)
    pts = _sphere(1000, seed=3)
    monkeypatch.setattr(
        tsdf, "poisson_indicator_grid",
        lambda p, n, res, **k: torch.ones((res, res, res)))
    banded = []
    real = tsdf.eval_sdf_on_grid_banded

    def spy(*a, **k):
        banded.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(tsdf, "eval_sdf_on_grid_banded", spy)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        v, f = tgeo.reconstruct_mesh(pts, "SPR", grid_res=24,
                                     target_faces=500, device="cpu")
    assert any("retrying with 'hoppe'" in str(w.message) for w in rec)
    assert banded == [24]
    assert 250 < len(f) <= 500
    r = np.linalg.norm(v, axis=1)
    assert 0.45 < np.median(r) < 0.55


def _noisy_sphere_field(res, seed):
    ax = np.linspace(tgeo.GRID_LO, tgeo.GRID_HI, res, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    rng = np.random.default_rng(seed)
    f = (np.linalg.norm(g - np.array([0.05, -0.03, 0.02]), axis=-1) - 0.4
         + 0.02 * rng.standard_normal(g.shape[:3])).astype(np.float32)
    return f, ax


@pytest.mark.parametrize("res", [16, 24, 32])
def test_marching_tets_matches(res):
    # an off-centre sphere with noise (bumps, cells of every case): the
    # JAX package's vertex and face order and edge keys
    f, ax = _noisy_sphere_field(res, res)
    jv, jf, jk = jiso.marching_tets(f, ax, return_edge_keys=True)
    tv, tf, tk = tiso.marching_tets(torch.as_tensor(f), ax,
                                    return_edge_keys=True)
    assert len(tf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    # inside -> outside winding: faces point away from the centre
    tri = tv[tf]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    out = tri.mean(1) - np.array([0.05, -0.03, 0.02])
    assert ((n * out).sum(1) > 0).mean() > 0.95


def _tets_mesh():
    f, ax = _noisy_sphere_field(48, 0)
    return tiso.marching_tets(torch.as_tensor(f), ax)


@pytest.mark.parametrize("res", [8, 20, 64])
def test_cluster_once_matches(res):
    v, f = _tets_mesh()
    jv, jf = jgeo._cluster_once(v, f, res)
    tv, tf = tgeo._cluster_once(v, f, res)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)


def _jax_qem_fails(monkeypatch):
    """The JAX package's decimation tries its QEM first; make it fail so
    that it clusters (any exception takes it there)."""
    def fail(*a, **k):
        raise RuntimeError("qem_simplify failed rc=-1")
    monkeypatch.setattr(jqem, "simplify", fail)


def test_decimate_vertex_clustering_matches(monkeypatch):
    _jax_qem_fails(monkeypatch)
    v, f = _tets_mesh()
    for target in (2000, 500, len(f) + 1):
        jv, jf = jgeo.decimate_vertex_clustering(v, f, target)
        tv, tf = tgeo.decimate_vertex_clustering(v, f, target)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
        assert len(tf) <= 1.3 * target


def test_qem_error_code_decimates_by_clustering(monkeypatch):
    # the QEM returning an error code on the mesh: reconstruct_mesh
    # clusters, as the JAX package does
    _jax_qem_fails(monkeypatch)

    def rc_error(*a, **k):
        raise tqem.QEMFailed("qem_simplify failed rc=-1")

    monkeypatch.setattr(tqem, "simplify", rc_error)
    called = []
    real = tgeo.decimate_vertex_clustering
    monkeypatch.setattr(tgeo, "decimate_vertex_clustering",
                        lambda *a: called.append(a[2]) or real(*a))
    pts = _sphere()
    want = jgeo.reconstruct_mesh(pts, "SPR", grid_res=RES, target_faces=2000)
    with pytest.warns(UserWarning, match="rc=-1.*clustering"):
        got = tgeo.reconstruct_mesh(pts, "SPR", grid_res=RES,
                                    target_faces=2000, device="cpu")
    assert called == [2000]
    # the fields differ by rounding (test_poisson_indicator_grid_matches),
    # so a cell's vertex mean may too
    assert abs(len(got[1]) - len(want[1])) <= 0.01 * len(want[1])
    assert _chamfer(got[0], want[0]) <= 1e-3


def test_failed_qem_build_raises(monkeypatch):
    import subprocess

    def no_build():
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(tqem, "_LIB", None)
    monkeypatch.setattr(tqem, "build", no_build)
    with pytest.raises(subprocess.CalledProcessError):
        tgeo.reconstruct_mesh(_sphere(), "SPR", grid_res=24,
                              target_faces=200, device="cpu")


def test_refine_orientation_by_visibility_matches():
    # the sphere's outward normals with a cap (z > 0.3, 764 points)
    # flipped: both packages turn every normal outward again.  The votes
    # are the same host arithmetic on the same hulls; the smoothing reads
    # kNN ranks, which can swap at equal fp32 distances (none here)
    pts = _sphere()
    d = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    nrm = d.copy()
    cap = pts[:, 2] > 0.3
    nrm[cap] *= -1
    want = jsdf.refine_orientation_by_visibility(pts, nrm)
    got = tsdf.refine_orientation_by_visibility(pts, nrm, device="cpu")
    assert cap.sum() > 500
    np.testing.assert_array_equal(np.sign((got * nrm).sum(1)),
                                  np.sign((want * nrm).sum(1)))
    assert ((got * d).sum(1) > 0).all()
    # the flag on estimate_oriented_normals
    on = tsdf.estimate_oriented_normals(pts, visibility_refine=True,
                                        device="cpu")
    off = tsdf.estimate_oriented_normals(pts, device="cpu")
    np.testing.assert_array_equal(
        on, tsdf.refine_orientation_by_visibility(pts, off, device="cpu"))


def test_reconstruct_mesh_tets_matches_jax():
    # iso_method 'tets' through reconstruct_mesh (SPR at 48^3, 2000 faces)
    # against the JAX package's: face counts within 1%, chamfer <= 1e-3
    # (the f32 Poisson fields differ by rounding, so QEM's collapse order
    # may too)
    pts = _sphere()
    jv, jf = jgeo.reconstruct_mesh(pts, "SPR", grid_res=RES,
                                   target_faces=2000, iso_method="tets")
    tv, tf = tgeo.reconstruct_mesh(pts, "SPR", grid_res=RES,
                                   target_faces=2000, iso_method="tets",
                                   device="cpu")
    assert 1600 <= len(tf) <= 2000
    assert abs(len(tf) - len(jf)) <= 0.01 * len(jf)
    assert _chamfer(tv, jv) <= 1e-3
    r = np.linalg.norm(tv, axis=1)
    assert 0.45 < np.median(r) < 0.55
