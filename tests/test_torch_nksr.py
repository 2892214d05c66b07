"""PyTorch port, the NKSR-class kernel-field baseline (baselines/nksr.py,
cli/nksr_baseline.py, geometry_table's NKSR backend) against the JAX
package on the CPU:

- the fitted field on a sphere from the same oriented cloud: the same
  nodes, and values within 1e-4 of the largest |f| at grid and off-grid
  queries (an fp32 kernel matrix solved in float64 by another LU);
- the reconstruction (normals, field, marching cubes, 2 refine steps,
  largest component, colours): the mesh within a vertex chamfer of 1e-5
  of JAX's, the colours within 1e-4 but at kNN near-ties (<= 0.1% of
  the vertices);
- geometry_table's NKSR row against the JAX CLI's on one cloud;
- a cloud with repeated points: the port reconstructs it as it
  reconstructs the deduplicated cloud, where the JAX package's
  np.linalg.solve raises on the singular saddle matrix.
TF32 is off."""
import functools
import json
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from pointdreamer_tpu.baselines import nksr as jn
from pointdreamer_tpu.cli import geometry_table as j_geometry_table
from pointdreamer_tpu.cli import nksr_baseline as j_nksr_cli
from pointdreamer_tpu.ops.sdf import estimate_oriented_normals
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch.baselines import nksr as tn
from pointdreamer_tpu_torch.cli import geometry_table, nksr_baseline

torch.backends.cuda.matmul.allow_tf32 = False


def _sphere_cloud(n=4000, r=0.4, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * r).astype(np.float32)
    cols = np.stack([0.5 + pts[:, 0], 0.5 - pts[:, 0],
                     np.full(n, 0.25)], -1).astype(np.float32)
    return pts, np.clip(cols, 0, 1)


def _chamfer(va, vb):
    da, _ = cKDTree(vb).query(va)
    db, _ = cKDTree(va).query(vb)
    return 0.5 * (da.mean() + db.mean())


def test_kernel_field_matches_jax():
    pts, _ = _sphere_cloud(2000)
    nrm = np.asarray(estimate_oriented_normals(pts))
    j_field, j_nodes = jn.fit_kernel_field(pts, nrm, max_centers=256)
    t_field, t_nodes = tn.fit_kernel_field(pts, nrm, max_centers=256,
                                           device="cpu")
    np.testing.assert_array_equal(t_nodes, j_nodes)
    axis = np.linspace(-0.6, 0.6, 24, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)
    q = np.concatenate([grid, np.random.default_rng(1).uniform(
        -0.6, 0.6, (3000, 3)).astype(np.float32), pts[:500]])
    want = j_field(q)
    got = t_field(q).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the sign convention: negative inside, positive outside
    f = t_field(np.array([[0, 0, 0], [0.55, 0, 0], [0, 0.55, 0]],
                         np.float32)).numpy()
    assert f[0] < 0 < min(f[1], f[2])


def test_reconstruction_matches_jax():
    pts, cols = _sphere_cloud()
    kw = dict(grid_res=48, mise_iter=2, max_centers=512)
    jv, jf, jc = jn.recon_one_shape_NKSR(pts, cols, **kw)
    tv, tf, tc = tn.recon_one_shape_NKSR(pts, cols, device="cpu", **kw)
    assert len(tf) > 100 and abs(len(tf) - len(jf)) <= 0.001 * len(jf)
    assert _chamfer(tv, jv) <= 1e-5
    assert tf.shape == jf.shape and (tf == jf).all()
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    # colours: a vertex whose 3rd and 4th nearest input points lie 1.5e-8
    # apart in squared distance (measured: 2.42010e-4 and 2.42025e-4)
    # takes the other one, its position differing by 7e-6; so at most
    # 0.1% of the vertices are let past 1e-4
    off = np.abs(tc - jc).max(1) > 1e-4
    assert off.mean() <= 1e-3 and np.abs(tc - jc).max() < 5e-3
    # the JAX test's geometry gates hold for the port's mesh too
    rad = np.linalg.norm(tv, axis=1)
    assert abs(rad.mean() - 0.4) < 0.02 and rad.std() < 0.015


def test_repeated_points_reconstruct_as_the_deduplicated_cloud():
    pts, cols = _sphere_cloud(400, seed=2)
    dup = np.concatenate([pts, pts[:100]])
    dup_cols = np.concatenate([cols, cols[:100]])
    kw = dict(grid_res=32, mise_iter=1, max_centers=512)
    # every point is a node (500 <= 512): the JAX package's saddle matrix
    # has equal rows, and its LU raises
    with pytest.raises(np.linalg.LinAlgError, match="Singular"):
        jn.recon_one_shape_NKSR(dup, dup_cols, **kw)
    got = tn.recon_one_shape_NKSR(dup, dup_cols, device="cpu", **kw)
    want = tn.recon_one_shape_NKSR(pts, cols, device="cpu", **kw)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # fit_kernel_field alone deduplicates its nodes
    nrm = np.asarray(estimate_oriented_normals(dup))
    field, nodes = tn.fit_kernel_field(dup, nrm, max_centers=512,
                                       device="cpu")
    assert len(nodes) == 2 * 400 + 128
    assert np.isfinite(field(pts).numpy()).all()


def test_geometry_table_nksr_row_matches_jax(tmp_path, monkeypatch):
    d = tmp_path / "data"
    pts, cols = _sphere_cloud(2000, seed=3)
    tio.save_colored_pc_ply(pts, cols, str(d / "ball.ply"))
    for mod in (geometry_table, j_geometry_table):
        monkeypatch.setattr(mod, "score_mesh", functools.partial(
            mod.score_mesh, n_sample=5000))
    argv = ["--data", str(d), "--backends", "NKSR", "--grid_res", "32",
            "--target_faces", "500"]
    j_geometry_table.main(argv + ["--out", str(tmp_path / "j.json")])
    geometry_table.main(argv + ["--out", str(tmp_path / "t.json"),
                                "--device", "cpu"])
    want = json.load(open(tmp_path / "j.json"))["ball"]["NKSR"]
    got = json.load(open(tmp_path / "t.json"))["ball"]["NKSR"]
    assert 0 < got["n_faces"] <= 500
    assert abs(got["n_faces"] - want["n_faces"]) <= 2
    for k in ("chamfer_l1", "fscore", "normal_consistency"):
        assert abs(got[k] - want[k]) <= 0.02 * abs(want[k]) + 1e-4, k


def test_nksr_cli_layout_matches_jax(tmp_path):
    pts, cols = _sphere_cloud(1500, seed=4)
    ply = tmp_path / "toy.ply"
    tio.save_colored_pc_ply(pts, cols, str(ply))
    argv = ["--pc_file", str(ply), "--grid_res", "32", "--mise_iter", "1",
            "--max_centers", "256"]
    j_nksr_cli.main(argv + ["--output", str(tmp_path / "j")])
    nksr_baseline.main(argv + ["--output", str(tmp_path / "t"),
                               "--device", "cpu"])
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "j")
                   for r, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(r, f), tmp_path / "t")
        for r, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert files == ["toy/input_pc.ply", "toy/models/model_normalized.obj",
                     "toy/models/model_normalized.ply"]
    obj = tmp_path / "t" / "toy" / "models" / "model_normalized.obj"
    first_v = next(ln for ln in open(obj) if ln.startswith("v "))
    assert len(first_v.split()) == 7
    jm = tio.load_obj(str(tmp_path / "j" / "toy" / "models" /
                          "model_normalized.obj"))
    tm = tio.load_obj(str(obj))
    assert _chamfer(tm["vertices"], jm["vertices"]) <= 1e-5
    # an existing output is skipped
    nksr_baseline.main(argv + ["--output", str(tmp_path / "t"),
                               "--device", "cpu"])
