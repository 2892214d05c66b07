"""PyTorch port, eval/metrics.py against the JAX package on seeded numpy
inputs: PSNR and SSIM on 2 x 40 x 40 x 3 images, the Frechet distance
of two feature sets, surface sampling, chamfer / F-score / normal
consistency and Hausdorff on 1,500 and 1,200 points, point-in-mesh and
IoU on the synthetic cube and a sphere mesh.

Tolerances:
- surface samples, point-in-mesh and IoU: exact (the same numpy draws;
  the same fp32 barycentric test, whose ray tie-break offset keeps every
  query off the edges);
- PSNR 1e-4 dB; SSIM 1e-5 (fp32 convolutions in another summation
  order);
- chamfer, F-score, normal consistency, Hausdorff: 1e-6 relative (the
  nearest neighbours are the same points; the distances are the same
  fp32 formula up to the cross term's rounding);
- the Frechet distance: 1e-9 relative (float64 numpy and scipy in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.eval import metrics as jm
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.eval import metrics as tm


def _images(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((2, 40, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_and_ssim_match():
    a, b = _images()
    for x, y in ((a, b), (a[0], b[0])):
        np.testing.assert_allclose(
            tm.psnr(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
            np.asarray(jm.psnr(jnp.asarray(x), jnp.asarray(y))), atol=1e-4)
        np.testing.assert_allclose(
            tm.ssim(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
            np.asarray(jm.ssim(jnp.asarray(x), jnp.asarray(y))), atol=1e-5)


def test_fid_from_features_matches():
    rng = np.random.default_rng(1)
    fa = rng.standard_normal((64, 8))
    fb = rng.standard_normal((64, 8)) * 1.3 + 0.2
    got, want = tm.fid_from_features(fa, fb), jm.fid_from_features(fa, fb)
    assert abs(got - want) <= 1e-9 * abs(want)


@pytest.fixture(scope="module")
def meshes():
    v, f = synthetic.cube_mesh(6)
    rng = np.random.default_rng(2)
    # a sphere by normalizing the cube's vertices, slightly rotated
    s = v / np.linalg.norm(v, axis=1, keepdims=True) * 0.45
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return (v, f), ((s @ q.T).astype(np.float32), f)


def test_sample_mesh_surface_matches(meshes):
    (v, f), _ = meshes
    for got, want in zip(tm.sample_mesh_surface(v, f, 1500, seed=3),
                         jm.sample_mesh_surface(v, f, 1500, seed=3)):
        np.testing.assert_array_equal(got, want)


def test_chamfer_fscore_and_hausdorff_match(meshes):
    (v, f), (sv, sf) = meshes
    p, pn = tm.sample_mesh_surface(v, f, 1500, seed=4)
    g, gn = tm.sample_mesh_surface(sv, sf, 1200, seed=5)
    for thresh in (0.01, 0.1):
        got = tm.chamfer_and_fscore(p, pn, g, gn, thresh, device="cpu")
        want = jm.chamfer_and_fscore(p, pn, g, gn, thresh)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6 * max(abs(want[k]), 1e-12), k
    got, want = tm.hausdorff(p, g, device="cpu"), jm.hausdorff(p, g)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * want[k], k


def test_points_in_mesh_and_iou_match(meshes):
    (v, f), (sv, sf) = meshes
    q = np.random.default_rng(6).uniform(-0.7, 0.7, (5000, 3)).astype(
        np.float32)
    got = tm.points_in_mesh(q, v, f, chunk=2048, device="cpu")
    np.testing.assert_array_equal(got, jm.points_in_mesh(q, v, f, chunk=2048))
    inside = np.abs(q).max(1) < 0.5
    assert (got == inside).mean() > 0.999
    assert tm.mesh_iou(v, f, sv, sf, 4000, seed=7, device="cpu") == \
        jm.mesh_iou(v, f, sv, sf, 4000, seed=7)
