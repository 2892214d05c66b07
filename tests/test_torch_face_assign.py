"""PyTorch port, face-mode unprojection (pipeline/face_assign.py) and its
multi-material export (pipeline/export.py::save_multi_material_obj)
against the JAX package on the same integer and float inputs: the
neighbour table, the per-face pixel counts, label propagation, smoothing
and assignment exactly; the corner uvs within 1e-6; the OBJ and MTL text
byte for byte."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.core.camera import make_camera_rig as jrig
from pointdreamer_tpu.pipeline import export as jexport
from pointdreamer_tpu.pipeline import face_assign as jface
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.camera import make_camera_rig as trig
from pointdreamer_tpu_torch.pipeline import export as texport
from pointdreamer_tpu_torch.pipeline import face_assign as tface


def _mesh(n_div=4, n_pad=5):
    """The gridded cube, plus a face that shares no edge and degenerate
    padding faces (0,0,0), as the pipeline pads."""
    v, f = synthetic.cube_mesh(n_div)
    nv = len(v)
    extra_v = np.array([[0.9, 0.9, 0.9], [1.0, 0.9, 0.9]], np.float32)
    fan = np.array([[0, nv, nv + 1]], np.int64)
    faces = np.concatenate([f, fan, np.zeros((n_pad, 3), np.int64)])
    return np.concatenate([v, extra_v]).astype(np.float32), faces


def _labels_inputs(seed=0):
    """A mesh with invisible faces (all-zero count rows), padding faces
    and random normal-view similarities."""
    v, f = _mesh()
    rng = np.random.default_rng(seed)
    F, V = len(f), 8
    counts = rng.integers(0, 20, (F, V)) * (rng.random((F, V)) < 0.3)
    counts[rng.random(F) < 0.35] = 0            # faces no view sees
    counts[-5:] = 0                              # the padding faces
    sim = rng.uniform(-1, 1, (F, V)).astype(np.float32)
    return v, f, counts.astype(np.int32), sim


def test_face_adjacency_neighbors_exact():
    _, f = _mesh()
    want = jface.face_adjacency_neighbors(f)
    got = tface.face_adjacency_neighbors(f)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    # the fan shares no edge; the padding faces share their (0, 0) edges
    # with each other only (repeatedly: K = 6 here)
    assert (got[-6] == -1).all() and got.shape[1] == 6
    assert ((got[-5:] == -1) | (got[-5:] >= len(f) - 5)).all()


def test_face_view_pixel_counts_exact():
    rng = np.random.default_rng(1)
    n_faces = 300
    fid = rng.integers(-1, n_faces, (8, 40, 40)).astype(np.int32)
    fid[rng.random(fid.shape) < 0.4] = -1
    want = np.asarray(jface.face_view_pixel_counts(jnp.asarray(fid), n_faces))
    got = tface.face_view_pixel_counts(torch.as_tensor(fid), n_faces)
    assert got.shape == (n_faces, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == (fid >= 0).sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propagate_smooth_assign_exact(seed):
    _, f, counts, sim = _labels_inputs(seed)
    nb = jface.face_adjacency_neighbors(f)
    F, V = counts.shape
    rng = np.random.default_rng(seed + 10)
    labels = np.where(rng.random(F) < 0.5, rng.integers(0, V, F), -1)
    np.testing.assert_array_equal(tface.propagate_labels_once(nb, labels, V),
                                  jface.propagate_labels_once(nb, labels, V))
    np.testing.assert_array_equal(tface.smooth_labels_once(nb, labels),
                                  jface.smooth_labels_once(nb, labels))
    want = jface.assign_face_views(nb, counts, sim)
    got = tface.assign_face_views(nb, counts, sim)
    np.testing.assert_array_equal(got, want)
    # the invisible cube faces took a label from their neighbours; the
    # padding faces and the lone face, with no labeled neighbour, stay
    # unlabeled (-1)
    invisible = (counts == 0).all(1)
    assert invisible[:-6].sum() > 0 and (got[:-6][invisible[:-6]] >= 0).all()
    assert (got[-5:] == -1).all()


def test_face_corner_uvs_match():
    v, f = _mesh(n_pad=0)
    rng = np.random.default_rng(3)
    ctr = rng.uniform(-0.1, 0.1, (8, 1, 2)).astype(np.float32)
    scl = rng.uniform(0.8, 1.2, (8, 1, 1)).astype(np.float32)
    sf = rng.uniform(0.7, 1.0, 8).astype(np.float32)
    fv = rng.integers(-1, 8, len(f))
    want = jface.face_corner_uvs(jrig(8, 1.6, 128), v, f, jnp.asarray(ctr),
                                 jnp.asarray(scl), 0.05, jnp.asarray(sf), fv)
    got = tface.face_corner_uvs(trig(8, 1.6, 128, device="cpu"), v, f,
                                torch.as_tensor(ctr), torch.as_tensor(scl),
                                0.05, torch.as_tensor(sf), fv)
    assert got.shape == (len(f), 3, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_save_multi_material_obj_matches_jax(tmp_path):
    v, f = _mesh(n_pad=0)
    rng = np.random.default_rng(4)
    fv = rng.integers(-1, 8, len(f))
    uvs = rng.random((len(f), 3, 2)).astype(np.float32)
    imgs = rng.random((8, 16, 16, 3)).astype(np.float32)
    jpath = jexport.save_multi_material_obj(v, f, fv, uvs, imgs,
                                            str(tmp_path / "jax"))
    tpath = texport.save_multi_material_obj(v, f, fv, uvs,
                                            torch.as_tensor(imgs),
                                            str(tmp_path / "torch"))
    assert os.path.basename(tpath) == "model_normalized.obj"
    for ext in (".obj", ".mtl"):
        with open(jpath[:-4] + ext) as a, open(tpath[:-4] + ext) as b:
            want, got = a.read(), b.read()
        assert got == want
    # every face in one of the 8 groups (view < 0 -> view 0)
    text = open(tpath).read()
    assert text.count("usemtl ") == 8 and text.count("\nf ") == len(f)
    for i in range(8):
        # the same pixels, stored flipped (vt has v up)
        a = tio.load_png(os.path.join(os.path.dirname(jpath), f"{i}.png"))
        b = tio.load_png(os.path.join(os.path.dirname(tpath), f"{i}.png"))
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b[::-1], tio.to_uint8(imgs[i]))
