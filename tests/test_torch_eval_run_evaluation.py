"""PyTorch port, eval/run_evaluation.py and eval/selfparity.py against the
JAX package on seeded inputs, all on the CPU.

- evaluate_image_dirs on 6 paired 40^2 PNGs (a seventh with no pair is
  skipped by both): n_images exact, PSNR 1e-4 dB, SSIM 1e-5 (the metrics'
  own tolerances, tests/test_torch_eval_metrics.py); with a feature
  function (FID) 1e-9 relative (float64 numpy and scipy in both, the
  same features); with a distance function (LPIPS) 1e-6; the line
  appended to `out_file` names the same keys.
- texture_self_psnr on a 192-face cube with a per-face UV layout, a
  smooth 256^2 atlas and a 3,000-point cloud: the bake differs between the
  packages (K1's plain version against XLA's `rasterize_tiled`, ROADMAP
  Queue C "Atlas bake"), so a point may find another covered texel, a
  neighbour: matched share within 1e-3, MAE within 1e-3, PSNR within 0.1
  dB.
- evaluate_geometry on two 432-face meshes, 4,000 samples: the same
  numpy draws, the same nearest points; chamfer, F-score, normal
  consistency 1e-6 relative (the metrics tests' tolerance), chamfer-L2
  2e-6 (fp32 distances squared: twice their relative rounding), IoU
  exact.
- selfparity: cube_cloud and sphere_cloud bit-equal; score_exported_mesh
  of one OBJ + PNG within 1e-9 (numpy in both).
"""
import os

import numpy as np
import pytest
import torch

from pointdreamer_tpu.eval import run_evaluation as jre
from pointdreamer_tpu.eval import selfparity as jsp
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.eval import run_evaluation as tre
from pointdreamer_tpu_torch.eval import selfparity as tsp


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("renders")
    rng = np.random.default_rng(0)
    gt, pred = root / "gt", root / "pred"
    for i in range(7):
        a = rng.random((40, 40, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
        tio.save_rgb(a, str(gt / f"{i:03d}.png"))
        if i < 6:
            tio.save_rgb(b, str(pred / f"{i:03d}.png"))
    return str(gt), str(pred)


def _features(x):
    # 4 smooth features an image: its mean colour and brightness
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                   np.float64)
    m = x.mean(axis=(1, 2))
    return np.concatenate([m, m.mean(1, keepdims=True) ** 2], 1)


def _distance(a, b):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    return np.abs(a - b).mean(axis=(1, 2, 3))


@pytest.mark.parametrize("with_nets", [False, True],
                         ids=["psnr_ssim", "fid_lpips"])
def test_evaluate_image_dirs_matches(image_dirs, tmp_path, with_nets):
    gt, pred = image_dirs
    kw = dict(feature_fn=_features, lpips_fn=_distance) if with_nets else {}
    want = jre.evaluate_image_dirs(gt, pred, out_file=str(tmp_path / "j"),
                                   **kw)
    got = tre.evaluate_image_dirs(gt, pred, out_file=str(tmp_path / "t"),
                                  device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["n_images"] == want["n_images"] == 6
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    if with_nets:
        assert abs(got["fid"] - want["fid"]) <= 1e-9 * abs(want["fid"])
        assert abs(got["lpips"] - want["lpips"]) <= 1e-6
    line = open(tmp_path / "t").read()
    assert line.startswith(f"{pred}: {{") and line.endswith("}\n")
    assert line.count("\n") == open(tmp_path / "j").read().count("\n") == 1


def test_evaluate_image_dirs_needs_pairs(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with pytest.raises(FileNotFoundError):
        tre.evaluate_image_dirs(str(tmp_path / "a"), str(tmp_path / "b"),
                                device="cpu")


def _per_face_layout(n_faces: int):
    """A UV layout with one small right triangle per face in a grid of
    cells (no overlap, no shared UVs)."""
    n = int(np.ceil(np.sqrt(n_faces)))
    cell = np.stack(np.divmod(np.arange(n_faces), n), 1).astype(np.float64)
    corners = np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9]])
    uvs = ((cell[:, None, :] + corners[None]) / n).reshape(-1, 2)
    return uvs.astype(np.float32), np.arange(3 * n_faces).reshape(-1, 3)


def test_texture_self_psnr_matches(tmp_path):
    v, f = synthetic.cube_mesh(4)
    uvs, fuv = _per_face_layout(len(f))
    R = 256
    rr, cc = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    atlas = np.stack([rr / R, cc / R, 0.5 + 0.4 * np.sin(rr / 7.0)],
                     -1).astype(np.float32)
    obj = str(tmp_path / "models" / "model_normalized.obj")
    tio.save_textured_obj(v, uvs, f, fuv, obj)
    tio.save_rgb(atlas, obj.replace(".obj", ".png"), flip_vertical=True)
    pts, col = synthetic.cube_cloud(3000, seed=1)
    ply = str(tmp_path / "cube.ply")
    tio.save_colored_pc_ply(pts, col, ply)
    want = jre.texture_self_psnr(obj, ply)
    got = tre.texture_self_psnr(obj, ply, device="cpu")
    assert sorted(got) == sorted(want)
    assert want["points_matched"] > 0.5
    assert abs(got["points_matched"] - want["points_matched"]) <= 1e-3
    assert abs(got["mae"] - want["mae"]) <= 1e-3
    assert abs(got["psnr"] - want["psnr"]) <= 0.1


def test_evaluate_geometry_matches(tmp_path):
    v, f = synthetic.cube_mesh(6)
    rng = np.random.default_rng(3)
    vp = (v * 0.97 + rng.normal(0, 0.005, v.shape)).astype(np.float32)
    pred, gt = str(tmp_path / "pred.obj"), str(tmp_path / "gt.obj")
    tio.save_obj(vp, f, pred)
    tio.save_obj(v, f, gt)
    want = jre.evaluate_geometry(pred, gt, n_samples=4000)
    got = tre.evaluate_geometry(pred, gt, n_samples=4000, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["iou"] == want["iou"]
    for k in want:
        rel = 2e-6 if k == "chamfer_l2" else 1e-6
        assert abs(got[k] - want[k]) <= rel * max(abs(want[k]), 1e-6), k


def test_selfparity_clouds_and_score_match(tmp_path):
    for shape in ("cube", "sphere"):
        jp, jc = getattr(jsp, f"{shape}_cloud")(500, 2)
        tp, tc = getattr(tsp, f"{shape}_cloud")(500, 2)
        assert np.array_equal(jp, tp) and np.array_equal(jc, tc)
    v, f = synthetic.cube_mesh(4)
    uvs, fuv = _per_face_layout(len(f))
    atlas = np.random.default_rng(5).random((32, 32, 3)).astype(np.float32)
    obj = str(tmp_path / "model_normalized.obj")
    tio.save_textured_obj(v, uvs, f, fuv, obj)
    tio.save_rgb(atlas, obj.replace(".obj", ".png"), flip_vertical=True)
    want = jsp.score_exported_mesh(obj, seed=1)
    got = tsp.score_exported_mesh(obj, seed=1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9 * max(abs(want[k]), 1.0), k
    assert os.path.exists(obj.replace(".obj", ".png"))
