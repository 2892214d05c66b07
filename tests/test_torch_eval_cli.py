"""PyTorch port, the evaluation CLIs with `--device cpu` at small sizes, and
the demo's `--concurrency`.

- render_meshes: 4 fibonacci views at 32^2 for each <name>/models/
  model_normalized.obj under --root (a directory without one is skipped).
- run_evaluation: PSNR/SSIM, then FID and LPIPS through torch.save'd
  random Inception / VGG16 / lin-head files; per-name lines and the MEAN.
- eval_meshes and eval_point2surf against the JAX package's CLIs on the
  same meshes (a PLY ground truth for point2surf): the same rows.
  eval_meshes' distances within 2e-6 relative plus 1e-6 (the metrics
  tests' bound; chamfer-L2 squares them); its precision, recall and
  F-score, counts of samples under 0.01, within two samples' share
  (2 / n_samples: a distance within rounding of the threshold counts on
  either side).  eval_point2surf's chamfer and Hausdorff within 2e-6
  relative plus 1e-5: both CLIs take square roots of their kNN's fp32
  |q|^2 - 2 q.r + |r|^2, each within 1.3e-7 of the exact squared
  distance on these samples (measured), which the root turns into up to
  ~7e-6 at the 0.01 distances here.
- geometry_table: SPR and hoppe on one 2,000-point cloud at 32^3, scored
  on 5,000 surface samples (the CLI's 100,000 cut for time); NKSR
  refused with NotImplementedError, POCO without a checkpoint with
  ValueError.
- demo --concurrency 2 on a directory of two clouds: both shapes
  exported, as with --concurrency 1.
"""
import csv
import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from pointdreamer_tpu.cli import eval_meshes as j_eval_meshes
from pointdreamer_tpu.cli import eval_point2surf as j_eval_point2surf
from pointdreamer_tpu.models.perception import convert as jc
from pointdreamer_tpu_torch import demo
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.cli import (eval_meshes, eval_point2surf,
                                        geometry_table, render_meshes,
                                        run_evaluation)
from pointdreamer_tpu_torch.eval import selfparity as tsp


def _textured_cube(path, seed=0):
    v, f = synthetic.cube_mesh(4)
    rng = np.random.default_rng(seed)
    uvs = rng.random((len(v), 2)).astype(np.float32)
    tio.save_textured_obj(v, uvs, f, f, path)
    tio.save_rgb(rng.random((16, 16, 3)), path.replace(".obj", ".png"))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for i, name in enumerate(("a", "b")):
        _textured_cube(str(root / "meshes" / name / "models" /
                           "model_normalized.obj"), seed=i)
    os.makedirs(root / "meshes" / "empty")
    for sub, seed in (("pred", 0), ("gt", 5)):
        render_meshes.main(["--root", str(root / "meshes"), "--save_root",
                            str(root / sub), "--res", "32", "--views", "4",
                            "--distribution", "fibonacci_sphere",
                            "--device", "cpu"])
        if sub == "pred":       # other ground truth: other atlases
            for i, name in enumerate(("a", "b")):
                _textured_cube(str(root / "meshes" / name / "models" /
                                   "model_normalized.obj"), seed=i + 5)
    return root


def test_render_meshes(rendered):
    assert sorted(os.listdir(rendered / "pred")) == ["a", "b"]
    for name in ("a", "b"):
        pngs = sorted(os.listdir(rendered / "pred" / name))
        assert pngs == [f"{i:03d}.png" for i in range(4)]
        assert tio.load_png(str(rendered / "pred" / name / "000.png")).shape \
            == (32, 32, 3)


def test_run_evaluation(rendered, tmp_path, capsys):
    args = ["--gt_root", str(rendered / "gt"), "--pred_root",
            str(rendered / "pred"), "--out", str(tmp_path / "res.txt"),
            "--device", "cpu"]
    run_evaluation.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["a", "b", "MEAN"]
    mean = json.loads(lines[-1][len("MEAN "):])
    assert sorted(mean) == ["n_images", "psnr", "ssim"]
    assert mean["n_images"] == 4 and 5 < mean["psnr"] < 100
    assert len(open(tmp_path / "res.txt").read().splitlines()) == 2

    for name, sd in (("inception", jc.random_inception_state_dict(0)),
                     ("vgg", jc.random_vgg16_state_dict(0)),
                     ("lin", jc.random_lpips_lin_state_dict(1))):
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
                   tmp_path / f"{name}.pth")
    # one pair of directories: FID's 2048^2 matrix square root takes ~20 s
    # on the CPU
    shutil.copytree(rendered / "pred" / "a", tmp_path / "pred_a" / "a")
    args[3] = str(tmp_path / "pred_a")
    run_evaluation.main(args + [
        "--inception_ckpt", str(tmp_path / "inception.pth"),
        "--vgg_ckpt", str(tmp_path / "vgg.pth"),
        "--lpips_ckpt", str(tmp_path / "lin.pth")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["a", "MEAN"]
    mean = json.loads(lines[-1][5:])
    assert sorted(mean) == ["fid", "lpips", "n_images", "psnr", "ssim"]
    assert np.isfinite(mean["fid"]) and mean["lpips"] > 0


def _run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    module.main()


def _close(got, want, count_of=None, atol=1e-6):
    if count_of:
        assert abs(got - want) <= 2.0 / count_of
    else:
        assert abs(got - want) <= 2e-6 * abs(want) + atol, (got, want)


def test_eval_meshes_matches_jax(tmp_path, monkeypatch):
    v, f = synthetic.cube_mesh(6)
    rng = np.random.default_rng(3)
    for name, s in (("a", 0.97), ("b", 1.02)):
        vp = (v * s + rng.normal(0, 0.005, v.shape)).astype(np.float32)
        tio.save_obj(vp, f, str(tmp_path / "pred" / name / "models" /
                                "model_normalized.obj"))
        tio.save_obj(v, f, str(tmp_path / "gt" / f"{name}.obj"))
    argv = ["--pred_root", str(tmp_path / "pred"), "--gt_root",
            str(tmp_path / "gt"), "--n_samples", "3000"]
    _run_jax_cli(j_eval_meshes, argv + ["--out", str(tmp_path / "j.txt")],
                 monkeypatch)
    eval_meshes.main(argv + ["--out", str(tmp_path / "t.txt"), "--device",
                             "cpu"])
    want = [json.loads(x) for x in open(tmp_path / "j.txt")]
    got = [json.loads(x) for x in open(tmp_path / "t.txt")]
    assert [r["name"] for r in got] == [r["name"] for r in want] == \
        ["a", "b", "MEAN"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "name":
                _close(g[k], w[k], 3000 if k in ("precision", "recall",
                                                 "fscore") else None)


def _save_ply_mesh(v, f, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(f)}\nproperty list uchar int "
                 "vertex_indices\nend_header\n")
        fh.writelines(f"{a} {b} {c}\n" for a, b, c in v)
        fh.writelines(f"3 {a} {b} {c}\n" for a, b, c in f)


def test_eval_point2surf_matches_jax(tmp_path, monkeypatch):
    v, f = synthetic.cube_mesh(5)
    tio.save_obj(v * 0.98, f, str(tmp_path / "gen" / "meshes" / "x.obj"))
    _save_ply_mesh(v, f, str(tmp_path / "gt" / "03_meshes" / "x.ply"))
    got_mesh = tio.load_ply_mesh(str(tmp_path / "gt" / "03_meshes" /
                                     "x.ply"))
    assert np.allclose(got_mesh["vertices"], v) and \
        np.array_equal(got_mesh["faces"], f)
    argv = ["--gendir", str(tmp_path / "gen"), "--gtdir",
            str(tmp_path / "gt"), "--samples", "2000"]
    out = tmp_path / "gen" / "hausdorff_dist_pred_rec.csv"
    _run_jax_cli(j_eval_point2surf, argv, monkeypatch)
    want = list(csv.reader(open(out)))
    eval_point2surf.main(argv + ["--device", "cpu"])
    got = list(csv.reader(open(out)))
    assert got[0] == want[0] and len(got) == len(want) == 2
    assert got[1][:2] == want[1][:2]
    for g, w in zip(got[1][2:], want[1][2:]):
        _close(float(g), float(w), atol=1e-5)


def test_geometry_table(tmp_path, monkeypatch):
    # 5,000 surface samples a mesh in place of the CLI's 100,000
    monkeypatch.setattr(geometry_table, "score_mesh", functools.partial(
        geometry_table.score_mesh, n_sample=5000))
    d = tmp_path / "data"
    pts, col = tsp.sphere_cloud(2000)
    tio.save_colored_pc_ply(pts, col, str(d / "ball.ply"))
    out = tmp_path / "table.json"
    geometry_table.main(["--data", str(d), "--out", str(out), "--grid_res",
                         "32", "--target_faces", "500", "--device", "cpu"])
    res = json.load(open(out))
    assert sorted(res["ball"]) == ["SPR", "hoppe"]
    for m in res["ball"].values():
        assert m["chamfer_l1"] < 0.02 and 0 < m["n_faces"] <= 500
    with pytest.raises(NotImplementedError, match="item 7"):
        geometry_table.main(["--data", str(d), "--backends", "NKSR",
                             "--device", "cpu"])
    with pytest.raises(ValueError, match="poco_checkpoint"):
        geometry_table.main(["--data", str(d), "--backends", "POCO",
                             "--device", "cpu"])


def test_demo_concurrency(tmp_path):
    d = tmp_path / "in"
    synthetic.write_cube_inputs(str(d), n_points=2000, seed=0,
                                with_mesh=False)
    pts, col = tsp.sphere_cloud(2000)
    tio.save_colored_pc_ply(pts, col, str(d / "sphere.ply"))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        f"output_path: '{tmp_path / 'out'}'\ngeo_from: 'SPR'\n"
        "texture_gen_method: 'nearest'\ngrid_res: 32\n"
        "target_face_num: 800\ncam_res: 64\nres: 64\nview_num: 4\n"
        "xatlas_texture_res: 64\noptimize_iters: 3\n")
    demo.main(["--config", str(cfg), "--pc_file", str(d), "--device", "cpu",
               "--concurrency", "2"])
    for name in ("cube_tiny", "sphere_tiny"):
        base = tmp_path / "out" / name
        assert (base / "config.yaml").exists()
        for ext in ("obj", "mtl", "png"):
            assert (base / "models" / f"model_normalized.{ext}").exists()
