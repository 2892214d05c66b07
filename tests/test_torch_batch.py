"""PyTorch port, pipeline/batch.py::run_dataset.

- Its semantics against the JAX package's run_dataset, with
  `recon_one_textured_mesh` stubbed in both (a Pipeline stand-in that
  writes the OBJ, or raises for the shapes named to fail): the work list
  (sorted, then every shard_count-th from shard_index), 'cached' for a
  shape whose model_normalized.obj exists, 'failed' (traceback logged)
  for one that raises, KeyboardInterrupt passed through, and the same
  records with concurrency 2.  Records are compared exactly, paths
  relative to each run's output directory.
- One real run of the port on the CPU at a tiny configuration (nearest
  fill, SPR at 32^3, 1,000 faces, 4 views at 64^2, 64^2 atlas, 5 Adam
  steps): three clouds, one over max_points; render_after_inference
  (its 20 blender views cut to 64^2 here) and metrics for the shape that
  has ground-truth renders (those of an earlier run of the same cloud).
  Statuses exact, 20 renders, the metrics' keys, PSNR at its 1e-12 MSE
  floor and SSIM 1 (equal renders); the same call again: 'cached'.
- concurrency 2 against concurrency 1 on the two good clouds: the same
  OBJ, atlas PNG and render PNG bytes (the CPU's arithmetic does not
  depend on the thread a shape runs on).
- kernels.count_launch under 16 threads with a short switch interval:
  no lost update.
"""
import functools
import logging
import os
import shutil
import sys
import threading

import pytest

from pointdreamer_tpu.core.config import PipelineConfig as JConfig
from pointdreamer_tpu.pipeline import batch as jbatch
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import kernels
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.config import PipelineConfig as TConfig
from pointdreamer_tpu_torch.config import load_config
from pointdreamer_tpu_torch.eval import render as trender
from pointdreamer_tpu_torch.eval import selfparity as tsp
from pointdreamer_tpu_torch.pipeline import batch as tbatch
from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubPipe:
    """recon_one_textured_mesh writes an empty OBJ, or raises for the
    shapes in `fail` (ValueError) and `interrupt` (KeyboardInterrupt)."""

    def __init__(self, cfg, fail=(), interrupt=()):
        self.cfg, self.fail, self.interrupt = cfg, fail, interrupt
        self.logger = logging.getLogger("stub")
        self.device = "cpu"
        self.calls = []
        self.lock = threading.Lock()

    def recon_one_textured_mesh(self, pc_file, name):
        with self.lock:
            self.calls.append(name)
        if name in self.interrupt:
            raise KeyboardInterrupt
        if name in self.fail:
            raise ValueError(f"{name} fails")
        obj = os.path.join(self.cfg.output_path, name, "models",
                           "model_normalized.obj")
        os.makedirs(os.path.dirname(obj), exist_ok=True)
        open(obj, "w").close()
        return obj


def _relative(results, root):
    return {n: {k: os.path.relpath(v, root) if k == "obj" else v
                for k, v in r.items()} for n, r in results.items()}


def _run(mod, cfg_cls, root, files, **kw):
    cfg = cfg_cls(output_path=str(root))
    pipe = _StubPipe(cfg, fail={"c"}, interrupt=kw.pop("interrupt", ()))
    res = mod.run_dataset(cfg, files, pipe=pipe, **kw)
    return _relative(res, str(root)), sorted(pipe.calls)


@pytest.mark.parametrize("kw", [{}, dict(shard_index=1, shard_count=2),
                                dict(shard_index=0, shard_count=3),
                                dict(concurrency=2)],
                         ids=["all", "shard_1_of_2", "shard_0_of_3",
                              "concurrency_2"])
def test_semantics_match_jax(tmp_path, kw):
    files = [f"/data/{n}.ply" for n in ("e", "b", "c", "a", "d")]
    out = {}
    for name, mod, cfg_cls in (("jax", jbatch, JConfig),
                               ("port", tbatch, TConfig)):
        root = tmp_path / name
        # 'd' is done already: resumed as cached, never reconstructed
        os.makedirs(root / "d" / "models")
        open(root / "d" / "models" / "model_normalized.obj", "w").close()
        out[name] = _run(mod, cfg_cls, root, files, **dict(kw))
    assert out["port"] == out["jax"]
    res, calls = out["port"]
    work = sorted(files)[kw.get("shard_index", 0)::kw.get("shard_count", 1)]
    names = [os.path.basename(f)[:-4] for f in work]
    assert list(res) == names
    assert calls == [n for n in names if n != "d"]
    for n in names:
        want = {"d": "cached", "c": "failed"}.get(n, "ok")
        assert res[n]["status"] == want
        assert ("obj" in res[n]) == (want != "failed")


@pytest.mark.parametrize("concurrency", [1, 2])
def test_keyboard_interrupt_passes_through(tmp_path, concurrency):
    files = ["/data/a.ply", "/data/b.ply"]
    for mod, cfg_cls in ((jbatch, JConfig), (tbatch, TConfig)):
        with pytest.raises(KeyboardInterrupt):
            _run(mod, cfg_cls, tmp_path / mod.__name__, files,
                 interrupt={"b"}, concurrency=concurrency)


def test_count_launch_loses_no_update():
    old = sys.getswitchinterval()
    before = kernels.LAUNCHES["segment_sum"]
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernels.count_launch("segment_sum")
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernels.LAUNCHES["segment_sum"] - before == 16 * 2000
    kernels.LAUNCHES["segment_sum"] = before


# ---- real runs of the port on the CPU -------------------------------------

TINY = dict(geo_from="SPR", grid_res=32, target_face_num=1000, cam_res=64,
            res=64, xatlas_texture_res=64, optimize_iters=5, view_num=4,
            render_after_inference=True)


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    d = tmp_path_factory.mktemp("clouds")
    synthetic.write_cube_inputs(str(d), n_points=3000, seed=0,
                                with_mesh=False)
    pts, col = tsp.sphere_cloud(3000)
    tio.save_colored_pc_ply(pts, col, str(d / "sphere.ply"))
    pts, col = tsp.sphere_cloud(30001, seed=1)       # over max_points
    tio.save_colored_pc_ply(pts, col, str(d / "broken.ply"))
    return {n: str(d / f"{n}.ply") for n in ("cube", "sphere", "broken")}


@pytest.fixture(scope="module")
def tiny_runs(clouds, tmp_path_factory):
    """run_dataset at concurrency 1 on the two good clouds (its cube renders
    become the cube's ground truth), then at concurrency 2 on all three,
    then that call again."""
    mp = pytest.MonkeyPatch()
    # the CPU run renders its 20 views at 64^2 (the card renders 512^2)
    mp.setattr(trender, "render_mesh_dir",
               functools.partial(trender.render_mesh_dir, res=64))
    root = tmp_path_factory.mktemp("runs")
    gt = str(root / "gt_cube")
    pipe = None
    runs = {}
    try:
        for name, files, conc in (
                ("c1", [clouds[n] for n in ("cube", "sphere")], 1),
                ("c2", [clouds[n] for n in ("cube", "sphere", "broken")], 2),
                ("again", [clouds[n] for n in ("cube", "sphere")], 2)):
            cfg = load_config(os.path.join(REPO, "configs", "nearest.yaml"))
            out = str(root / ("c2" if name == "again" else name))
            for k, v in dict(TINY, output_path=out).items():
                setattr(cfg, k, v)
            if pipe is None:
                pipe = Pipeline.create(cfg, device="cpu")
            pipe.cfg = cfg
            runs[name] = (cfg, tbatch.run_dataset(
                cfg, files, gt_render_dirs=None if name == "c1" else
                {"cube": gt}, concurrency=conc, pipe=pipe))
            if name == "c1":
                shutil.copytree(runs[name][1]["cube"]["renders"], gt)
    finally:
        mp.undo()
    return runs


def test_real_run_statuses_renders_and_metrics(tiny_runs):
    _, res = tiny_runs["c2"]
    assert {n: r["status"] for n, r in res.items()} == \
        {"broken": "failed", "cube": "ok", "sphere": "ok"}
    for n in ("cube", "sphere"):
        pngs = sorted(os.listdir(res[n]["renders"]))
        assert pngs == [f"{i:03d}.png" for i in range(20)]
    assert "metrics" not in res["sphere"]
    m = res["cube"]["metrics"]
    assert sorted(m) == ["n_images", "psnr", "ssim"]
    assert m["n_images"] == 20
    # the same cloud and settings as the ground truth's run: equal renders
    # (PSNR at its 1e-12 MSE floor)
    assert m["psnr"] == pytest.approx(120.0) and m["ssim"] == \
        pytest.approx(1.0)
    assert {n: r["status"] for n, r in tiny_runs["c1"][1].items()} == \
        {"cube": "ok", "sphere": "ok"}
    # resumed: every shape that has its OBJ comes back cached
    _, again = tiny_runs["again"]
    assert {n: r["status"] for n, r in again.items()} == \
        {"cube": "cached", "sphere": "cached"}


def test_concurrent_run_equals_serial_run(tiny_runs):
    (cfg1, r1), (cfg2, r2) = tiny_runs["c1"], tiny_runs["c2"]
    for n in ("cube", "sphere"):
        for rel in ("models/model_normalized.obj",
                    "models/model_normalized.png"):
            with open(os.path.join(cfg2.output_path, n, rel), "rb") as a, \
                    open(os.path.join(cfg1.output_path, n, rel), "rb") as b:
                assert a.read() == b.read(), (n, rel)
        for i in range(20):
            with open(os.path.join(cfg2.output_path, n, "renders",
                                   f"{i:03d}.png"), "rb") as a, \
                    open(os.path.join(cfg1.output_path, n, "renders",
                                      f"{i:03d}.png"), "rb") as b:
                assert a.read() == b.read(), (n, i)
