"""PyTorch port, its boundaries: it imports nothing of the JAX package and
none of PIL, cv2 or PyYAML (not dependencies of the port), its entry
points need CUDA unless the CPU is asked for, and its kernel wrappers take
the plain version only for CPU tensors."""
import ast
import os

import numpy as np
import pytest
import torch

from pointdreamer_tpu_torch import kernels
from pointdreamer_tpu_torch.config import load_config
from pointdreamer_tpu_torch.kernels import groupnorm as tgn
from pointdreamer_tpu_torch.kernels import winograd as twino
from pointdreamer_tpu_torch.models.diffusion import attention as tattn
from pointdreamer_tpu_torch.ops import raster as traster
from pointdreamer_tpu_torch.pipeline import optimize as topt
from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "PIL", "cv2", "yaml",
             "matplotlib", "pointdreamer_tpu"}


def _port_sources():
    pkg = os.path.join(REPO, "pointdreamer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_forbidden():
    found = []
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("ops/sdf.py", "ops/iso.py", "ops/mc_table.py", "ops/qem.py",
                "ops/knn.py", "pipeline/geometry.py", "baselines/spr.py",
                "kernels/groupnorm.py", "kernels/winograd.py",
                "models/diffusion/train.py",
                "models/diffusion/synthetic_images.py",
                "cli/train_ddnm_synthetic.py",
                "models/occupancy/__init__.py", "models/occupancy/alt.py",
                "models/occupancy/convert.py", "models/occupancy/datasets.py",
                "models/occupancy/fkaconv.py", "models/occupancy/network.py",
                "models/occupancy/spatial.py",
                "models/occupancy/synthetic.py", "models/occupancy/train.py",
                "models/occupancy/transforms.py", "eval/metrics.py",
                "cli/generate.py", "cli/train_poco_synthetic.py",
                "eval/render.py", "eval/run_evaluation.py",
                "eval/selfparity.py", "models/perception/__init__.py",
                "models/perception/vgg.py", "models/perception/inception.py",
                "models/perception/convert.py", "pipeline/batch.py",
                "cli/render_meshes.py", "cli/run_evaluation.py",
                "cli/eval_meshes.py", "cli/eval_point2surf.py",
                "cli/geometry_table.py", "kernels/quant.py",
                "cli/w8a8_fidelity.py", "models/texture_field/__init__.py",
                "models/texture_field/triplane.py",
                "pipeline/face_assign.py", "models/diffusion/svd_ops.py",
                "models/diffusion/ddpm_unet.py",
                "models/diffusion/datasets.py",
                "models/diffusion/ckpt_util.py", "ops/resample.py",
                "cli/ddnm_restore.py", "baselines/nksr.py",
                "cli/nksr_baseline.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/dryrun.py", "data/sample.py",
                "mesh.py", "vis.py", "jpeg.py", "webp.py", "vp8.py",
                "vp8l.py", "gif.py", "tiff.py", "imagemode.py",
                "config.py", "io.py", "ops/image.py", "yamlread.py",
                "fax.py", "tga.py", "pcx.py", "sgi.py", "qoi.py", "ico.py",
                "msp.py", "xbm.py", "bcn.py", "dds.py", "blp.py", "psd.py",
                "icns.py", "im.py", "spider.py", "fits.py", "xpm.py",
                "fli.py", "sun.py", "dcx.py", "pcd.py", "iptc.py",
                "smallimg.py", "refused.py", "zstd.py", "jp2.py",
                "j2k_codestream.py", "j2k_t2.py", "j2k_t1.py", "j2k_dwt.py",
                "jpeg2000.py"):
        assert os.path.join("pointdreamer_tpu_torch", mod) in scanned
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert found == []


def test_create_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = load_config(os.path.join(REPO, "configs", "nearest.yaml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline.create(cfg)


@pytest.mark.parametrize("call", ["camera_rig", "bake_atlas",
                                  "reconstruct_mesh", "spr_baseline",
                                  "train_ddnm_synthetic", "load_poco_field",
                                  "generate", "train_poco_synthetic",
                                  "render_mesh_dir", "evaluate_image_dirs",
                                  "texture_self_psnr", "evaluate_geometry",
                                  "load_inception_features", "load_lpips",
                                  "run_dataset", "run_roundtrip",
                                  "render_meshes", "run_evaluation",
                                  "eval_meshes", "eval_point2surf",
                                  "geometry_table", "w8a8_fidelity",
                                  "triplane_field", "get_textured_mesh",
                                  "ddnm_restore", "fit_kernel_field",
                                  "recon_one_shape_NKSR", "nksr_baseline",
                                  "build_unet", "build_superres",
                                  "build_encoder", "build_ddpm_unet",
                                  "sample_colored_pc_from_mesh"])
def test_helpers_without_a_device_need_cuda(call, tmp_path):
    # the helpers an entry point calls default to device='cuda' too
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from pointdreamer_tpu_torch.baselines import nksr
    from pointdreamer_tpu_torch.baselines.spr import recon_one_shape_SPR
    from pointdreamer_tpu_torch.camera import make_camera_rig
    from pointdreamer_tpu_torch.data import sample
    from pointdreamer_tpu_torch.cli import (ddnm_restore, eval_meshes,
                                            eval_point2surf, generate,
                                            geometry_table, nksr_baseline,
                                            render_meshes, run_evaluation,
                                            train_ddnm_synthetic,
                                            train_poco_synthetic,
                                            w8a8_fidelity)
    from pointdreamer_tpu_torch.models import diffusion
    from pointdreamer_tpu_torch.eval import render, run_evaluation as reval
    from pointdreamer_tpu_torch.eval.selfparity import run_roundtrip
    from pointdreamer_tpu_torch.models import perception, texture_field
    from pointdreamer_tpu_torch.pipeline.batch import run_dataset
    from pointdreamer_tpu_torch.models.occupancy import load_poco_field
    from pointdreamer_tpu_torch.pipeline.geometry import reconstruct_mesh
    from pointdreamer_tpu_torch.pipeline.unwrap import bake_atlas

    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (100, 3)).astype(np.float32)
    tri = np.arange(6).reshape(2, 3)
    run = {"camera_rig": lambda: make_camera_rig(8, 1.6, 64),
           "bake_atlas": lambda: bake_atlas(pts[:6], tri, pts[:6, :2], tri,
                                            32),
           "reconstruct_mesh": lambda: reconstruct_mesh(pts, "SPR", 16, 100),
           "spr_baseline": lambda: recon_one_shape_SPR(pts, None, 100, 16),
           "train_ddnm_synthetic": lambda: train_ddnm_synthetic.main(
               ["--epochs", "1", "--steps", "1"]),
           "load_poco_field": lambda: load_poco_field("poco.pkl"),
           "generate": lambda: generate.main(["--pc_file", "x.ply",
                                              "--out", "x.obj"]),
           "train_poco_synthetic": lambda: train_poco_synthetic.main(
               ["--epochs", "1", "--steps", "1"]),
           "render_mesh_dir": lambda: render.render_mesh_dir("x.obj", "out"),
           "evaluate_image_dirs": lambda: reval.evaluate_image_dirs("a",
                                                                    "b"),
           "texture_self_psnr": lambda: reval.texture_self_psnr("x.obj",
                                                                "x.ply"),
           "evaluate_geometry": lambda: reval.evaluate_geometry("a.obj",
                                                                "b.obj"),
           "load_inception_features": lambda:
               perception.load_inception_features("x.pth"),
           "load_lpips": lambda: perception.load_lpips("v.pth", "l.pth"),
           "run_dataset": lambda: run_dataset(
               load_config(os.path.join(REPO, "configs", "nearest.yaml")),
               []),
           "run_roundtrip": lambda: run_roundtrip(str(tmp_path)),
           "render_meshes": lambda: render_meshes.main(
               ["--root", "x", "--save_root", "y"]),
           "run_evaluation": lambda: run_evaluation.main(
               ["--gt_root", "x", "--pred_root", "y"]),
           "eval_meshes": lambda: eval_meshes.main(
               ["--pred_root", "x", "--gt_root", "y"]),
           "eval_point2surf": lambda: eval_point2surf.main(
               ["--gendir", "x", "--gtdir", "y"]),
           "geometry_table": lambda: geometry_table.main(["--data", "x"]),
           "w8a8_fidelity": lambda: w8a8_fidelity.main(
               ["--pc_file", "x.ply", "--calib_pc", "y.ply"]),
           "triplane_field": lambda: texture_field.TriplaneColorField(),
           "get_textured_mesh": lambda: texture_field.get_textured_mesh(
               pts[:6], tri, pts, pts + 0.5, atlas_res=32),
           "ddnm_restore": lambda: ddnm_restore.main(
               ["--image", "x.png", "--out", str(tmp_path / "o.png")]),
           "fit_kernel_field": lambda: nksr.fit_kernel_field(pts, pts),
           "recon_one_shape_NKSR": lambda: nksr.recon_one_shape_NKSR(pts),
           "nksr_baseline": lambda: nksr_baseline.main(
               ["--pc_file", "x.ply", "--output", str(tmp_path)]),
           "build_unet": lambda: diffusion.build_unet(),
           "build_superres": lambda: diffusion.build_unet(
               cls=diffusion.SuperResModel, model_kwargs=dict(
                   model_channels=32, channel_mult=(1,), attention_ds=())),
           "build_encoder": lambda: diffusion.build_unet(
               cls=diffusion.EncoderUNetModel,
               model_kwargs=dict(model_channels=128, out_channels=1000,
                                 pool="attention")),
           "build_ddpm_unet": lambda: diffusion.build_ddpm_unet(),
           "sample_colored_pc_from_mesh": lambda:
               sample.sample_colored_pc_from_mesh(pts[:6], tri)}
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|Torch not compiled"):
        run[call]()


def _wrapper_cases():
    rng = np.random.default_rng(0)
    ndc = torch.as_tensor(rng.uniform(-1, 1, (1, 30, 2)).astype(np.float32))
    depth = torch.as_tensor(rng.uniform(0.5, 2, (1, 30)).astype(np.float32))
    faces = torch.as_tensor(rng.integers(0, 30, (40, 3)))
    cof, bbox = traster.prepare_views(ndc, depth, faces, 32)
    qkv = torch.as_tensor(rng.standard_normal((1, 64, 3 * 64)
                                              ).astype(np.float32))
    contrib = torch.as_tensor(rng.standard_normal((12, 50)).astype(np.float32))
    cum = torch.as_tensor(np.sort(rng.integers(0, 51, 16)).astype(np.int32))
    cum[-1] = 50
    tri = traster.prepare_legacy(ndc, depth, faces, 32, True)
    x_gn = torch.as_tensor(rng.standard_normal((2, 24, 64)).astype(np.float32))
    g_gn = torch.as_tensor(rng.standard_normal(64).astype(np.float32))
    ss = torch.as_tensor(rng.standard_normal((2, 128)).astype(np.float32))
    x_w = torch.as_tensor(rng.standard_normal((1, 4, 6, 16)).astype(
        np.float32))
    w_w = torch.as_tensor(rng.standard_normal((3, 3, 16, 32)).astype(
        np.float32))
    return [
        (lambda c, b: traster.rasterize_coefficients(c, b, 32),
         lambda c, b: traster.rasterize_coefficients_plain(c, b, 32),
         (cof, bbox)),
        (lambda t: traster.rasterize_legacy(t, 32),
         lambda t: traster.rasterize_legacy_plain(t, 32), (tri,)),
        (lambda q: tattn.attention_qkv(q, 1),
         lambda q: tattn.attention_qkv_plain(q, 1), (qkv,)),
        (topt.segment_sum, topt.segment_sum_plain, (contrib, cum)),
        (lambda x, g, s: tgn.fused_groupnorm(x, g, g, s),
         lambda x, g, s: tgn.fused_groupnorm_plain(x, g, g, s),
         (x_gn, g_gn, ss)),
        (twino.winograd_conv3x3, twino.winograd_conv3x3_plain, (x_w, w_w)),
    ]


@pytest.mark.parametrize("case", range(6), ids=["raster", "raster_legacy",
                                                "attention", "segment_sum",
                                                "groupnorm", "winograd"])
def test_wrappers_take_the_plain_version_only_on_cpu(case, monkeypatch):
    wrapper, plain, args = _wrapper_cases()[case]

    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(kernels, "lib", no_library)
    before = dict(kernels.LAUNCHES)
    got, want = wrapper(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.LAUNCHES == before
    # any other device goes to the kernel's checks and is refused there:
    # no wrapper falls back to the plain version
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrapper(*[a.to("meta") for a in args])


def test_demo_without_world_size_joins_no_process_group(tmp_path,
                                                         monkeypatch):
    # the demo initialises torch.distributed only under torch.distributed.
    # run (WORLD_SIZE set); a plain run must never create a group
    import torch.distributed as dist

    from pointdreamer_tpu_torch import demo
    from pointdreamer_tpu_torch import synthetic
    from pointdreamer_tpu_torch.pipeline import pipeline as tpipe

    monkeypatch.delenv("WORLD_SIZE", raising=False)

    def no_group(*a, **k):
        raise AssertionError("init_process_group called without WORLD_SIZE")

    monkeypatch.setattr(dist, "init_process_group", no_group)
    ran = []

    class Stub:
        logger = tpipe.get_logger(None)

        def recon_one_textured_mesh(self, pc_file, name):
            ran.append((pc_file, name, dist.is_initialized()))

    monkeypatch.setattr(tpipe.Pipeline, "create",
                        classmethod(lambda cls, cfg, **kw: Stub()))
    ply = synthetic.write_cube_inputs(str(tmp_path / "in"), n_div=2,
                                      n_points=100, with_mesh=False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(open(os.path.join(REPO, "configs", "nearest.yaml")).read()
                   + f"\noutput_path: {tmp_path / 'out'}\n")
    demo.main(["--config", str(cfg), "--pc_file", ply, "--device", "cpu"])
    assert ran == [(ply, "cube_c", False)]
    assert not dist.is_initialized()
    assert demo.init_distributed("cpu") == "cpu"
