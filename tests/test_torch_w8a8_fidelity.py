"""PyTorch port, cli/w8a8_fidelity.py on the CPU at a tiny size: its view
cache is keyed on the cloud and on every view setting (the JAX tool keys
on the cloud's basename and the view size alone, so a geometry change
reuses stale views), an explicit `--calib_margin 0` is applied (the JAX
tool's `if args.calib_margin:` drops it), and the run writes its record."""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from pointdreamer_tpu_torch import config
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.cli import w8a8_fidelity as fid
from pointdreamer_tpu_torch.models import diffusion
from pointdreamer_tpu_torch.config import PipelineConfig
from pointdreamer_tpu_torch.eval.selfparity import sphere_cloud

TINY = dict(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
            attention_ds=[2])

@pytest.fixture(autouse=True)
def one_torch_thread():
    # the test workers share the host: torch's default of one thread per
    # core would oversubscribe it many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture
def clouds(tmp_path):
    cube = synthetic.write_cube_inputs(str(tmp_path / "cube"), n_points=3000,
                                       with_mesh=False)
    sphere = str(tmp_path / "sphere.ply")
    tio.save_colored_pc_ply(*sphere_cloud(3000), sphere)
    return cube, sphere


@pytest.mark.parametrize("field,value", [
    ("geo_from", "hoppe"), ("spr_screen_weight", 4.0), ("grid_res", 64),
    ("view_num", 6), ("res", 128), ("cam_res", 256), ("target_face_num", 500),
    ("crop_padding", 0.1)])
def test_view_cache_key_follows_the_view_settings(clouds, field, value):
    cfg = PipelineConfig(geo_from="SPR")
    key = fid.view_cache_key(cfg, clouds[0])
    assert fid.view_cache_key(PipelineConfig(geo_from="SPR"),
                              clouds[0]) == key
    assert getattr(cfg, field) != value
    assert fid.view_cache_key(dataclasses.replace(cfg, **{field: value}),
                              clouds[0]) != key
    # another cloud under the same basename is another key too
    assert fid.view_cache_key(cfg, clouds[1]) != key
    # settings that do not shape the views leave it alone
    assert fid.view_cache_key(dataclasses.replace(cfg, optimize_iters=3),
                              clouds[0]) == key


def test_cli_on_cpu_applies_an_explicit_zero_margin(clouds, tmp_path,
                                                    monkeypatch):
    # the tiny UNet and views the CPU can run (the CLI's are the 552.8M
    # flagship's, at the pipeline's sizes)
    monkeypatch.setattr(diffusion, "build_unet", functools.partial(
        diffusion.build_unet, model_kwargs=TINY))
    monkeypatch.setattr(config, "PipelineConfig", functools.partial(
        PipelineConfig, res=32, cam_res=64, grid_res=32))
    base = ["--device", "cpu", "--pc_file", clouds[0], "--calib_pc",
            clouds[1], "--cache_dir", str(tmp_path / "cache"),
            "--t_sampling", "3"]
    out = str(tmp_path / "r.json")
    res = fid.main(base + ["--out", out])
    assert res["calib_margin"] == 1.3
    assert json.load(open(out))["int8_static"] == res["int8_static"]
    assert len(os.listdir(tmp_path / "cache")) == 2      # one per cloud
    for leg in ("int8_dynamic", "int8_static"):
        assert res[leg]["finite"] and len(res[leg]["per_view_psnr"]) == 8
        assert res[leg]["psnr_vs_bf16"] < 119.0
    # views from the cache, a margin of 0: every static scale is 0, the
    # activations saturate, and the result is another one
    zero = fid.main(base + ["--out", out, "--calib_margin", "0"])
    assert zero["calib_margin"] == 0.0
    assert len(os.listdir(tmp_path / "cache")) == 2
    assert zero["int8_dynamic"] == res["int8_dynamic"]
    assert zero["int8_static"]["psnr_vs_bf16"] \
        != res["int8_static"]["psnr_vs_bf16"]
    assert np.isfinite(zero["int8_static"]["psnr_vs_bf16"])
