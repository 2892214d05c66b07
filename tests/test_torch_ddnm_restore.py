"""PyTorch port, the DDNM restoration CLI (cli/ddnm_restore.py) against the
JAX package's CLI on the CPU, in both modes, file by file.

Both CLIs run through their `main`, with two things swapped in: a tiny
fp32 UNet in place of the 552.8M one (the JAX package's
`imagenet256_unet` / `init_unet_params`, the port's `build_unet`; one
weight set, carried across by `params_from_jax`), and, in the port, the
JAX CLI's own draws for the sampler (its key splits repeated by
`jax_draws`: the port draws from a torch.Generator).  Both CLIs fix the
image size at 256^2, so they run at 256^2, 3 sampling steps.  The outputs
must have the JAX CLI's names, and each 8-bit image must lie within one
level of JAX's (the PNG rounding of images that agree within 1e-4, as
test_torch_svd_ops.py holds the sampler)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pointdreamer_tpu.models.diffusion as jdiff
from pointdreamer_tpu.cli import ddnm_restore as jcli
from pointdreamer_tpu.models.diffusion import unet as junet
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch.cli import ddnm_restore as tcli
from pointdreamer_tpu_torch.models import diffusion as tdiff
from pointdreamer_tpu_torch.models.diffusion import svd_ops as TS
from pointdreamer_tpu_torch.models.diffusion import unet as tunet
from pointdreamer_tpu_torch.models.diffusion.convert import params_from_jax

from test_torch_svd_ops import jax_draws

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# attention only at 8^2, so that 256^2 inputs stay cheap on the CPU
TINY = dict(model_channels=32, channel_mult=(1, 1, 1, 1, 1, 2),
            num_res_blocks=1, attention_ds=(32,), num_head_channels=16)
STEPS = 3


@pytest.fixture
def tiny_models(monkeypatch):
    jm = junet.UNetModel(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                     jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        params)
    monkeypatch.setattr(jdiff, "imagenet256_unet", lambda: jm)
    monkeypatch.setattr(jdiff, "init_unet_params", lambda model: params)
    tm = tunet.UNetModel(**TINY)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        params_from_jax(params, **tm.plan_kwargs).items()})
    built = []

    def build_unet(device, checkpoint_path=None):
        built.append((str(device), checkpoint_path))
        return tm.eval()

    monkeypatch.setattr(tdiff, "build_unet", build_unet)
    plain = TS.ddnm_plus_sample

    def with_jax_draws(model, y, op, generator=None, **kw):
        assert generator is not None and generator.initial_seed() == 1234
        noise = jax_draws(jax.random.PRNGKey(1234), tuple(y.shape),
                          kw["t_sampling"], 1, 1)
        return plain(model, y, op, noise=torch.as_tensor(noise), **kw)

    monkeypatch.setattr(TS, "ddnm_plus_sample", with_jax_draws)
    return built


def _write(path, w, h, seed):
    rng = np.random.default_rng(seed)
    # smooth content plus noise, so that the crops are not flat
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
    img = np.clip(base + rng.integers(0, 55, (h, w, 3)), 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path)


def _same_outputs(j_dir, t_dir):
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir))
    for n in names:
        a = np.asarray(Image.open(os.path.join(j_dir, n)).convert("RGB"),
                       np.int32)
        b = tio.load_rgb_uint8(os.path.join(t_dir, n)).astype(np.int32)
        assert a.shape == b.shape == (256, 256, 3)
        assert np.abs(a - b).max() <= 1, n
    return names


@pytest.mark.parametrize("deg", ["sr4", "inpainting"])
def test_single_image_matches_jax(deg, tiny_models, tmp_path, monkeypatch):
    src = tmp_path / "in.png"
    _write(src, 256, 256, 1)
    argv = ["--image", str(src), "--deg", deg, "--steps", str(STEPS)]
    for sub in ("jax", "port"):
        os.makedirs(tmp_path / sub)
    monkeypatch.setattr("sys.argv", ["ddnm_restore"] + argv
                        + ["--out", str(tmp_path / "jax" / "out.png")])
    jcli.main()
    tcli.main(argv + ["--device", "cpu",
                      "--out", str(tmp_path / "port" / "out.png")])
    names = _same_outputs(tmp_path / "jax", tmp_path / "port")
    assert names == ["out.png", "out_degraded.png"]
    assert tiny_models == [("cpu", None)]
    out = tio.load_rgb(str(tmp_path / "port" / "out.png"))
    assert out.std() > 0.05


def test_dataset_mode_matches_jax(tiny_models, tmp_path, monkeypatch):
    root = tmp_path / "imgs"
    os.makedirs(root)
    _write(root / "a.png", 700, 520, 2)     # BOX halving, then BICUBIC
    _write(root / "b.png", 300, 260, 3)     # BICUBIC only
    argv = ["--image_dir", str(root), "--dataset", "IMAGENET", "--deg",
            "sr_conv2", "--batch", "2", "--steps", str(STEPS),
            "--sigma_y", "0.05"]
    monkeypatch.setattr("sys.argv", ["ddnm_restore"] + argv
                        + ["--out", str(tmp_path / "jax")])
    jcli.main()
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    names = _same_outputs(tmp_path / "jax", tmp_path / "port")
    assert names == ["a.png", "a_degraded.png", "b.png", "b_degraded.png"]


def test_every_degradation_builds_at_256(tmp_path):
    for deg in tcli.DEGRADATIONS:
        op = tcli.degradation(deg, 256, 256, 1234, "cpu")
        x = torch.rand((1, 256, 256, 3)) * 2 - 1
        assert op.A(x).shape == x.shape, deg


def test_the_cli_needs_cuda_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--image", "x.png", "--out", str(tmp_path / "o.png")])
