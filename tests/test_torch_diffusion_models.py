"""PyTorch port, the diffusion models beside the UNet: SuperResModel, the
EncoderUNetModel classifier in both pools (its AttentionPool2d) and the
DDPM UNet of the CelebA-HQ checkpoints, each at a tiny width with every
weight randomised, carried across from the JAX package's params
(`params_from_jax`, `encoder_params_from_jax`, `ddpm_params_from_jax`) and
held to the JAX forward on the same inputs: within 1e-5 of the largest
output (fp32 on the CPU, TF32 off; the same math in other summation
orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.models.diffusion import ddpm_unet as jddpm
from pointdreamer_tpu.models.diffusion import unet as junet
from pointdreamer_tpu.models.diffusion.convert import \
    convert_encoder_state_dict
from pointdreamer_tpu_torch.models.diffusion import build_unet
from pointdreamer_tpu_torch.models.diffusion import ddpm_unet as tddpm
from pointdreamer_tpu_torch.models.diffusion import unet as tunet
from pointdreamer_tpu_torch.models.diffusion.convert import (
    encoder_params_from_jax, params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,))
TOL = 1e-5


def _randomize(params, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        params)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(want).max() > 1e-2
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _load(model, sd):
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model.eval()


def test_superres_matches_jax():
    jm = junet.SuperResModel(unet=junet.UNetModel(dtype=jnp.float32, **TINY))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(t), jnp.asarray(low))["params"],
                        1)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(low))
    tm = _load(tunet.SuperResModel(**TINY), params_from_jax(params, **TINY))
    assert tm.input_blocks[0][0].weight.shape[1] == 6
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(t),
                 torch.as_tensor(low)).numpy()
    _close(got, want)


@pytest.mark.parametrize("pool", ["adaptive", "attention"])
def test_encoder_matches_jax(pool):
    kw = dict(TINY, out_channels=10)
    jm = junet.EncoderUNetModel(dtype=jnp.float32, pool=pool, **kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([10.0, 400.0], np.float32)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(t))["params"], 3)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    sd = encoder_params_from_jax(params, pool=pool, **TINY)
    tm = _load(tunet.EncoderUNetModel(pool=pool, image_size=16, **kw), sd)
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    _close(got, want)
    # the state dict is the reference classifier's: the JAX converter maps
    # it back to the same tree
    back = convert_encoder_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, pool=pool,
        **TINY)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got_leaf = back
        for key in path:
            got_leaf = got_leaf[key.key]
        np.testing.assert_array_equal(np.asarray(got_leaf), np.asarray(leaf))


def test_attention_pool_matches_jax():
    jm = junet.AttentionPool2d(num_head_channels=8, out_dim=5)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 4, 32)).astype(np.float32)
    params = _randomize(jm.init(jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"], 5, 0.5)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = tunet.AttentionPool2d(4, 32, 8, 5)
    p = jax.tree_util.tree_map(np.asarray, params)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in {
        "positional_embedding": p["positional_embedding"].T,
        "qkv_proj.weight": p["qkv_proj"]["kernel"].T[:, :, None],
        "qkv_proj.bias": p["qkv_proj"]["bias"],
        "c_proj.weight": p["c_proj"]["kernel"].T[:, :, None],
        "c_proj.bias": p["c_proj"]["bias"]}.items()})
    with torch.no_grad():
        got = tm(torch.as_tensor(x).permute(0, 3, 1, 2)).numpy()
    _close(got, want)


def test_ddpm_unet_matches_jax():
    plan = jddpm.DDPMPlan(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                          attn_resolutions=(8,), resolution=16)
    params = jddpm.init_ddpm_params(plan, seed=0)
    params = {k: np.asarray(v) + (np.random.default_rng(6).standard_normal(
        v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([5.0, 900.0], np.float32)
    want = jddpm.ddpm_unet_forward(plan, {k: jnp.asarray(v) for k, v in
                                          params.items()},
                                   jnp.asarray(x), jnp.asarray(t))
    tplan = tddpm.DDPMPlan(*plan)
    tm = _load(tddpm.DDPMUNet(tplan), tddpm.ddpm_params_from_jax(params))
    # the parameter names are the reference Model's
    names = set(tm.state_dict())
    assert {"temb.dense.0.weight", "conv_in.weight",
            "down.0.block.0.conv1.weight", "down.0.downsample.conv.weight", "down.1.attn.0.q.weight",
            "mid.block_1.temb_proj.weight", "mid.attn_1.proj_out.weight",
            "up.1.block.1.nin_shortcut.weight", "up.1.upsample.conv.weight",
            "norm_out.weight", "conv_out.bias"} <= names
    assert names == set(params)
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    _close(got, want)


def test_ddpm_timestep_embedding_matches_jax():
    # sin and cos of arguments up to 999: XLA's and the CPU libm's range
    # reductions differ there (1.3e-5 measured), inside one fp32 ulp of the
    # largest argument (2^-14 = 6.1e-5), which bounds the difference
    t = np.array([0.0, 1.0, 17.0, 999.0], np.float32)
    for dim in (32, 33, 128):
        want = np.asarray(jddpm.ddpm_timestep_embedding(jnp.asarray(t), dim))
        got = tddpm.ddpm_timestep_embedding(torch.as_tensor(t), dim).numpy()
        np.testing.assert_allclose(got, want, atol=2.0 ** -14, rtol=0)
        np.testing.assert_allclose(got[:3], want[:3], atol=1e-6, rtol=0)


def test_celeba_plan_layout_matches_jax():
    # the full CelebA-HQ model on the meta device against the JAX random
    # params' shapes
    with torch.device("meta"):
        tm = tddpm.DDPMUNet(tddpm.celeba_plan())
    want = {k: tuple(v.shape) for k, v in
            tddpm.ddpm_params_from_jax(
                jddpm.init_ddpm_params(jddpm.celeba_plan())).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want


def test_builders_give_the_models_on_the_cpu():
    m = build_unet("cpu", torch.float32, cls=tunet.EncoderUNetModel,
                   model_kwargs=dict(TINY, out_channels=4, pool="attention",
                                     image_size=16))
    pos = m.out[2].positional_embedding
    assert pos.shape == (64, 8 * 8 + 1) and float(pos.std()) > 0.05
    with torch.no_grad():
        y = m(torch.zeros((1, 16, 16, 3)), torch.zeros(1))
    assert y.shape == (1, 4) and torch.isfinite(y).all()
    d = tddpm.build_ddpm_unet(tddpm.DDPMPlan(ch=32, ch_mult=(1, 2),
                                             num_res_blocks=1,
                                             attn_resolutions=(8,),
                                             resolution=16), device="cpu")
    with torch.no_grad():
        y = d(torch.zeros((1, 16, 16, 3)), torch.zeros(1))
    assert y.shape == (1, 16, 16, 3) and float(y.abs().max()) > 0
