"""PyTorch port, the diffusion models beside the UNet: SuperResModel, the
EncoderUNetModel classifier in both pools (its AttentionPool2d) and the
DDPM UNet of the CelebA-HQ checkpoints, each at a tiny width with every
weight randomised, carried across from the JAX package's params
(`params_from_jax`, `encoder_params_from_jax`, `ddpm_params_from_jax`) and
held to the JAX forward on the same inputs: within 1e-5 of the largest
output (fp32 on the CPU, TF32 off; the same math in other summation
orders).  Then the UNet's route of its GroupNorm sites: each a fused
K5 norm (its plain version on the CPU) over channels-last activations,
held to the unfused chain and to the JAX forward; and the places where
it keeps the chain (a gradient to carry, a tp shard's groups)."""
import copy

import jax
import jax.numpy as jnp
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


# ---- the K5 route: one fused norm a GroupNorm site, channels last --------

def _count_fused(monkeypatch):
    """The [B, S, C] input of each fused norm the UNet runs."""
    calls = []
    real = tunet.fused_groupnorm

    def counted(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(tunet, "fused_groupnorm", counted)
    return calls


def _route(on: bool):
    """The UNet's norm route, or (`on` False) the unfused chain at every
    site."""
    return tunet._fused_norm_ok if on else (lambda *args: False)


def _eps_err(got, want):
    """The benchmark's eps_err: the largest over images of the L2 error
    over the reference's L2 norm."""
    d = (got - want).reshape(len(want), -1)
    return float((np.linalg.norm(d, axis=1) / np.linalg.norm(
        want.reshape(len(want), -1), axis=1)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_route_matches_the_chain_and_jax(dtype, monkeypatch):
    """The tiny UNet with every norm fused, against the same model with
    every norm the unfused chain and against the JAX fp32 forward: fp32
    within 1e-5 of the largest output (measured 2.7e-6), a bf16 torso
    within the benchmark's tiny-UNet eps_err limit of 0.05 (measured
    0.020 fused, 0.022 unfused); one fused norm a GroupNorm module; every
    block's output channels last."""
    jm = junet.UNetModel(dtype=jnp.float32, **TINY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3.0, 700.0], np.float32)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(t))["params"], 5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t)))
    tm = _load(tunet.UNetModel(**TINY), params_from_jax(params, **TINY))
    tm = copy.deepcopy(tm).set_compute_dtype(getattr(torch, dtype))
    blocks = [n for n, m in tm.named_modules() if isinstance(
        m, (tunet.ResBlock, tunet.AttentionBlock))] + ["input_blocks.0.0"]
    not_cl = []
    for n in blocks:
        tm.get_submodule(n).register_forward_hook(
            lambda m, a, out, n=n: None if out.is_contiguous(
                memory_format=torch.channels_last) else not_cl.append(n))
    calls = _count_fused(monkeypatch)
    outs = {}
    for on in (True, False):
        monkeypatch.setattr(tunet, "_fused_norm_ok", _route(on))
        with torch.no_grad():
            outs[on] = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
        if on:
            n_norms = sum(isinstance(m, torch.nn.GroupNorm)
                          for m in tm.modules())
            # 10 ResBlocks, 4 attention blocks, the head
            assert len(calls) == n_norms == 2 * 10 + 4 + 1
    assert len(calls) == 25 and not not_cl, not_cl
    if dtype == "float32":
        _close(outs[True], want)
        _close(outs[False], want)
    else:
        assert _eps_err(outs[True], want) <= 0.05
        assert _eps_err(outs[False], want) <= 0.05
        assert _eps_err(outs[True], outs[False]) <= 0.05


@pytest.mark.parametrize("kind", ["superres", "encoder"])
def test_k5_route_in_the_other_unets(kind, monkeypatch):
    """SuperResModel and the classifier run the same blocks: one fused
    norm a GroupNorm module, within 1e-5 of the unfused chain (fp32)."""
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal((2, 16, 16, 3)),
                        dtype=torch.float32)
    t = torch.tensor([4.0, 600.0])
    if kind == "superres":
        tm = tunet.SuperResModel(**TINY)
        args = (x, t, torch.as_tensor(rng.standard_normal((2, 8, 8, 3)),
                                      dtype=torch.float32))
    else:
        tm = tunet.EncoderUNetModel(out_channels=10, pool="attention",
                                    image_size=16, **TINY)
        args = (x, t)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, dtype=torch.float64).float() * 0.2)
    calls = _count_fused(monkeypatch)
    with torch.no_grad():
        got = tm(*args).numpy()
        assert len(calls) == sum(isinstance(m, torch.nn.GroupNorm)
                                 for m in tm.modules())
        monkeypatch.setattr(tunet, "_fused_norm_ok", _route(False))
        chain = tm(*args).numpy()
    _close(got, chain)


def test_k5_route_counts_101_sites_at_the_flagship(monkeypatch):
    """The ImageNet-256 UNet (`unet_plan()`'s layout) on the meta device:
    101 fused norms a forward, 84 in the 42 ResBlocks (42 with the
    scale-shift), 16 attention norms, the head's."""
    calls = []

    def counted(x, gamma, beta, ss=None, **kwargs):
        calls.append((tuple(x.shape), ss is not None,
                      kwargs["out_dtype"], kwargs["silu"]))
        return torch.empty(x.shape, dtype=kwargs["out_dtype"],
                           device=x.device)

    monkeypatch.setattr(tunet, "fused_groupnorm", counted)
    monkeypatch.setattr(tunet, "attention_qkv", lambda qkv, heads: torch.empty(
        qkv.shape[:2] + (qkv.shape[2] // 3,), dtype=qkv.dtype,
        device=qkv.device))
    with torch.device("meta"):
        model = tunet.imagenet256_unet()
        x = torch.empty((8, 256, 256, 3))
        t = torch.empty((1,))
    with torch.no_grad():
        eps = model.set_compute_dtype(torch.bfloat16)(x, t)
    assert eps.shape == (8, 256, 256, 6)
    assert len(calls) == 101
    assert sum(ss for _, ss, _, _ in calls) == 42
    assert sum(not silu for _, _, _, silu in calls) == 16
    assert calls[-1] == ((8, 65536, 256), False, torch.float32, True)
    assert sum(math.prod(c[0]) for c in calls) == pytest.approx(3.20e9,
                                                                rel=1e-2)


@pytest.mark.parametrize("case", ["grad", "tp_groups"])
def test_k5_route_keeps_the_chain_where_it_cannot_go(case, monkeypatch):
    """K5 has no backward and takes 32 groups: a forward that carries
    gradients, and a tp shard's out norm (32 / tp groups), run the chain,
    with their gradients and the chain's outputs."""
    calls = _count_fused(monkeypatch)
    rng = np.random.default_rng(9)
    if case == "grad":
        tm = tunet.UNetModel(**TINY)
        tunet.init_random_(tm, 3)
        with torch.no_grad():
            for name, p in tm.named_parameters():
                if not p.abs().max():
                    p.copy_(torch.randn(p.shape, dtype=torch.float64)
                            .float() * 0.05)
        x = torch.as_tensor(rng.standard_normal((2, 16, 16, 3)),
                            dtype=torch.float32)
        t = torch.tensor([10.0, 500.0])
        got = tm(x, t)
        got.square().mean().backward()
        assert not calls
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   and p.grad.abs().max() > 0 for p in tm.parameters())
        with torch.no_grad():
            fused = tm(x, t)
        assert len(calls) == 25
        _close(fused.numpy(), got.detach().numpy())
        return
    norm = torch.nn.GroupNorm(16, 64)          # tp 2 of a 64-channel norm
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(rng.standard_normal(64)))
        norm.bias.copy_(torch.as_tensor(rng.standard_normal(64)))
    x = torch.as_tensor(rng.standard_normal((2, 64, 8, 8)),
                        dtype=torch.float32).to(
        memory_format=torch.channels_last)
    ss = torch.as_tensor(rng.standard_normal((1, 128)),
                         dtype=torch.float32).to(torch.bfloat16)
    with torch.no_grad():
        got = tunet._norm_act(norm, x, ss, out_dtype=torch.bfloat16)
    assert not calls
    want = F.group_norm(x.float(), 16, norm.weight, norm.bias, norm.eps
                        ).to(torch.bfloat16)
    scale, shift = ss[:, :, None, None].chunk(2, dim=1)
    torch.testing.assert_close(got, F.silu(want * (1 + scale) + shift),
                               rtol=0, atol=0)
