"""PyTorch port, the DDPM training slice (models/diffusion/{synthetic_images,
train}.py, cli/train_ddnm_synthetic.py) against the JAX package on the
CLI's model (32 channels, channel_mult (1, 2, 2), attention at ds 4 in
heads of 16, fp32), its weights carried across with `params_from_jax`
and every leaf randomized so no layer is the zero init.

Tolerances:
- images: 1e-6 (the same fp32 formula; XLA may contract a product into an
  FMA where torch rounds twice);
- loss: 1e-6 relative; gradients per tensor within 1e-4 of that tensor's
  largest entry plus 1e-6 of the largest gradient of all (the conv biases
  just before a GroupNorm get gradients that cancel to ~1e-9, rounding of
  O(0.1) terms, in both packages);
- Adam against optax: 1e-6 relative to the parameters' scale;
- two train steps: the mean loss within 1e-6 relative; parameters within
  2 * lr * steps (Adam turns a rounding-level gradient's sign into a full
  lr step, as ROADMAP Queue C records for the atlas optimizer) and all but
  0.1% of them within 1e-6.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointdreamer_tpu.models.diffusion import train as jtrain
from pointdreamer_tpu.models.diffusion import unet as junet
from pointdreamer_tpu.models.diffusion.synthetic_images import \
    sample_images as jax_sample_images
from pointdreamer_tpu_torch.cli import train_ddnm_synthetic as tcli
from pointdreamer_tpu_torch.models.diffusion import train as ttrain
from pointdreamer_tpu_torch.models.diffusion import unet as tunet
from pointdreamer_tpu_torch.models.diffusion.convert import params_from_jax
from pointdreamer_tpu_torch.models.diffusion.synthetic_images import (
    ImageDraws, images_from_draws, sample_images)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PLAN = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2, 2),
            attention_ds=(4,))
RES, BATCH = 16, 2


def _jax_model():
    return junet.UNetModel(out_channels=3, num_head_channels=16,
                           dtype=jnp.float32, **PLAN)


def _random_params(seed=0):
    shapes = jax.eval_shape(_jax_model().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, RES, RES, 3)), jnp.zeros((1,)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        shapes["params"])


def _port_model(params):
    m = tunet.UNetModel(out_channels=3, num_head_channels=16, **PLAN)
    m.load_state_dict({k: torch.tensor(v) for k, v in
                       params_from_jax(params, **PLAN).items()})
    return m


def _as_state_dict(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), **PLAN)


def test_images_from_draws_matches_jax():
    # the ten draws of the JAX sample_images, reproduced from its splits
    B, R = 4, 32
    key = jax.random.PRNGKey(7)
    ks = jax.random.split(key, 10)
    u = jax.random.uniform
    two_pi = 2.0 * jnp.pi
    jd = [u(ks[0], (B, 1, 1, 3)), u(ks[1], (B, 1, 1, 3)),
          u(ks[2], (B,), minval=0.0, maxval=two_pi),
          u(ks[3], (B, 1, 1), minval=1.0, maxval=4.0),
          u(ks[4], (B, 1, 1), minval=0.0, maxval=two_pi),
          u(ks[5], (B, 1, 1, 3)),
          u(ks[6], (B, 1, 1, 1), minval=0.0, maxval=0.45),
          u(ks[7], (B, 3, 2), minval=0.15, maxval=0.85),
          u(ks[8], (B, 3), minval=0.08, maxval=0.25),
          u(ks[9], (B, 3, 3))]
    draws = ImageDraws(*(torch.tensor(np.asarray(a)) for a in jd))
    want = np.asarray(jax_sample_images(key, B, R))
    got = images_from_draws(draws, R).numpy()
    assert got.shape == (B, R, R, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the port's own sampler: in [0, 1], and reproducible from its seed
    g = torch.Generator().manual_seed(0)
    a = sample_images(g, 3, 16)
    g.manual_seed(0)
    assert torch.equal(a, sample_images(g, 3, 16))
    assert a.shape == (3, 16, 16, 3) and 0 <= a.min() and a.max() <= 1


def _jax_loss_fn(model):
    # train.py:train_epoch's loss_fn, line for line
    acum = jnp.asarray(np.cumprod(1.0 - jtrain.make_betas(1000)),
                       jnp.float32)

    def loss_fn(p, x0, t, eps):
        a = acum[t][:, None, None, None]
        xt = jnp.sqrt(a) * x0 + jnp.sqrt(1.0 - a) * eps
        pred = model.apply({"params": p}, xt,
                           t.astype(jnp.float32))[..., :3]
        return jnp.mean((pred.astype(jnp.float32) - eps) ** 2)
    return loss_fn


def test_ddpm_loss_and_gradients_match_jax():
    params = _random_params()
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    t = np.array([5, 900])
    eps = rng.standard_normal((BATCH, RES, RES, 3)).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(_jax_model())))(
        params, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
    tm = _port_model(params)
    got = ttrain.ddpm_loss(tm, torch.tensor(x0), torch.tensor(t),
                           torch.tensor(eps), ttrain.alphas_cumprod())
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-6 * float(loss)
    want = _as_state_dict(grads)
    top = max(float(np.abs(g).max()) for g in want.values())
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        err = float((p.grad - torch.tensor(want[name])).abs().max())
        assert err <= 1e-4 * float(np.abs(want[name]).max()) + 1e-6 * top, \
            (name, err)


def test_adam_cosine_matches_optax():
    rng = np.random.default_rng(2)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(5)]
    # 4 decay steps: the fifth step reads the schedule past its end
    opt = optax.adam(optax.cosine_decay_schedule(2e-4, 4, alpha=0.1))
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    topt = ttrain.AdamCosine(tp, 2e-4, 4, alpha=0.1)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state)
        jp = optax.apply_updates(jp, upd)
        topt.step([torch.tensor(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-6, rtol=0)
    assert topt.count == 5


def test_train_epoch_matches_jax():
    params = _random_params(3)
    model = _jax_model()
    steps, lr, total = 2, 2e-4, 10
    opt = optax.adam(optax.cosine_decay_schedule(lr, total, alpha=0.1))
    key = jax.random.PRNGKey(3)
    # JAX's own draws, reproduced from the epoch's key splits
    draws, k = [], key
    for _ in range(steps):
        k, k1, k2, k3 = jax.random.split(k, 4)
        x0 = jax_sample_images(k1, BATCH, RES) * 2.0 - 1.0
        t = jax.random.randint(k2, (BATCH,), 0, 1000)
        eps = jax.random.normal(k3, x0.shape, jnp.float32)
        draws.append(tuple(torch.tensor(np.asarray(a)) for a in (x0, t,
                                                                 eps)))
    p_jax, _, _, loss_jax = jtrain.train_epoch(
        model, params, opt.init(params), key, opt, steps, BATCH, RES)
    tm = _port_model(params)
    topt = ttrain.AdamCosine(tm.parameters(), lr, total, alpha=0.1)
    loss = ttrain.train_epoch(tm, topt, None, steps, BATCH, RES,
                              draws=draws)
    assert abs(loss - float(loss_jax)) <= 1e-6 * float(loss_jax)
    want = _as_state_dict(p_jax)
    diff = np.concatenate([(tm.state_dict()[n].numpy() - v).ravel()
                           for n, v in want.items()])
    assert np.abs(diff).max() <= 2 * lr * steps
    assert (np.abs(diff) > 1e-6).mean() <= 1e-3
    for p in tm.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


def test_checkpoint_round_trip_and_jax_pickle(tmp_path):
    params = _random_params(4)
    tm = _port_model(params)
    path = str(tmp_path / "port.pkl")
    ttrain.save_ddpm_checkpoint(path, tm)
    back = tunet.UNetModel(out_channels=3, num_head_channels=16, **PLAN)
    ttrain.load_ddpm_checkpoint(path, back)
    for (n, a), b in zip(tm.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), n
    # a checkpoint the JAX trainer wrote ({"params": flax tree})
    jpath = str(tmp_path / "jax.pkl")
    jtrain.save_ddpm_checkpoint(jpath, params)
    with open(jpath, "rb") as f:
        assert set(pickle.load(f)) == {"params"}
    from_jax = tunet.UNetModel(out_channels=3, num_head_channels=16, **PLAN)
    ttrain.load_ddpm_checkpoint(jpath, from_jax)
    for n, v in from_jax.state_dict().items():
        assert torch.equal(v, tm.state_dict()[n]), n


def test_cli_prints_its_table_on_cpu(tmp_path, capsys):
    rc = tcli.main(["--device", "cpu", "--res", "16", "--epochs", "1",
                    "--steps", "2", "--batch", "2", "--eval-images", "2",
                    "--t-sampling", "2", "--ckpt", str(tmp_path / "c.pkl")])
    out = capsys.readouterr().out
    table = json.loads(out[out.index("{"):])
    assert set(table) == {"DDNM(self-trained)", "nearest(jump-flood)",
                          "linear(pull-push)"}
    assert rc in (0, 1) and os.path.exists(tmp_path / "c.pkl")
    with pytest.raises(NotImplementedError, match="Queue A3"):
        tcli.main(["--device", "cpu", "--quant-fidelity"])
