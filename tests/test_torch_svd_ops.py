"""PyTorch port, the SVD degradation operators and the general DDNM+
sampler (models/diffusion/svd_ops.py) against the JAX package on the CPU:

- each of the ten operators' to_spec, from_spec and A within 1e-5 of the
  largest value (the same float32 matrices, other summation orders);
- ddnm_lambda and ddnm_noise_coeffs bit-equal (elementwise IEEE
  arithmetic in the same order);
- ddnm_plus_sample with a tiny fp32 UNet (its weights carried across by
  `params_from_jax`) fed JAX's own draws (the test repeats JAX's key
  splits: split(key) for x_T, then split(key, 3) per step, k1 on a
  forward step and k2 on a time-travel step), within 1e-4 after 10
  sampling steps, at sigma_y 0 and 0.05, with travel_length 1 and 2.
TF32 is off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.models.diffusion import ddnm as jddnm
from pointdreamer_tpu.models.diffusion import svd_ops as JS
from pointdreamer_tpu.models.diffusion import unet as junet
from pointdreamer_tpu_torch.models.diffusion import svd_ops as TS
from pointdreamer_tpu_torch.models.diffusion import unet as tunet
from pointdreamer_tpu_torch.models.diffusion.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H = W = 16
_XS = np.arange(-4, 5, dtype=np.float64)
_BLUR = np.array([0.06136, 0.24477, 0.38774, 0.24477, 0.06136])
_KX = np.exp(-_XS ** 2 / 18.0)
_KY = np.exp(-_XS ** 2 / 2.0)
_A = np.random.default_rng(9).standard_normal((20, 4 * 4 * 3))
_MASK = (np.random.default_rng(8).random((H, W)) < 0.5).astype(np.float32)

# name -> (image side, args of the JAX and the port factory)
OPS = {
    "inpainting": (H, lambda m, **d: m.inpainting_op(_MASK, **d)),
    "colorization": (H, lambda m, **d: m.colorization_op(H, W, **d)),
    "sr2": (H, lambda m, **d: m.super_resolution_op(H, W, 2, **d)),
    "sr4": (H, lambda m, **d: m.super_resolution_op(H, W, 4, **d)),
    "deblur": (H, lambda m, **d: m.deblurring_op(_BLUR, H, W, **d)),
    "cs": (32, lambda m, **d: m.compressed_sensing_op(32, 32, 0.25,
                                                      seed=3, **d)),
    "denoising": (H, lambda m, **d: m.denoising_op(**d)),
    "deblur_aniso": (H, lambda m, **d: m.deblurring2d_op(
        _KY / _KY.sum(), _KX / _KX.sum(), H, W, **d)),
    "sr_conv2": (H, lambda m, **d: m.sr_conv_op(
        np.exp(-_XS ** 2 / 2.0), H, W, 2, **d)),
    "cs_wh": (H, lambda m, **d: m.walsh_hadamard_cs_op(H, W, 4, seed=5,
                                                       **d)),
    "general": (4, lambda m, **d: m.general_a_op(_A, 4, 4, 3, **d)),
}


def _pair(name):
    side, make = OPS[name]
    return side, make(JS), make(TS, device="cpu")


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        (err, np.abs(want).max())


@pytest.mark.parametrize("name", list(OPS))
def test_operator_maps_match_jax(name):
    side, jop, top = _pair(name)
    x = np.random.default_rng(1).standard_normal(
        (2, side, side, 3)).astype(np.float32)
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(top.singulars.numpy(),
                                  np.asarray(jop.singulars))
    spec = np.asarray(jop.to_spec(jnp.asarray(x)))
    _close(top.to_spec(xt), spec, 1e-5)
    _close(top.from_spec(torch.as_tensor(spec)),
           jop.from_spec(jnp.asarray(spec)), 1e-5)
    _close(top.A(xt), jop.A(jnp.asarray(x)), 1e-5)
    _close(TS.measure_spec(top, xt), JS.measure_spec(jop, jnp.asarray(x)),
           1e-5)


@pytest.mark.parametrize("sigma_y", [0.0, 0.05])
@pytest.mark.parametrize("t_next", [499, 0, -1])
def test_lambda_and_noise_coeffs_are_exact(sigma_y, t_next):
    at = jddnm.compute_alpha(jddnm.make_betas(1000), t_next)
    a_np = np.sqrt(np.float32(at))
    st_np = np.sqrt(np.float32(1) - np.float32(at))
    s_np = np.concatenate([
        np.zeros(4), np.random.default_rng(t_next + 1).random(60) * 2,
        [1e-3, 0.25, 1.0, 5.0]]).astype(np.float32)
    eta = 0.85
    jl, jc = JS.ddnm_lambda(jnp.asarray(s_np), jnp.asarray(a_np),
                            jnp.float32(sigma_y), jnp.asarray(st_np), eta)
    jd1, jd2 = JS.ddnm_noise_coeffs(jnp.asarray(s_np), jc, jnp.asarray(a_np),
                                    jnp.float32(sigma_y), jnp.asarray(st_np),
                                    eta)
    s, a, st = (torch.as_tensor(v) for v in (s_np, a_np, st_np))
    sy = torch.tensor(sigma_y, dtype=torch.float32)
    tl, tc = TS.ddnm_lambda(s, a, sy, st, eta)
    td1, td2 = TS.ddnm_noise_coeffs(s, tc, a, sy, st, eta)
    for got, want in ((tl, jl), (tc, jc), (td1, jd1), (td2, jd2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if sigma_y and t_next >= 0:
        assert tc.any() and not tc.all()


TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,), num_head_channels=16)


def _tiny_pair(seed=0):
    jm = junet.UNetModel(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
                     jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.2).astype(np.float32),
        params)
    tm = tunet.UNetModel(**TINY)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        params_from_jax(params, **tm.plan_kwargs).items()})
    return jm, params, tm.eval()


def jax_draws(key, shape, t_sampling, travel_length, travel_repeat):
    """The draws ddnm_plus_sample makes from `key`, in its order: x_T, then
    one a step (k1 on a forward step, k2 on a time travel)."""
    times = jddnm.get_schedule_jump(t_sampling, travel_length, travel_repeat)
    key, sub = jax.random.split(key)
    out = [jax.random.normal(sub, shape)]
    for i, j in zip(times[:-1], times[1:]):
        key, k1, k2 = jax.random.split(key, 3)
        out.append(jax.random.normal(k1 if j < i else k2, shape))
    return np.stack([np.asarray(d) for d in out])


@pytest.mark.parametrize("name,sigma_y,travel", [
    ("inpainting", 0.0, (1, 1)), ("colorization", 0.0, (2, 2)),
    ("sr2", 0.05, (2, 2))])
def test_ddnm_plus_sample_matches_jax(name, sigma_y, travel):
    jm, params, tm = _tiny_pair(3)
    side, jop, top = _pair(name)
    x = np.random.default_rng(4).random((2, side, side, 3)).astype(
        np.float32) * 2 - 1
    y_j = jop.A(jnp.asarray(x))
    y_t = top.A(torch.as_tensor(x))
    _close(y_t, y_j, 1e-5)
    key = jax.random.PRNGKey(7)
    T_S = 10
    want = np.asarray(JS.ddnm_plus_sample(
        jm, params, y_j, lambda: jop, key, sigma_y=sigma_y, t_sampling=T_S,
        travel_length=travel[0], travel_repeat=travel[1]))
    noise = jax_draws(key, x.shape, T_S, *travel)
    n_pairs = len(jddnm.get_schedule_jump(T_S, *travel)) - 1
    assert noise.shape[0] == 1 + n_pairs and (n_pairs > T_S) == (
        travel[0] > 1)
    got = TS.ddnm_plus_sample(tm, torch.as_tensor(np.asarray(y_j)), top,
                              sigma_y=sigma_y, t_sampling=T_S,
                              travel_length=travel[0],
                              travel_repeat=travel[1],
                              noise=torch.as_tensor(noise)).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    assert 0.05 < got.std()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_ddnm_plus_sample_draws_from_a_generator():
    _, _, tm = _tiny_pair(5)
    top = TS.super_resolution_op(H, W, 2, device="cpu")
    y = top.A(torch.rand((1, H, W, 3)) * 2 - 1)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append(TS.ddnm_plus_sample(tm, y, top, generator=g,
                                        t_sampling=4))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        TS.ddnm_plus_sample(tm, y, top, t_sampling=4,
                            noise=torch.zeros((3, 1, H, W, 3)))
