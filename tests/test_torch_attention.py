"""PyTorch port, K2's plain version (models/diffusion/attention.py)
against the Pallas kernel `fused_attention_qkv` in interpret mode, on the
packed legacy qkv layout.  Tolerances: fp32 within 1e-5 (same math, other
summation order); bf16 within 2e-2 (both cast the softmax weights to bf16
before the value product; results are bf16, ulp 2^-8 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.kernels.attention_pallas import fused_attention_qkv
from pointdreamer_tpu_torch.models.diffusion.attention import (
    attention_qkv, attention_qkv_plain)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, T, HEADS, HD = 2, 64, 2, 64


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_attention_matches_pallas(dtype, tol):
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((B, T, 3 * HEADS * HD)).astype(np.float32)
    want = fused_attention_qkv(jnp.asarray(qkv, dtype), HEADS, HD,
                               interpret=True)
    got = attention_qkv_plain(
        torch.as_tensor(qkv).to(getattr(torch, dtype)), HEADS)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_attention_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    qkv = torch.as_tensor(rng.standard_normal((1, 32, 3 * 64)).astype(
        np.float32))
    assert torch.equal(attention_qkv(qkv, 1), attention_qkv_plain(qkv, 1))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("t", [64, 72])
def test_attention_gradient_matches_jax_vjp(dtype, tol, hd, t):
    # the port's AttentionQKV (plain forward on the CPU, the reference's
    # recomputed backward) against jax.vjp of the Pallas kernel's custom
    # VJP; T = 72 leaves a ragged 64-row tile.  Tolerances as above: the
    # bf16 backward rounds the value product and its cotangents in bf16
    heads = 2
    rng = np.random.default_rng(hd + t)
    qkv = rng.standard_normal((B, t, 3 * heads * hd)).astype(np.float32)
    g = rng.standard_normal((B, t, heads * hd)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a: fused_attention_qkv(a, heads, hd,
                                                   interpret=True),
                     jnp.asarray(qkv, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    x = torch.tensor(qkv).to(tdt).requires_grad_(True)
    attention_qkv(x, heads).backward(torch.tensor(g).to(tdt))
    assert x.grad.dtype == tdt
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_attention_backward_saves_only_qkv():
    qkv = torch.randn((1, 8, 3 * 16), requires_grad=True)
    out = attention_qkv(qkv, 1)
    assert out.grad_fn is not None
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == qkv.data_ptr()
