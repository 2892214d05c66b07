"""PyTorch port, K2's plain version (models/diffusion/attention.py)
against the Pallas kernel `fused_attention_qkv` in interpret mode, on the
packed legacy qkv layout.  Tolerances: fp32 within 1e-5 (same math, other
summation order); bf16 within 2e-2 (both cast the softmax weights to bf16
before the value product; results are bf16, ulp 2^-8 relative).  A model
of the card's bf16 tensor-core kernel (csrc/attention.cu), which rounds
the unnormalised weights instead, is held to the same 2e-2 and to 2e-2 of
max |out|: the gates chip_smoke.py holds the kernel to against the plain
version."""
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


def _tensor_core_model(qkv: np.ndarray, heads: int) -> torch.Tensor:
    """The arithmetic of the bf16 kernel in csrc/attention.cu: 64-key
    tiles, fp32 scores, a running row max m, p = 2^(s c - m c) with c =
    hd^-1/2 log2(e) in fp32, the running sum l over the unrounded p, the
    unnormalised p rounded to bf16 for the value product (fp32 sums), one
    divide by l at the end, the output rounded to bf16."""
    b, t, c3 = qkv.shape
    hd = c3 // (3 * heads)
    x = torch.as_tensor(qkv).bfloat16().float().reshape(b, t, heads, 3, hd)
    q, k, v = x.unbind(3)                                  # [b, t, h, hd]
    scale = 1.0 / (hd ** 0.25)
    c = torch.tensor(scale * scale) * torch.tensor(1.4426950408889634)
    m = torch.full((b, heads, t), -torch.inf)
    l = torch.zeros((b, heads, t))
    o = torch.zeros((b, heads, t, hd))
    for k0 in range(0, t, 64):
        s = torch.einsum("bthd,bshd->bhts", q, k[:, k0:k0 + 64])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p.bfloat16().float(), v[:, k0:k0 + 64])
        m = m_new
    out = (o / l[..., None]).bfloat16()
    return out.permute(0, 2, 1, 3).reshape(b, t, heads * hd)


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


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("t", [72, 136])
def test_attention_plain_bf16_ragged_matches_pallas(hd, t):
    # the training path's bf16 head dims at T that leaves a ragged 64-row
    # tile, the shapes of the kernel's masked instantiations
    heads = 2
    rng = np.random.default_rng(10 * hd + t)
    qkv = rng.standard_normal((B, t, 3 * heads * hd)).astype(np.float32)
    want = fused_attention_qkv(jnp.asarray(qkv, jnp.bfloat16), heads, hd,
                               interpret=True)
    got = attention_qkv_plain(torch.as_tensor(qkv).bfloat16(), heads)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("t", [64, 136, 256])
def test_tensor_core_rounding_matches_pallas(hd, t):
    # what the card's bf16 kernel computes (flash order, unnormalised
    # weights rounded to bf16) against the Pallas kernel, which rounds the
    # normalised weights, within chip_smoke.py's gates: 2e-2, and 2e-2 of
    # max |out|
    heads = 2
    rng = np.random.default_rng(100 * hd + t)
    qkv = rng.standard_normal((B, t, 3 * heads * hd)).astype(np.float32)
    want = np.asarray(fused_attention_qkv(
        jnp.asarray(qkv, jnp.bfloat16), heads, hd,
        interpret=True).astype(jnp.float32))
    got = _tensor_core_model(qkv, heads).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


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
