"""PyTorch port, K6's plain version (kernels/winograd.py) against the Pallas
kernel `winograd_conv3x3` in interpret mode, at tests/test_winograd.py's
shapes and inputs.  The weight transform U = G w G^T is bit-equal to the
JAX package's (fp32, the same summation order, stored bf16).  Tolerances:
the convolution within 1e-3 of max |ref| of the Pallas kernel (the same
bf16 U and transforms, fp32 products summed in another order), and within
2e-2 of max |ref| of the direct convolution (U is stored bf16: ~0.5%
relative, the JAX test's budget)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointdreamer_tpu.kernels.winograd_pallas import \
    transform_weights as jax_transform
from pointdreamer_tpu.kernels.winograd_pallas import \
    winograd_conv3x3 as jax_winograd
from pointdreamer_tpu_torch.kernels import winograd as twino
from pointdreamer_tpu_torch.kernels.winograd import (
    transform_weights, winograd_conv3x3, winograd_conv3x3_plain,
    winograd_conv3x3_pretransformed)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the last: 12 x 10 tiles, no multiple of the card kernel's 8 x 8 block
SHAPES = [((2, 16, 16, 128), 128), ((1, 8, 32, 256), 128),
          ((1, 24, 20, 128), 128)]


def _inputs(shape, cout):
    x = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32) * 0.5
    w = jax.random.normal(jax.random.PRNGKey(1),
                          (3, 3, shape[-1], cout), jnp.float32) * 0.05
    return np.array(x), np.array(w)


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_transform_weights_bit_equal(shape, cout):
    _, w = _inputs(shape, cout)
    want = np.asarray(jax_transform(jnp.asarray(w)).astype(jnp.float32))
    got = transform_weights(torch.as_tensor(w))
    assert got.dtype == torch.bfloat16 and got.shape == (16, shape[-1], cout)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_winograd_matches_pallas_and_direct_conv(shape, cout):
    x, w = _inputs(shape, cout)
    want = np.asarray(jax_winograd(jnp.asarray(x), jnp.asarray(w),
                                   interpret=True).astype(jnp.float32))
    got = winograd_conv3x3(torch.as_tensor(x), torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == shape[:3] + (cout,)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-3 * scale
    direct = F.conv2d(torch.as_tensor(x).permute(0, 3, 1, 2),
                      torch.as_tensor(w).permute(3, 2, 0, 1), padding=1
                      ).permute(0, 2, 3, 1).numpy()
    assert np.abs(got.numpy() - direct).max() <= 2e-2 * np.abs(direct).max()


def test_winograd_bf16_input_rounds_like_the_pallas_kernel():
    # V = B^T d B in bf16 with the kernel's add order: the port's plain
    # version, which the card's kernel is held to, against the interpret run
    x, w = _inputs((1, 8, 16, 128), 128)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_winograd(xb, jnp.asarray(w), interpret=True)
                      .astype(jnp.float32))
    got = winograd_conv3x3_plain(
        torch.as_tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(),
        torch.as_tensor(w))
    assert got.dtype == torch.bfloat16
    # bf16 outputs: within one bf16 ulp of max |ref|
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0 ** -7 * np.abs(want).max()


def test_winograd_center_tap_identity_and_odd_sizes():
    w = torch.zeros((3, 3, 4, 8))
    w[1, 1] = 1.0
    u = transform_weights(w)
    expect = np.outer([0, 0.5, -0.5, 0], [0, 0.5, -0.5, 0]).reshape(16)
    np.testing.assert_array_equal(u[:, 0, 0].float().numpy(), expect)
    with pytest.raises(ValueError, match="even H and W"):
        winograd_conv3x3_plain(torch.zeros((1, 7, 8, 4)), w)


def test_pretransformed_on_cpu_is_the_plain_version():
    # the entry on U made in advance: on the CPU, the plain version from U,
    # bit-equal to the function that transforms w itself
    x, w = _inputs((1, 8, 8, 128), 128)
    xb = torch.as_tensor(x).bfloat16()
    u = transform_weights(torch.as_tensor(w))
    got = winograd_conv3x3_pretransformed(xb, u)
    want = winograd_conv3x3_plain(xb, torch.as_tensor(w))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match=r"u \[16,Cin,Cout\]"):
        winograd_conv3x3_pretransformed(xb, u[:, :64])


def test_card_entries_refuse_other_devices(monkeypatch):
    # the function and the pretransformed entry take the plain version
    # only on the CPU; any other device is refused before a launch
    def no_library():
        raise AssertionError("a non-CUDA tensor reached the CUDA library")

    monkeypatch.setattr(twino, "lib", no_library)
    w = torch.zeros((3, 3, 16, 32), device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        winograd_conv3x3(
            torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device="meta"), w)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        winograd_conv3x3_pretransformed(
            torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device="meta"),
            torch.zeros((16, 16, 32), dtype=torch.bfloat16, device="meta"))
