"""PyTorch port, the image operations and camera helper the JAX package
has beside the main path: erode, morph_close, bilateral_filter
(ops/image.py) and ndc_to_pixels (camera.py), each against its JAX twin
on seeded numpy input.  Morphology and pixel indices exact; the bilateral
filter within 1e-6 absolute in fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.core import camera as jcam
from pointdreamer_tpu.ops import image as jimg
from pointdreamer_tpu_torch import camera as tcam
from pointdreamer_tpu_torch.ops import image as timg


def _mask(seed, shape):
    rng = np.random.default_rng(seed)
    m = (rng.random(shape) < 0.6).astype(np.float32)
    m[..., 5:9, 5:9] = 0.0                 # a hole for the closing
    return m


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("shape", [(24, 31), (2, 3, 17, 20)])
def test_erode_and_close_equal_jax(k, shape):
    m = _mask(k + len(shape), shape)
    grey = np.random.default_rng(k).random(shape).astype(np.float32)
    for x in (m, grey, m > 0.5):
        for jf, tf in ((jimg.erode, timg.erode),
                       (jimg.morph_close, timg.morph_close),
                       (jimg.dilate, timg.dilate)):
            want = np.asarray(jf(jnp.asarray(x), k))
            got = tf(torch.as_tensor(x), k)
            assert got.dtype == torch.float32 and got.shape == x.shape
            np.testing.assert_array_equal(got.numpy(), want)


def test_morph_close_fills_a_small_hole():
    m = np.zeros((40, 40), np.float32)
    m[8:32, 8:32] = 1.0
    m[18:21, 18:21] = 0.0
    out = timg.morph_close(torch.as_tensor(m), 7).numpy()
    assert out[19, 19] == 1.0 and out[4, 4] == 0.0
    assert out[8:32, 8:32].min() == 1.0


@pytest.mark.parametrize("ksize,sc,ss", [(3, None, None), (7, None, None),
                                         (5, 0.1, 2.0), (9, 0.3, None)])
@pytest.mark.parametrize("shape", [(20, 26, 3), (2, 12, 15, 4)])
def test_bilateral_filter_equals_jax(ksize, sc, ss, shape):
    rng = np.random.default_rng(ksize)
    img = rng.random(shape).astype(np.float32)
    img[..., :, shape[-2] // 2:, :] += 0.5          # an edge
    img = np.clip(img, 0, 1)
    want = np.asarray(jimg.bilateral_filter(jnp.asarray(img), ksize, sc, ss))
    got = timg.bilateral_filter(torch.as_tensor(img), ksize, sc, ss)
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("res", [1, 7, 256, 512])
def test_ndc_to_pixels_equals_jax(res):
    rng = np.random.default_rng(res)
    ndc = rng.uniform(-1.3, 1.3, (5, 400, 2)).astype(np.float32)
    ndc[0, :4] = [[-1, -1], [1, 1], [0, 0], [1, -1]]
    want = np.asarray(jcam.ndc_to_pixels(jnp.asarray(ndc), res))
    got = tcam.ndc_to_pixels(torch.as_tensor(ndc), res)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
