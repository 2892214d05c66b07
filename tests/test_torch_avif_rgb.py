"""The port's YUV to RGB (`avif_rgb.py`) held to PIL 12.1 (libavif 1.3.0
with libyuv 1909) nearly exhaustively: lossless 4:4:4 AV1 streams (the
system libaom through ctypes) carry chosen Y, U, V and alpha planes, the
test's AVIF writer labels them with each matrix and range, and PIL's
pixels must equal the port's for every value the planes hold."""
from __future__ import annotations

import functools
import io

import numpy as np
import pytest
from PIL import Image

import torch_avif_tools as T
from pointdreamer_tpu_torch import avif, avif_rgb


@functools.lru_cache(None)
def _lossless_yuv():
    # every Y against a 16 x 16 grid of U and V (each row one (U, V))
    y = np.tile(np.arange(256, dtype=np.uint16), (256, 1))
    rows = np.arange(256)
    u = np.repeat((rows // 16 * 17)[:, None], 256, 1).astype(np.uint16)
    v = np.repeat((rows % 16 * 17)[:, None], 256, 1).astype(np.uint16)
    return T.aom_encode([y, u, v], 8, 0, 0, options={"lossless": "1"},
                        usage=0, speed=6), (y, u, v)


@pytest.mark.parametrize("mc,cp,full", [
    (6, 1, 1), (6, 1, 0), (1, 1, 1), (1, 1, 0), (9, 9, 1), (9, 9, 0),
    (2, 2, 1), (12, 9, 0), (4, 4, 1), (7, 7, 0), (0, 1, 1), (0, 1, 0),
    (8, 2, 1)])
def test_every_y_against_a_uv_grid_as_pil(mc, cp, full):
    obus, planes = _lossless_yuv()
    data = T.write_avif(obus, nclx=(cp, 13, mc, full))
    f = avif.parse(data)
    got_planes, _ = avif.decode_planes(avif._select(f)[0])
    for g, w in zip(got_planes, planes):
        np.testing.assert_array_equal(g, w)          # lossless
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(avif.decode_avif(data), pil)


def test_unpremultiply_every_colour_and_alpha_as_pil():
    # identity matrix, full range: R = G = B = the coded value; alpha the
    # row (coded in limited range, as libaom writes it: PIL expands it to
    # full); premultiplied, so PIL unpremultiplies every (value, alpha)
    c = np.tile(np.arange(256, dtype=np.uint16), (256, 1))
    a = np.repeat(np.arange(256, dtype=np.uint16)[:, None], 256, 1)
    color = T.aom_encode([c, c, c], 8, 0, 0, options={"lossless": "1"},
                         usage=0, speed=6)
    half = np.full((128, 128), 128, np.uint16)
    alpha = T.aom_encode([a, half, half], 8, 1, 1,
                         options={"lossless": "1"}, usage=0, speed=6)
    data = T.write_avif(color, alpha, nclx=(1, 13, 0, 1), prem=True)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert pil.shape == (256, 256, 4)
    got = avif.decode_avif(data)
    np.testing.assert_array_equal(got, pil)
    assert len(np.unique(pil[..., 3])) == 220      # 16 .. 235 expanded
    want = avif_rgb.unattenuate(np.repeat(c[..., None], 3, -1).astype(
        np.uint8), pil[..., 3])
    np.testing.assert_array_equal(pil[..., :3], want)


def test_libyuv_upsampling_edges_match_pil_at_odd_sizes():
    # 4:2:0 and 4:2:2 at odd widths and heights: the last column takes the
    # last chroma sample as it is, the first and last rows the linear rows
    rng = np.random.default_rng(3)
    for w, h, ss in ((45, 37, "4:2:0"), (33, 21, "4:2:2"), (9, 7, "4:2:0")):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "AVIF", quality=90, subsampling=ss)
        data = buf.getvalue()
        np.testing.assert_array_equal(avif.decode_avif(data),
                                      np.asarray(Image.open(io.BytesIO(
                                          data))), (w, h, ss))
