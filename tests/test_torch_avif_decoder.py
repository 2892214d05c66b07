"""The port's AV1 decoder (`av1_*.py`) on its own: the committed fixtures
together run every coding tool the slice names (a coverage count kept by
the decoder), the generated tables hold the specification's values, and
the symbol decoder, transforms and YUV conversion hold their definitions.
See test_torch_avif.py for the fixtures and the oracles."""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest

from pointdreamer_tpu_torch import av1_cdf, av1_data, av1_tables
from pointdreamer_tpu_torch import av1_transform as X
from pointdreamer_tpu_torch import avif
from pointdreamer_tpu_torch.av1_block import Stats
from pointdreamer_tpu_torch.av1_symbol import SymbolDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVIF_DIR = os.path.join(REPO, "tests", "data", "avif")

REQUIRED = (
    ["partition_%d" % i for i in range(10)] +
    ["y_mode_%d" % i for i in range(13)] +
    ["angle_delta_neg", "angle_delta_pos"] +
    ["filter_intra_%d" % i for i in range(5)] +
    ["cfl", "palette_y", "palette_uv", "intrabc"] +
    ["tx_size_%d" % i for i in range(19)] +
    # every type of the intra sets (set 1 holds set 2's)
    ["tx_type_%d" % t for t in av1_tables.Tx_Type_Intra_Inv_Set1] +
    ["lossless", "qm", "segmentation", "delta_q", "delta_lf", "deblock",
     "cdef", "lr_wiener", "lr_sgrproj", "superres", "film_grain",
     "bitdepth_8", "bitdepth_10", "bitdepth_12", "mono", "subsampling_11",
     "subsampling_10", "subsampling_00", "tiles", "grid", "sb128"])


@functools.lru_cache(None)
def _coverage():
    st = Stats()
    for n in sorted(os.listdir(AVIF_DIR)):
        if n.endswith(".avif") and n != "restore_256.avif":
            with open(os.path.join(AVIF_DIR, n), "rb") as f:
                avif.decode_avif(f.read(), st)
    return st


@pytest.mark.parametrize("tool", REQUIRED)
def test_fixtures_run_every_tool(tool):
    assert _coverage().get(tool, 0) > 0, tool


def test_generated_tables_hold_the_specification_values():
    # leading values the specification lists, and CDF shapes
    assert av1_cdf.Default_Intra_Frame_Y_Mode_Cdf.shape == (5, 5, 14)
    assert list(av1_cdf.Default_Intra_Frame_Y_Mode_Cdf[0, 0, :3]) == [
        15588, 17027, 19338]
    assert av1_cdf.Default_Coeff_Base_Cdf.shape == (4, 5, 2, 42, 5)
    assert list(av1_cdf.Default_Coeff_Br_Cdf[0, 0, 0, 0, :3]) == [
        14298, 20718, 24174]
    assert av1_cdf.Default_Eob_Pt_1024_Cdf.shape == (4, 2, 12)
    for name in dir(av1_cdf):
        t = getattr(av1_cdf, name)
        if name.startswith("Default_") and isinstance(t, np.ndarray):
            vals, top, cnt = t[..., :-2], t[..., -2], t[..., -1]
            assert (top == 32768).all() and (cnt == 0).all(), name
            assert (np.diff(vals, axis=-1) >= 0).all(), name
    assert list(av1_data.Dc_Qlookup_8[:5]) == [4, 8, 8, 9, 10]
    assert av1_data.Ac_Qlookup_12[-1] == 29247
    assert list(av1_data.Gaussian_Sequence[:4]) == [56, 568, -180, 172]
    assert av1_data.Quantizer_Matrix.shape == (15, 2, 3344)
    assert list(av1_data.Sgr_Params[0]) == [2, 140, 1, 3236]
    assert (av1_data.Upscale_Filter.sum(axis=1) == 128).all()


def test_cos128_and_scans_follow_their_formulas():
    assert av1_tables.Cos128_Lookup[32] == 2896
    assert av1_tables.Cos128_Lookup[0] == 4096
    assert list(av1_tables.default_scan(4, 4)) == [
        0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
    assert list(av1_tables.default_scan(8, 4)[:6]) == [0, 8, 1, 16, 9, 2]
    for w, h in av1_tables.TX_WH:
        w, h = min(w, 32), min(h, 32)
        assert sorted(av1_tables.default_scan(w, h)) == list(range(w * h))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_idct_is_the_dct_to_rounding(n):
    size = 1 << n
    rng = np.random.default_rng(n)
    x = rng.integers(-600, 600, (16, size))
    k = np.arange(size)
    basis = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * size))
    basis[0] *= 1 / np.sqrt(2)
    want = x @ basis * np.sqrt(2.0 / size) * np.sqrt(size / 2.0)
    got = X.idct(x.astype(np.int64), n)
    assert np.abs(got - want).max() < 2 + size / 8


def test_symbol_decoder_adapts_as_the_specification():
    # a CDF adapts toward the decoded symbol, counting to 32
    data = bytes(np.random.default_rng(0).integers(0, 256, 64,
                                                   dtype=np.uint8))
    sd = SymbolDecoder(data, 0, len(data), False)
    cdf = [8192, 16384, 24576, 32768, 0]
    seen = [sd.read_symbol(cdf) for _ in range(40)]
    assert set(seen) <= {0, 1, 2, 3} and cdf[-1] == 32
    assert cdf[0] <= cdf[1] <= cdf[2] < 32768
    frozen = SymbolDecoder(data, 0, len(data), True)
    c2 = [8192, 16384, 24576, 32768, 0]
    for _ in range(10):
        frozen.read_symbol(c2)
    assert c2 == [8192, 16384, 24576, 32768, 0]
