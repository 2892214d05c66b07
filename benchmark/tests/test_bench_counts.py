"""The frozen operation count and the rooflines' operations and bytes
against hand counts."""
from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH, TINY_UNET


def widths(**over):
    with open(os.path.join(BENCH, "configs", "ddnm_bf16.json")) as f:
        w = json.load(f)["unet"]
    w.update(over)
    return w


def test_tiny_unet_counts_by_hand():
    """model_channels 32, channel_mult (1, 2), one res block a level,
    attention at 16^2 (ds 2), batch 2 at 32^2: every product by hand."""
    from reference import flops

    r = flops.forward_calls(widths(**TINY_UNET), 2, 32)
    B, E = 2, 128                                  # emb channels 4 * 32
    conv = lambda m, cin, cout, k: m * cout * cin * k * k  # noqa: E731
    p32, p16 = B * 32 * 32, B * 16 * 16
    site = (
        # input: res 32->32 @32^2; down res 32 @16^2; res 32->64 @16^2
        conv(p32, 32, 32, 3) * 2
        + conv(p16, 32, 32, 3) * 2
        + conv(p16, 32, 64, 3) + conv(p16, 64, 64, 3) + conv(p16, 32, 64, 1)
        # attention at 16^2 (input), qkv + proj on 64 channels
        + conv(p16, 64, 192, 1) + conv(p16, 64, 64, 1)
        # middle: res, attn, res on 64 channels at 16^2
        + 2 * (conv(p16, 64, 64, 3) * 2)
        + conv(p16, 64, 192, 1) + conv(p16, 64, 64, 1)
        # output level 1 (16^2): res(64+64->64) + attn, res(64+32->64)
        # + attn + up res 64 (convs at 32^2)
        + conv(p16, 128, 64, 3) + conv(p16, 64, 64, 3) + conv(p16, 128, 64, 1)
        + conv(p16, 64, 192, 1) + conv(p16, 64, 64, 1)
        + conv(p16, 96, 64, 3) + conv(p16, 64, 64, 3) + conv(p16, 96, 64, 1)
        + conv(p16, 64, 192, 1) + conv(p16, 64, 64, 1)
        + conv(p32, 64, 64, 3) * 2
        # output level 0 (32^2): res(64+32->32), res(32+32->32)
        + conv(p32, 96, 32, 3) + conv(p32, 32, 32, 3) + conv(p32, 96, 32, 1)
        + conv(p32, 64, 32, 3) + conv(p32, 32, 32, 3) + conv(p32, 64, 32, 1))
    n_res = 2 + 1 + 2 + 3 + 2                     # ResBlocks
    emb = 1 * (32 * E + E * E) + sum(
        E * 2 * c for c in (32, 32, 64, 64, 64, 64, 64, 64, 32, 32))
    assert n_res == 10
    plain = conv(p32, 3, 32, 3) + conv(p32, 32, 6, 3) + emb
    attn = 4 * (4.0 * B * 1 * 256 * 256 * 64)     # four calls, one head
    assert r["site_ops"] == 2.0 * site
    assert r["float_ops"] == 2.0 * plain + attn
    assert len(r["attention"]) == 4
    assert sum(c[0] for c in r["convs"]) == 10 * 2 + 5 + 4 * 2   # 5 skips


def test_flagship_counts():
    """The published widths at the sampler's batch of 8 views at 256^2:
    17.92 T operations a forward (profile_unet's count on the card),
    17.80 T of them at the 136 int8 sites, 16 attention calls."""
    from reference import flops, unet

    r = flops.forward_calls(widths(), 8, 256)
    assert r["site_ops"] == pytest.approx(17.7973e12, rel=1e-4)
    assert r["float_ops"] == pytest.approx(0.11929e12, rel=1e-4)
    assert sum(c[0] for c in r["convs"]) == 136
    assert len(r["attention"]) == 16
    n = sum(p.numel() for p in unet.build(widths()).parameters())
    assert n == 552814086


def test_roofline_counts_by_hand():
    from roofline import attention, int8_conv

    peaks = {"bf16_ops_per_s": 1e12, "int8_ops_per_s": 2e12,
             "hbm_bytes_per_s": 1e9}
    # B 2, 3 heads, T 8, d 4: 2 products of 2*2*3*8*8*4 each
    assert attention.ops(2, 3, 8, 4) == 2 * (2 * 2 * 3 * 8 * 8 * 4)
    # qkv 2*8*36 bf16 in, 2*8*12 bf16 out
    assert attention.bytes_moved(2, 3, 8, 4) == 2 * (2 * 8 * 36 + 2 * 8 * 12)
    b = attention.bound_s([(2, 3, 8, 4)], peaks)
    assert b == max(attention.ops(2, 3, 8, 4) / 1e12,
                    attention.bytes_moved(2, 3, 8, 4) / 1e9)
    # a 3x3 conv 4 -> 5 channels over 2 x 6 x 6 pixels, stride 1
    m, n, k, e = 2 * 36, 5, 4 * 9, 2 * 36 * 4
    assert int8_conv.ops(m, n, k) == 2 * m * n * k
    assert int8_conv.bytes_moved(m, n, k, e) == e + n * k + 2 * m * n + 8 * n
    convs = [(True, m * n * k, m, n, k, 3, e), (False, 99, 1, 1, 1, 1, 1)]
    assert int8_conv.bound_s(convs, peaks) == max(
        int8_conv.ops(m, n, k) / 2e12,
        int8_conv.bytes_moved(m, n, k, e) / 1e9)
