"""`roofline.groupnorm` (K5) on hand-made traces: None without a K5
event, as at a program that does not launch it; its sites from the
published widths against a count by hand; the share from the bound and
the kernel's device time."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import BENCH, ROOT
from pdbench import main, spec
from pdbench import trace as ptrace

K5_NAME = ("void (anonymous namespace)::gn_fused<__nv_bfloat16, "
           "__nv_bfloat16, true, true>(__nv_bfloat16 const*, float const*)")


def hand_sites(B=8):
    """(B, S, C, output bytes, scale-shift) of the ADM 256^2 UNet's norms:
    model_channels 256, channel_mult (1, 1, 2, 2, 4, 4), two res blocks a
    level, res-block up and down sampling, attention at 32^2, 16^2, 8^2."""
    chans = [256, 256, 512, 512, 1024, 1024]
    sides = [256, 128, 64, 32, 16, 8]
    out = []

    def res(cin, cout, side, side_out=None):
        out.append((B, side * side, cin, 2, False))
        s = side_out or side
        out.append((B, s * s, cout, 2, True))

    def attn(c, side):
        out.append((B, side * side, c, 2, False))

    skips, ch = [256], 256
    for lv, (c, side) in enumerate(zip(chans, sides)):
        for _ in range(2):
            res(ch, c, side)
            ch = c
            if side <= 32:
                attn(c, side)
            skips.append(c)
        if lv < 5:
            res(c, c, side, side // 2)
            skips.append(c)
    res(1024, 1024, 8)
    attn(1024, 8)
    res(1024, 1024, 8)
    for lv in range(5, -1, -1):
        c, side = chans[lv], sides[lv]
        for i in range(3):
            res(ch + skips.pop(), c, side)
            ch = c
            if side <= 32:
                attn(c, side)
            if lv and i == 2:
                res(c, c, side, side * 2)
    out.append((B, 256 * 256, 256, 4, False))          # the head's norm
    return out


def test_sites_from_the_published_widths():
    """101 norms: 84 in the 42 res blocks, 16 attention norms, the head's;
    3.20 G elements, 13.08 GB a forward at batch 8: x read once in bf16,
    the output written once (fp32 at the head), gamma, beta and the
    scale-shift in fp32."""
    from roofline import groupnorm

    with open(os.path.join(BENCH, "configs", "ddnm_bf16.json")) as f:
        widths = json.load(f)["unet"]
    got = groupnorm.sites(widths, 8, 256)
    want = hand_sites()
    assert got == want
    assert len(got) == 101 and sum(n[4] for n in got) == 42
    assert sum(b * s * c for b, s, c, _, _ in got) == pytest.approx(
        3.20e9, rel=1e-2)
    total = sum(groupnorm.bytes_moved(*n) for n in got)
    by_hand = sum(b * s * c * (2 + o) + 8 * c + (8 * b * c if ss else 0)
                  for b, s, c, o, ss in want)
    assert total == by_hand
    assert total == pytest.approx(13.078e9, rel=1e-4)


def _run(names, dev):
    cell = spec.load_cell("ddnm_bf16.c1", ROOT)
    tr = ptrace.Trace(names, np.array(dev, np.int64).reshape(-1, 3),
                      np.full((len(dev), 2), -1, np.int64), 2, 0, 10 ** 9)
    return main.Run(cell, 1.0, None, {}, main.load_peaks(ROOT), tr, None)


def test_reads_none_without_k5():
    read = spec.reader("roofline.groupnorm", ROOT)
    assert read(_run(["RowwiseMomentsCUDAKernel", "GroupNorm"],
                     [[0, 100, 0], [100, 200, 1]])) is None
    run = _run([], [])
    run.trace = None
    assert read(run) is None


def test_share_of_the_bound():
    """Two forwards' 202 launches taking twice the bound read 50%."""
    from roofline import groupnorm

    read = spec.reader("roofline.groupnorm", ROOT)
    peaks = main.load_peaks(ROOT)
    bound_ns = groupnorm.bound_s(hand_sites(), peaks) * 1e9
    each = int(round(2 * bound_ns / 101))
    dev = [[i * each, (i + 1) * each, 0] for i in range(202)]
    got = read(_run([K5_NAME, "gemm"], dev + [[0, 10, 1]]))
    assert got == pytest.approx(100.0 * bound_ns / (101 * each), rel=1e-9)
    assert got == pytest.approx(50.0, rel=1e-4)
