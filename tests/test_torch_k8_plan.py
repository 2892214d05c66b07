"""PyTorch port, K8's host-side launch plan (`kernels/quant.py::conv_plan`),
with no card: at every shape `chip_smoke.py` checks on the card and at
every w8a8 site of the flagship and of the tiny UNet, the M tiles' boxes
cover each output pixel exactly once and never cross an image, the boxes
keep within TMA's limits, and the split-K ranges partition K in the
kernel's (tap, chunk) order.  The wrapper's refusals raise from the plan."""
import pytest
import torch

import chip_smoke
from pointdreamer_tpu_torch.kernels import quant as kq
from pointdreamer_tpu_torch.models.diffusion import unet as tunet

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,))


def _site_shapes(model_kwargs, B, res):
    """(B, H, W, Cin, N, kh, kw, stride, pad) of every K8 call of one w8a8
    forward, recorded on the meta device (no weights, no arithmetic)."""
    calls = []

    def quantize_act(x, static=None, calib=None):
        b, c = x.shape[0], x.shape[-1]
        return (torch.empty((b, x.numel() // (b * c), c), dtype=torch.int8,
                            device=x.device),
                torch.empty(1, device=x.device))

    def int8_conv(xq, wq, ax, ks, bias, kh=3, kw=3, stride=1, pad=1,
                  out_dtype=torch.float32):
        b, h, w, cin = xq.shape
        n = wq.shape[0]
        ho, wo = (h + 2 * pad - kh) // stride + 1, \
            (w + 2 * pad - kw) // stride + 1
        calls.append((b, h, w, cin, n, kh, kw, stride, pad))
        return torch.empty((b * ho * wo, n), dtype=out_dtype,
                           device=xq.device)

    def attention_qkv(qkv, heads):
        b, t, c3 = qkv.shape
        return torch.empty((b, t, c3 // 3), dtype=qkv.dtype,
                           device=qkv.device)

    def fused_groupnorm(x, gamma, beta, ss=None, **kwargs):
        return torch.empty(x.shape, dtype=kwargs["out_dtype"],
                           device=x.device)

    saved = (tunet.quantize_act, tunet.int8_conv, tunet.attention_qkv,
             tunet.fused_groupnorm)
    (tunet.quantize_act, tunet.int8_conv, tunet.attention_qkv,
     tunet.fused_groupnorm) = (quantize_act, int8_conv, attention_qkv,
                               fused_groupnorm)
    try:
        with torch.device("meta"):
            model = tunet.UNetModel(**model_kwargs, quant=True)
            x = torch.empty((B, res, res, 3))
            t = torch.empty((B,))
        with torch.no_grad():
            model.set_compute_dtype(torch.bfloat16)(x, t)
    finally:
        (tunet.quantize_act, tunet.int8_conv, tunet.attention_qkv,
         tunet.fused_groupnorm) = saved
    assert len(calls) == model.n_sites
    return sorted(set(calls))


def _smoke_shapes():
    out = []
    for _, B, Cin, H, W, N, k, s in chip_smoke.K8_SHAPES:
        out.append((B, H, W, Cin, N, k, k, s, 1 if k == 3 else 0))
    # the attention's proj: [b, t, c] to rows
    out.append((8, 1024, 1, 512, 512, 1, 1, 1, 0))
    return out


FLAGSHIP = _site_shapes({}, 8, 256)
SHAPES = sorted(set(_smoke_shapes() + FLAGSHIP + _site_shapes(TINY, 2, 16)))


def test_the_shapes_are_the_sites():
    # 136 sites of the flagship in 40 distinct shapes, all Cin % 128 == 0
    assert len(FLAGSHIP) == 40
    assert all(s[3] % 128 == 0 for s in FLAGSHIP)
    assert (8, 8, 8, 1024, 1024, 3, 3, 1, 1) in FLAGSHIP


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_boxes_cover_every_output_pixel_once(shape):
    B, H, W, Cin, N, kh, kw, s, pad = shape
    plan = kq.conv_plan(*shape)
    Ho, Wo = (H + 2 * pad - kh) // s + 1, (W + 2 * pad - kw) // s + 1
    seen = {}
    for mt in range(plan.m_tiles):
        rows = kq.tile_pixels(plan, mt, B, Ho, Wo)
        assert len(rows) == kq.K8_BM
        for r, px in enumerate(rows):
            if px is not None:
                assert px not in seen, (px, mt, seen.get(px))
                seen[px] = mt
        if plan.rows:
            # rows mode: 128 consecutive output pixels (no spatial taps)
            ms = [(b * Ho + y) * Wo + x for b, y, x in filter(None, rows)]
            assert ms == list(range(mt * kq.K8_BM, mt * kq.K8_BM + len(ms)))
            continue
        # a box never crosses an image: each run of Wb rows is one output
        # row of one image, and a box over several images holds them whole
        wb, hb, bb = plan.box
        for r0 in range(0, kq.K8_BM, wb):
            run = [p for p in rows[r0:r0 + wb] if p is not None]
            assert len({(b, y) for b, y, _ in run}) <= 1
            assert [x for _, _, x in run] == list(
                range(run[0][2], run[0][2] + len(run))) if run else True
        if bb > 1:
            assert hb >= Ho and wb >= Wo
    assert len(seen) == B * Ho * Wo


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_keeps_to_tma_limits(shape):
    B, H, W, Cin, N, kh, kw, s, pad = shape
    plan = kq.conv_plan(*shape)
    # the K chunk is the swizzle span: 32, 64 or 128 bytes, dividing Cin
    assert plan.chunk in (32, 64, 128) and Cin % plan.chunk == 0
    assert plan.chunk == max(c for c in (32, 64, 128) if Cin % c == 0)
    wb, hb, bb = plan.box
    assert wb * hb * bb == kq.K8_BM
    boxes = [(plan.chunk, kq.K8_BN)]                      # weights [N, K]
    boxes.append((plan.chunk, kq.K8_BM) if plan.rows
                 else (plan.chunk, wb * s, hb * s, bb))
    for box in boxes:
        assert all(1 <= d <= 256 for d in box), box
        assert box[0] % 16 == 0 and box[0] <= plan.chunk
    # global strides (bytes) of the maps: multiples of 16
    for stride in (Cin, W * Cin, H * W * Cin, kh * kw * Cin):
        assert stride % 16 == 0
    assert plan.rows == (kh == 1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_k_partitions_k_in_tap_chunk_order(shape):
    B, H, W, Cin, N, kh, kw, s, pad = shape
    plan = kq.conv_plan(*shape)
    assert plan.k_steps == kh * kw * Cin // plan.chunk
    ranges = kq.split_ranges(plan)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_steps
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(q1 - q0 >= min(kq.MIN_SPLIT_STEPS, plan.k_steps)
               for q0, q1 in ranges)
    # step q covers K bytes [q * chunk, (q + 1) * chunk): tap q // (Cin /
    # chunk), channels from (q % (Cin / chunk)) * chunk
    ks = [k for q0, q1 in ranges for q in range(q0, q1)
          for k in range(q * plan.chunk, (q + 1) * plan.chunk)]
    assert ks == list(range(kh * kw * Cin))
    tiles = plan.m_tiles * plan.n_tiles
    assert plan.grid == min(tiles * plan.splits, kq.SMS)
    if plan.splits > 1:
        assert tiles * plan.splits <= kq.SMS


def test_small_layers_split_k_to_fill_the_card():
    # the flagship's 16^2 and 8^2 layers: about one work unit an SM
    p16 = kq.conv_plan(8, 16, 16, 1024, 1024)
    p8 = kq.conv_plan(8, 8, 8, 1024, 1024)
    assert (p16.box, p16.splits, p16.units) == ((16, 8, 1), 2, 128)
    assert (p8.box, p8.splits, p8.units) == ((8, 8, 2), 8, 128)
    big = kq.conv_plan(8, 256, 256, 256, 256)
    assert (big.box, big.splits, big.m_tiles) == ((128, 1, 1), 1, 4096)


@pytest.mark.parametrize("bad", [
    dict(Cin=48), dict(kh=5, kw=5, pad=2), dict(stride=3),
    dict(kh=1, kw=1, pad=0, stride=2), dict(pad=0)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    args = dict(B=1, H=8, W=8, Cin=64, N=64, kh=3, kw=3, stride=1, pad=1)
    args.update(bad)
    with pytest.raises(ValueError):
        kq.conv_plan(**args)
    with pytest.raises(TypeError):
        kq.check_conv_shape(64, 3, 3, 1, 1, torch.float16)


def test_mma_counts_by_opcode_tell_igmma_from_imma():
    # chip_smoke's phase 1 counts K8's IGMMA alone: a K8 on mma.sync's
    # IMMA counts 0 there
    from pointdreamer_tpu_torch import kernels

    sass = """
        Function : _ZN12_GLOBAL__N_116int8_conv_kernelILb1ELb1EEEvNS_10ConvParamsE
        /*0100*/                   IMMA.16832.S8.S8 R12, R8.ROW, R4.COL, R12 ;
        Function : _ZN12_GLOBAL__N_116int8_conv_kernelILb1ELb0EEEvNS_10ConvParamsE
        /*0100*/                   IGMMA.64x256x32.S8.S8 R24, gdesc[UR4], R24 ;
        /*0110*/                   IGMMA.64x256x32.S8.S8 R24, gdesc[UR8], R24 ;
"""
    assert list(kernels.mma_counts(sass).values()) == [1, 2]
    assert list(kernels.mma_counts(sass, ("IGMMA",)).values()) == [0, 2]
