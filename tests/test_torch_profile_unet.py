"""PyTorch port, `profile_unet.count_flops`: a tiny UNet's forward counted
at the calls it issues (every F.conv2d and F.linear, every K8 int8
convolution or dense layer, every K2 attention) equals the operations of
those calls worked out here from their arguments' shapes, for the
floating-point UNet and its w8a8 twin.  On the CPU in fp32."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointdreamer_tpu_torch import profile_unet
from pointdreamer_tpu_torch.kernels import quant as tq
from pointdreamer_tpu_torch.models.diffusion import attention as tattn
from pointdreamer_tpu_torch.models.diffusion import unet as tunet

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _reference_ops(model, x, t, monkeypatch):
    """{'int8', 'float'}: 2 operations per multiply-add of each call,
    from the shapes of its arguments (recorded by wrapping the functions
    the UNet looks up at call time)."""
    ops = {"int8": 0.0, "float": 0.0}
    conv2d, linear = F.conv2d, F.linear
    conv8, attn = tunet.int8_conv, tunet.attention_qkv

    def rec_conv2d(inp, w, b=None, stride=1, padding=0, *a):
        (sy, sx), (py, px) = _pair(stride), _pair(padding)
        n, cin, h, wd = inp.shape
        cout, cin_g, kh, kw = w.shape
        ho, wo = (h + 2 * py - kh) // sy + 1, (wd + 2 * px - kw) // sx + 1
        ops["float"] += 2.0 * n * cout * ho * wo * cin_g * kh * kw
        return conv2d(inp, w, b, stride, padding, *a)

    def rec_linear(inp, w, b=None):
        ops["float"] += 2.0 * (inp.numel() // w.shape[1]) * w.shape[0] \
            * w.shape[1]
        return linear(inp, w, b)

    def rec_int8(xq, wq, ax, ks, bias, kh=3, kw=3, stride=1, pad=1,
                 *a, **k):
        b, h, w, cin = xq.shape
        ho, wo = (h + 2 * pad - kh) // stride + 1, \
            (w + 2 * pad - kw) // stride + 1
        ops["int8"] += 2.0 * b * ho * wo * wq.shape[0] * kh * kw * cin
        return conv8(xq, wq, ax, ks, bias, kh, kw, stride, pad, *a, **k)

    def rec_attn(qkv, heads):
        b, t_, c3 = qkv.shape
        hd = c3 // (3 * heads)
        ops["float"] += 2 * 2.0 * b * heads * t_ * t_ * hd
        return attn(qkv, heads)

    with monkeypatch.context() as m:
        m.setattr(F, "conv2d", rec_conv2d)
        m.setattr(F, "linear", rec_linear)
        m.setattr(tunet, "int8_conv", rec_int8)
        m.setattr(tunet, "attention_qkv", rec_attn)
        with torch.no_grad():
            model(x, t)
    return ops


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "w8a8"])
def test_count_flops_counts_every_product(quant, monkeypatch):
    torch.manual_seed(0)
    model = tunet.UNetModel(**TINY)
    tunet.init_random_(model, seed=3)
    if quant:
        tunet.quantize_unet_(model)
    model.eval()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([10.0, 500.0])
    with torch.no_grad():
        got = profile_unet.count_flops(model, x, t)
    want = _reference_ops(model, x, t, monkeypatch)
    assert set(got) == {"int8", "float"}
    assert got == pytest.approx(want, rel=1e-12)
    # the convolutions dominate: far more than the attention alone (what
    # module hooks that never fire would leave)
    assert got["float"] + got["int8"] > 2.5e8
    assert (got["int8"] > 0) == quant
    # count_flops leaves the UNet's functions as it found them
    assert tunet.int8_conv is tq.int8_conv
    assert tunet.attention_qkv is tattn.attention_qkv
