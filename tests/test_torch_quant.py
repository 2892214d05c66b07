"""PyTorch port, w8a8 DDNM: K7 (quantize_act) and K8 (int8_conv) plain
versions against the JAX package's QConv8 / QDense8 arithmetic, the
weight transform `quantize_unet_` against `quantize_unet_params`, the
QConv8 / QDense8 layers and the tiny w8a8 UNet against flax's, the
activation-scale calibration, the sampler's dynamic / collect / static
modes and `DDNMInpainter(static_calib=True)`.  All on the CPU in fp32,
TF32 off.  Integer results (int8 activations and weights, int32 sums) are
compared bit for bit; the dequantized fp32 ones within the tolerance each
test states."""
import threading

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from pointdreamer_tpu.models.diffusion import ddnm as jddnm
from pointdreamer_tpu.models.diffusion import unet as junet
from pointdreamer_tpu_torch import kernels
from pointdreamer_tpu_torch.kernels import quant as tq
from pointdreamer_tpu_torch.models.diffusion import ddnm as tddnm
from pointdreamer_tpu_torch.models.diffusion import unet as tunet
from pointdreamer_tpu_torch.models.diffusion.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,))

@pytest.fixture(autouse=True)
def one_torch_thread():
    # the test workers share the host: torch's default of one thread per
    # core would oversubscribe it many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _perturbed_params(seed=7):
    """flax's init of the tiny UNet plus the JAX w8a8 gates' deterministic
    +-0.02 wave on every matrix (the zero-initialized out layers would
    make eps 0), as numpy leaves."""
    jm = junet.UNetModel(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                     jnp.zeros((1,)))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.sign(
            jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape)
            + 0.1) if p.ndim >= 2 else p, params)
    return jax.tree_util.tree_map(np.asarray, params)


def _quant_pair(seed=7):
    """(flax w8a8 model, its quantized params, the port's twin)."""
    qp = jax.tree_util.tree_map(
        np.asarray, junet.quantize_unet_params(_perturbed_params(seed)))
    tm = tunet.UNetModel(quant=True, **TINY)
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        params_from_jax(qp, **TINY).items()})
    return junet.UNetModel(dtype=jnp.float32, quant=True, **TINY), qp, \
        tm.eval()


def _site_leaves(tree, leaf):
    """{(block, module): tree[block][module][leaf]} of a JAX tree."""
    return {(b, m): v[leaf] for b, mods in tree.items()
            if isinstance(mods, dict) for m, v in mods.items()
            if isinstance(v, dict) and leaf in v}


# ---- the weight transform -------------------------------------------------

def test_quantize_unet_matches_quantize_unet_params():
    params = _perturbed_params()
    tm = tunet.UNetModel(**TINY)
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        params_from_jax(params, **TINY).items()})
    tunet.quantize_unet_(tm)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, junet.quantize_unet_params(params)), **TINY)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    n_jax = len(_site_leaves(junet.quantize_unet_params(params), "kernel_q"))
    assert tm.n_sites == n_jax == 33
    assert [jp for *_, jp in tunet.quant_sites(tm)] == sorted(
        _site_leaves(junet.quantize_unet_params(params), "kernel_q"),
        key=[jp for *_, jp in tunet.quant_sites(tm)].index)
    with pytest.raises(ValueError, match="quantized already"):
        tunet.quantize_unet_(tm)


def test_flagship_quant_layout_matches_jax_eval_shape():
    # the 552.8M UNet's w8a8 twin on the meta device against flax's
    # eval_shape of imagenet256_unet(quant=True): 136 sites, 498,204,672
    # int8 weights, every leaf's shape and dtype through params_from_jax
    shapes = jax.eval_shape(lambda: junet.imagenet256_unet(quant=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1,))))["params"]
    kq = _site_leaves(shapes, "kernel_q")
    with torch.device("meta"):
        tm = tunet.imagenet256_unet(quant=True)
    assert tm.n_sites == len(kq) == 136
    assert {jp for *_, jp in tunet.quant_sites(tm)} == set(kq)
    n_int8 = sum(p.numel() for p in tm.parameters()
                 if p.dtype == torch.int8)
    assert n_int8 == sum(int(np.prod(s.shape)) for s in kq.values()) \
        == 498_204_672
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    want = {k: (v.shape, v.dtype) for k, v in params_from_jax(zeros).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tm.state_dict().items()}
    assert got == {k: (s, str(d)) for k, (s, d) in want.items()}


# ---- K7 ---------------------------------------------------------------------

@jax.jit
def _jax_quantize(x):
    # QConv8's lines (unet.py:92-94), dynamic scale
    xf = x.astype(jnp.float32)
    ax = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0
    return jnp.clip(jnp.round(xf / ax), -127, 127).astype(jnp.int8), \
        jnp.max(jnp.abs(xf)), ax


def _ties(shape, seed):
    """NHWC fp32 with max |x| = 127 (ax = 1 exactly) and a third of the
    entries on exact .5 ties, the rest random."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-120, 120, shape).astype(np.float32)
    tie = rng.random(shape) < 0.33
    x[tie] = rng.integers(-126, 126, int(tie.sum())) + 0.5
    x.reshape(-1)[0] = -127.0
    return x


@pytest.mark.parametrize("case", ["ties", "random", "bf16", "channels_last"])
def test_quantize_act_plain_matches_jax(case):
    rng = np.random.default_rng(3)
    x = (_ties((2, 6, 5, 32), 1) if case == "ties"
         else rng.standard_normal((2, 6, 5, 64)).astype(np.float32) * 3.7)
    if case == "bf16":
        xt = torch.tensor(x).to(torch.bfloat16)
        x = xt.float().numpy()
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.tensor(x), jnp.asarray(x)
    qj, amax_j, ax_j = (np.asarray(a) for a in _jax_quantize(xj))
    calib = torch.zeros(3)
    # the torso's NHWC view of its channels-last activations; the
    # attention's [b, t, c] rows
    q, ax = tq.quantize_act(
        xt.reshape(2, 30, -1) if case == "channels_last"
        else xt.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1),
        calib_out=calib[1:2])
    np.testing.assert_array_equal(q.numpy(), qj.reshape(2, 30, -1))
    assert ax.numpy().tobytes() == ax_j.reshape(1).tobytes()
    assert calib[1].numpy().tobytes() == amax_j.tobytes()
    assert calib[0] == 0 and calib[2] == 0
    if case == "ties":
        # round half to even: 2.5 -> 2, 3.5 -> 4, -0.5 -> 0
        t = torch.tensor([[[2.5, 3.5, -0.5, -1.5, 127.0]]])
        np.testing.assert_array_equal(
            tq.quantize_act(t)[0].numpy().ravel(),
            [2, 4, 0, -2, 127])


def test_quantize_act_static_scale_saturates_like_jax():
    # a static amax below max |x|: the JAX layer's `act_scales` path, the
    # out-of-range values clip at +-127
    x = _ties((1, 4, 4, 32), 2) * 1.7
    table = torch.tensor([[9.0, 64.0]])
    q, ax = tq.quantize_act(torch.tensor(x), static_amax=table[0, 1:2])
    ax_j = jnp.maximum(jnp.float32(64.0), 1e-12) / 127.0
    qj = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / ax_j), -127, 127)
                    .astype(jnp.int8))
    np.testing.assert_array_equal(q.numpy(), qj.reshape(1, 16, 32))
    assert ax.numpy().tobytes() == np.asarray(ax_j).reshape(1).tobytes()
    assert (np.abs(qj) == 127).mean() > 0.2


# ---- K8 ---------------------------------------------------------------------

@pytest.mark.parametrize("kh,stride,pad,hw", [(3, 1, 1, (6, 7)),
                                              (3, 2, 1, (8, 6)),
                                              (3, 2, 1, (7, 5)),
                                              (1, 1, 0, (5, 4))],
                         ids=["3x3s1", "3x3s2", "3x3s2_odd", "1x1"])
def test_int8_conv_plain_matches_jax_conv(kh, stride, pad, hw):
    rng = np.random.default_rng(kh * 10 + stride)
    B, Cin, N = 2, 64, 48
    xq = rng.integers(-127, 128, (B, *hw, Cin)).astype(np.int8)
    kq = rng.integers(-127, 128, (kh, kh, Cin, N)).astype(np.int8)
    ks = (rng.random(N) * 1e-2 + 1e-3).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    ax = np.float32(0.0371)
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    wq = torch.tensor(kq).permute(3, 0, 1, 2).contiguous()
    acc = tq.int8_conv_acc_plain(torch.tensor(xq), wq, kh, kh, stride, pad)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)      # int32, exact
    y_j = np.asarray(acc_j.astype(np.float32) * (ax * ks) + b)
    y = tq.int8_conv(torch.tensor(xq), wq, torch.tensor([ax]),
                     torch.tensor(ks), torch.tensor(b), kh, kh, stride, pad)
    # rows [B*Ho*Wo, N], NHWC; the same fp32 epilogue; XLA may contract it
    # into an FMA (one rounding less): 1e-6 of max |y|
    assert y.shape == (y_j.size // N, N)
    np.testing.assert_allclose(y.numpy().reshape(y_j.shape), y_j, rtol=0,
                               atol=1e-6 * np.abs(y_j).max())


def test_int8_dense_plain_matches_jax_dot_general():
    rng = np.random.default_rng(5)
    xq = rng.integers(-127, 128, (3, 20, 96)).astype(np.int8)
    kq = rng.integers(-127, 128, (96, 288)).astype(np.int8)
    acc_j = np.asarray(jax.lax.dot_general(
        jnp.asarray(xq), jnp.asarray(kq), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    acc = tq.int8_conv_acc_plain(torch.tensor(xq).reshape(3, 20, 1, 96),
                                 torch.tensor(kq.T.copy()), 1, 1, 1, 0)
    np.testing.assert_array_equal(acc.numpy().reshape(3, 20, 288), acc_j)


# ---- the layers and the UNet ---------------------------------------------

@pytest.mark.parametrize("kind", ["conv3x3", "conv3x3s2", "skip1x1",
                                  "dense"])
def test_qconv8_qdense8_match_flax(kind):
    rng = np.random.default_rng(11)
    cin, cout = 64, 96
    kh = 1 if kind in ("skip1x1", "dense") else 3
    stride = 2 if kind == "conv3x3s2" else 1
    pad = 1 if kh == 3 else 0
    kern = rng.standard_normal((kh, kh, cin, cout)).astype(np.float32) * 0.1
    bias = rng.standard_normal(cout).astype(np.float32) * 0.1
    q = junet.quantize_unet_params({"l": {"kernel": kern, "bias": bias}})[
        "l"]
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    if kind == "dense":
        q = dict(q, kernel_q=q["kernel_q"][0, 0])
        fl = junet.QDense8(cout, dtype=jnp.float32)
        xj = x.reshape(2, 64, cin)
        mod = tunet.QDense8(cin, cout)
    else:
        fl = junet.QConv8(cout, (kh, kh), (stride, stride), pad,
                          dtype=jnp.float32)
        xj = x
        mod = tunet.QConv8(cin, cout, kh, stride, pad)
    want = np.asarray(fl.apply({"params": q}, jnp.asarray(xj)))
    mod.kernel_q.data = torch.tensor(np.asarray(q["kernel_q"]).reshape(
        kh, kh, cin, cout)).permute(3, 0, 1, 2).contiguous()
    mod.kernel_s.data = torch.tensor(np.asarray(q["kernel_s"]))
    mod.bias.data = torch.tensor(np.asarray(q["bias"]))
    mod.site = 0
    with torch.no_grad():
        if kind == "dense":
            # the attention's layout: [b,t,c] in, rows [b*t,c] out
            got = mod(torch.tensor(xj), torch.float32)
            assert got.shape == (2 * 64, cout)
            got = got.reshape(2, 64, cout).numpy()
        else:
            # the torso's layout: K7 reads the NHWC view, K8 writes rows,
            # the output is channels last
            y = mod(torch.tensor(x).permute(0, 3, 1, 2), torch.float32)
            assert y.is_contiguous(memory_format=torch.channels_last)
            got = y.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    # measured: equal but for XLA's FMA contraction of the epilogue
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _record_inputs(jq, qp, tm, x, t):
    """Each site's input in both packages (flax interceptor, torch
    pre-hooks) and the two outputs."""
    jin, tin = {}, {}

    def icpt(f, args, kwargs, ctx):
        if isinstance(ctx.module, (junet.QConv8, junet.QDense8)) \
                and ctx.method_name == "__call__":
            jin[ctx.module.path] = np.asarray(args[0])
        return f(*args, **kwargs)

    with nn.intercept_methods(icpt):
        want = np.asarray(jq.apply({"params": qp}, jnp.asarray(x),
                                   jnp.asarray(t)))
    hooks = [tunet._site_module(b, a, i).register_forward_pre_hook(
        lambda m, args, jp=jp: tin.__setitem__(jp, args[0].clone()))
        for b, a, i, _, jp in tunet.quant_sites(tm)]
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(t)).numpy()
    for h in hooks:
        h.remove()
    return want, got, jin, tin


def _first_flip(jq, qp, tm, x, t):
    """Walk the sites in order, each package's own site input through its
    own quantize formula, up to the first site whose int8 input differs
    anywhere (a .5-boundary flip from upstream fp32 rounding).  Returns
    (its index or None, its flipped entries, its entries, the largest
    input difference before it relative to max |x|, both outputs)."""
    want, got, jin, tin = _record_inputs(jq, qp, tm, x, t)
    order = [jp for *_, jp in tunet.quant_sites(tm)]
    assert set(jin) == set(tin) == set(order)
    worst = 0.0
    for n, jp in enumerate(order):
        xt, xj = tin[jp], jin[jp]
        qj = np.asarray(_jax_quantize(jnp.asarray(xj))[0])
        # the attention's projections read [b,t,c]; the convs the NHWC
        # view of their channels-last NCHW input, as QConv8 passes them
        xt = xt.permute(0, 2, 3, 1) if xt.dim() == 4 else xt
        qt = tq.quantize_act(xt)[0].numpy()
        qj = qj.reshape(qt.shape)
        flips = int((qt != qj).sum())
        if flips:
            assert np.abs(qt.astype(int) - qj).max() == 1, jp
            return n, flips, qt.size, worst, want, got
        xt = xt.numpy()
        xj = xj.reshape(xt.shape)
        worst = max(worst, float(np.abs(xt - xj).max() / np.abs(xj).max()))
    return None, 0, 0, worst, want, got


@pytest.mark.parametrize("draw", ["normal", "uniform"])
def test_tiny_quant_unet_matches_jax(draw):
    """The tiny w8a8 UNet, dynamic scales, fp32, against flax's on the same
    int8 weights.  The fp32 work between the sites (GroupNorm, the fp
    convs, the attention) rounds in another order (<= 1e-5 of max |x| at
    every site), so a site's input can quantize to the other side of a .5
    boundary.  Up to the first such flip every site's int8 input equals
    JAX's; there at most 1e-3 of the entries flip, by one (measured: the
    'normal' draw none, the 'uniform' one 1 of 8,192 at input_3_0's
    out_conv).  Without a flip eps agrees within 1e-5 of max |eps|
    (measured 4.5e-7).  A flip moves that output by one quantum, and the
    perturbed tiny network amplifies it (in the 'uniform' draw 1 entry
    becomes 20% of the last site's): eps then within 0.1 of max |eps|
    (measured 0.037)."""
    jq, qp, tm = _quant_pair()
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
         if draw == "normal" else np.asarray(jax.random.uniform(
             jax.random.PRNGKey(1), (2, 16, 16, 3)) * 2 - 1))
    t = np.array([10.0, 700.0], np.float32)
    site, flips, entries, worst, want, got = _first_flip(jq, qp, tm, x, t)
    assert worst <= 1e-5
    assert np.abs(want).max() > 0.1
    if site is None:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert flips <= 1e-3 * entries, (site, flips, entries)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=0.1 * np.abs(want).max())


@pytest.mark.parametrize("draw", ["normal", "uniform"])
def test_calibrate_act_scales_matches_jax(draw):
    """margin 1.0 on one input: the static scale is the dynamic amax, so
    the static forward equals the dynamic one bit for bit (the JAX
    package's wiring test).  The port's scales (margin 1.3, applied in
    fp32) against the JAX ones: within 1e-5 relative at every site up to
    the first int8 flip (see above) against the JAX package's eager
    calibration, the path `_first_flip` walks; against its jitted one
    (XLA's fusions round in another order, and can flip a site of their
    own: in the 'uniform' draw output_2_0's in_conv) within 0.1 (measured
    0.015 in the 'uniform' draw)."""
    jq, qp, tm = _quant_pair()
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
         if draw == "normal" else np.asarray(jax.random.uniform(
             jax.random.PRNGKey(1), (2, 16, 16, 3)) * 2 - 1))
    t = np.array([10.0, 700.0], np.float32)
    with torch.no_grad():
        dyn = tm(torch.tensor(x), torch.tensor(t))
        scales = tunet.calibrate_act_scales(tm, [torch.tensor(x)],
                                            [torch.tensor(t)], margin=1.0)
        stat = tm(torch.tensor(x), torch.tensor(t),
                  tunet.ActScales("static", scales))
    torch.testing.assert_close(stat, dyn, rtol=0, atol=0)
    js = junet.calibrate_act_scales(jq, qp, [x], [t], margin=1.3)
    with jax.disable_jit():
        je = junet.calibrate_act_scales(jq, qp, [x], [t], margin=1.3)
    want, want_eager = (np.array(
        [float(v["amax"]) for v in
         (tree[b][m] for *_, (b, m) in tunet.quant_sites(tm))], np.float32)
        for tree in (js, je))
    got13 = tunet.calibrate_act_scales(tm, [torch.tensor(x)],
                                       [torch.tensor(t)])[:, 0].numpy()
    np.testing.assert_array_equal(got13, (scales[:, 0] * 1.3).numpy())
    site = _first_flip(jq, qp, tm, x, t)[0]
    cut = len(want) if site is None else site + 1
    np.testing.assert_allclose(got13[:cut], want_eager[:cut], rtol=1e-5)
    np.testing.assert_allclose(got13, want, rtol=0.1)


@pytest.mark.parametrize("mode", ["dynamic", "collect", "static"])
def test_k5_route_w8a8_matches_the_chain_and_jax(mode, monkeypatch):
    """The tiny w8a8 UNet with every norm fused (K5's plain version)
    against the same model with every norm the unfused chain and against
    flax's, in each scale mode: the fused norm rounds in another order, so
    a site's int8 input can flip at a .5 boundary (see
    test_tiny_quant_unet_matches_jax); eps within 0.1 of max |eps| and the
    collected amax within 0.1 relative, those tests' bounds after a flip;
    one fused norm a GroupNorm module."""
    jq, qp, tm = _quant_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([10.0, 700.0], np.float32)
    want = np.asarray(jq.apply({"params": qp}, jnp.asarray(x),
                               jnp.asarray(t)))
    calls = []
    real, fused_ok = tunet.fused_groupnorm, tunet._fused_norm_ok
    monkeypatch.setattr(tunet, "fused_groupnorm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        table = tunet.calibrate_act_scales(tm, [torch.tensor(x)],
                                           [torch.tensor(t)])
    outs, tabs = {}, {}
    for on in (True, False):
        monkeypatch.setattr(tunet, "_fused_norm_ok",
                            fused_ok if on else (lambda *a: False))
        del calls[:]
        scales = {"dynamic": tunet.DYNAMIC,
                  "collect": tunet.ActScales(
                      "collect", torch.zeros((tm.n_sites, 1)), 0),
                  "static": tunet.ActScales("static", table, 0)}[mode]
        with torch.no_grad():
            outs[on] = tm(torch.tensor(x), torch.tensor(t), scales).numpy()
        tabs[on] = scales.table
        assert len(calls) == (25 if on else 0)
    scale = np.abs(want).max()
    assert scale > 0.1
    for got in outs.values():
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1 * scale)
    np.testing.assert_allclose(outs[True], outs[False], rtol=0,
                               atol=0.1 * scale)
    if mode == "collect":
        assert tabs[True].min() > 0
        np.testing.assert_allclose(tabs[True].numpy(), tabs[False].numpy(),
                                   rtol=0.1)


def _ddnm_inputs(B=2, H=16, steps=25, seed=4):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, H, H, 3)).astype(np.float32)
    masks = (rng.random((B, H, H)) < 0.5).astype(np.float32)
    noise = rng.standard_normal((1 + steps, B, H, H, 3)).astype(np.float32)
    return imgs * masks[..., None], masks, noise


def _psnr(a, b):
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_ddnm_quant_modes_match_jax():
    """25 steps on the tiny w8a8 UNet with injected noise: dynamic, collect
    and static (scales from collect, margin 1.3) in both packages.  Each
    step's forward can flip an int8 at a .5 boundary, which this network
    amplifies (see test_tiny_quant_unet_matches_jax), so the two
    trajectories part: the per-step calibration maxima within 0.15
    relative (measured 0.064 at most, 0.01 at step 0), the images >= 30 dB
    against JAX's of the same mode (measured 36.3 dynamic), the known
    region >= 60 dB (the data: measured 120, equal), and the JAX package's
    fidelity gate held against its fp sampler: >= 28 dB (measured 37.8;
    JAX's own int8 reaches 41.2).  That bound does not tell one static
    table column from another: the sampler's step index is checked
    exactly, and a table whose columns differ by 4x is held to JAX's."""
    jq, qp, tm = _quant_pair()
    imgs, masks, noise = _ddnm_inputs()
    T = noise.shape[0] - 1
    args_j = (jnp.asarray(imgs), jnp.asarray(masks), jax.random.PRNGKey(0))
    out_j, calib_j = jddnm.ddnm_inpaint_batch(
        jq, qp, *args_j, t_sampling=T, noise=jnp.asarray(noise),
        collect_calib=True)
    out_t, calib_t = tddnm.ddnm_inpaint_batch(
        tm, torch.tensor(imgs), torch.tensor(masks), t_sampling=T,
        noise=torch.tensor(noise), collect_calib=True)
    order = [jp for *_, jp in tunet.quant_sites(tm)]
    cj = np.stack([np.asarray(calib_j[b][m]["amax"]) for b, m in order])
    assert calib_t.shape == cj.shape == (33, T)
    np.testing.assert_allclose(calib_t.numpy(), cj, rtol=0.15)
    dyn_t = tddnm.ddnm_inpaint_batch(tm, torch.tensor(imgs),
                                     torch.tensor(masks), t_sampling=T,
                                     noise=torch.tensor(noise))
    torch.testing.assert_close(dyn_t, out_t, rtol=0, atol=0)
    scales_j = jax.tree_util.tree_map(lambda a: (a * 1.3).astype(
        jnp.float32), calib_j)
    stat_j = jddnm.ddnm_inpaint_batch(
        jq, qp, *args_j, t_sampling=T, noise=jnp.asarray(noise),
        act_scales=scales_j)
    # the forwards' scales: the static table, its column s at step s
    seen = []
    hook = tm.register_forward_pre_hook(lambda m, a: seen.append(a[2]))
    table = calib_t * 1.3
    stat_t = tddnm.ddnm_inpaint_batch(
        tm, torch.tensor(imgs), torch.tensor(masks), t_sampling=T,
        noise=torch.tensor(noise), act_scales=table)
    hook.remove()
    assert [(sc.mode, sc.table is table, sc.step) for sc in seen] == \
        [("static", True, s) for s in range(T)]
    fp_j = np.asarray(jddnm.ddnm_inpaint_batch(
        junet.UNetModel(dtype=jnp.float32, **TINY), _perturbed_params(),
        *args_j, t_sampling=T, noise=jnp.asarray(noise)))
    known = np.broadcast_to(masks[..., None] > 0, imgs.shape)
    for got, want in ((out_t, out_j), (stat_t, stat_j)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        assert _psnr(got, want) >= 30.0
        assert _psnr(got[known], want[known]) >= 60.0
        assert _psnr(got, fp_j) >= 28.0
    # a table whose odd steps' scales are a quarter of the calibrated ones
    # (their activations saturate): a sampler or a layer that read another
    # step's column would part from JAX's (measured: 38.5 dB; every step
    # reading step 0's column 24.0, step s reading s + 1's 23.1, the
    # calibrated table without the quarters 22.1)
    quarter = np.where(np.arange(T) % 2, 0.25, 1.0).astype(np.float32)
    steep_j = np.asarray(jddnm.ddnm_inpaint_batch(
        jq, qp, *args_j, t_sampling=T, noise=jnp.asarray(noise),
        act_scales=jax.tree_util.tree_map(lambda a: (
            a * 1.3 * jnp.asarray(quarter)).astype(jnp.float32), calib_j)))
    steep_t = tddnm.ddnm_inpaint_batch(
        tm, torch.tensor(imgs), torch.tensor(masks), t_sampling=T,
        noise=torch.tensor(noise),
        act_scales=table * torch.tensor(quarter)[None])
    assert _psnr(steep_t.numpy(), steep_j) >= 30.0


def test_inpainter_static_calib_first_call_equals_second():
    _, _, tm = _quant_pair()
    imgs, masks, _ = _ddnm_inputs(steps=5)
    inp = tddnm.DDNMInpainter(tm, t_sampling=5, seed=3, static_calib=True)
    first = inp.inpaint(torch.tensor(imgs), torch.tensor(masks))
    cached = inp.act_scales
    assert cached is not None and cached.shape == (33, 5)
    second = inp.inpaint(torch.tensor(imgs), torch.tensor(masks))
    assert inp.act_scales is cached
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    # the first call's result is the static one, on the same draws
    gen = torch.Generator().manual_seed(3)
    want = tddnm.ddnm_inpaint_batch(tm, torch.tensor(imgs),
                                    torch.tensor(masks), gen, 5,
                                    act_scales=cached)
    torch.testing.assert_close(first, want, rtol=0, atol=0)


def test_inpainter_threads_share_one_calibration():
    """Two threads call a fresh static-scale inpainter at once, on two
    inputs: one of them calibrates, the other waits for its scales, and
    each returns what a serial call with those scales returns, bit for
    bit (the scales travel down the forward; the model holds no state a
    thread could change under another)."""
    _, _, tm = _quant_pair()
    ins = [_ddnm_inputs(steps=5, seed=sd)[:2] for sd in (4, 5)]
    ins = [tuple(torch.tensor(a) for a in pair) for pair in ins]
    tables = []
    for imgs, masks in ins:
        inp = tddnm.DDNMInpainter(tm, t_sampling=5, seed=3,
                                  static_calib=True)
        inp.inpaint(imgs, masks)
        tables.append(inp.act_scales)
    assert not torch.equal(*tables)

    def serial(i, table):
        gen = torch.Generator().manual_seed(3)
        return tddnm.ddnm_inpaint_batch(tm, *ins[i], gen, 5,
                                        act_scales=table)

    for _ in range(2):
        inp = tddnm.DDNMInpainter(tm, t_sampling=5, seed=3,
                                  static_calib=True)
        go = threading.Barrier(2)
        outs = [None, None]

        def run(i):
            go.wait()
            outs[i] = inp.inpaint(*ins[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        won = [i for i, t in enumerate(tables)
               if torch.equal(inp.act_scales, t)]
        assert len(won) == 1
        for i in (0, 1):
            torch.testing.assert_close(outs[i], serial(i, tables[won[0]]),
                                       rtol=0, atol=0)


def test_static_forward_reads_its_step_column():
    """A static table of three columns (the calibrated scales, a quarter
    and four times them): the forward at step s equals the forward with
    column s alone, bit for bit, and the columns give three results."""
    _, _, tm = _quant_pair()
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([10.0, 700.0])
    with torch.no_grad():
        base = tunet.calibrate_act_scales(tm, [x], [t])
        table = torch.cat([base, base * 0.25, base * 4.0], dim=1)
        outs = [tm(x, t, tunet.ActScales("static", table, s))
                for s in range(3)]
        for s in range(3):
            one = tm(x, t, tunet.ActScales("static",
                                           table[:, s:s + 1].clone()))
            torch.testing.assert_close(outs[s], one, rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="33 sites"):
        tm(x, t, tunet.ActScales("static", table[:5]))
    with pytest.raises(ValueError, match="mode"):
        tunet.ActScales("static")


def test_static_calib_degrades_on_unquantized_model():
    tm = tunet.UNetModel(**TINY).eval()
    imgs, masks, _ = _ddnm_inputs(B=1, steps=3)
    inp = tddnm.DDNMInpainter(tm, t_sampling=3, static_calib=True)
    out = inp.inpaint(torch.tensor(imgs), torch.tensor(masks))
    assert inp.static_calib is False and inp.act_scales is None
    gen = torch.Generator().manual_seed(inp.seed)
    want = tddnm.ddnm_inpaint_batch(tm, torch.tensor(imgs),
                                    torch.tensor(masks), gen, 3)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_load_inpainter_builds_the_w8a8_unet():
    from pointdreamer_tpu_torch.models.diffusion import load_inpainter

    with pytest.warns(UserWarning, match="randomly"):
        inp = load_inpainter(device="cpu", model_kwargs=TINY,
                             dtype=torch.float32, quant_int8=True,
                             quant_static=False)
    assert inp.model.quant and inp.static_calib is False
    assert inp.model.n_sites == 33
    # quantized from the same seeded fp32 init as the fp model
    with pytest.warns(UserWarning):
        fp = load_inpainter(device="cpu", model_kwargs=TINY,
                            dtype=torch.float32)
    w = fp.model.input_blocks[1][0].in_layers[2].weight
    kq, ks = tunet.quantize_weight(w)
    q = inp.model.input_blocks[1][0].in_layers[2]
    torch.testing.assert_close(q.kernel_q, kq.permute(0, 2, 3, 1))
    torch.testing.assert_close(q.kernel_s, ks)
    with pytest.warns(UserWarning):
        st = load_inpainter(device="cpu", model_kwargs=TINY,
                            dtype=torch.float32, quant_int8=True)
    assert st.static_calib is True


# ---- the wrappers -----------------------------------------------------------

def _wrapper_cases():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 4, 4, 32)).astype(np.float32))
    xq = torch.tensor(rng.integers(-127, 128, (1, 4, 4, 32)).astype(np.int8))
    wq = torch.tensor(rng.integers(-127, 128, (8, 288)).astype(np.int8))
    s = torch.tensor(rng.random(8).astype(np.float32))
    ax = torch.tensor([0.01])
    return [(tq.quantize_act, tq.quantize_act_plain, (x,)),
            (tq.int8_conv, tq.int8_conv_plain, (xq, wq, ax, s, s))]


@pytest.mark.parametrize("case", range(2), ids=["quantize_act", "int8_conv"])
def test_quant_wrappers_take_the_plain_version_only_on_cpu(case,
                                                           monkeypatch):
    wrapper, plain, args = _wrapper_cases()[case]

    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(kernels, "lib", no_library)
    before = dict(kernels.LAUNCHES)
    got, want = wrapper(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrapper(*[a.to("meta") for a in args])


def test_mma_counts_include_int8_tensor_core_instructions():
    sass = """
        Function : _ZN12_GLOBAL__N_116int8_conv_kernelILb1ELb1EEEvNS_10ConvParamsE
        /*0100*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0110*/                   IMMA.16832.S8.S8 R12, R8.ROW, R4.COL, R12 ;
        /*0120*/                   IMMA.16832.S8.S8 R16, R8.ROW, R6.COL, R16 ;
        Function : _ZN12_GLOBAL__N_117quant_nchw_kernelIfEEvPKT_iiPKfPfS6_Pa
        /*0100*/                   FMUL R1, R2, R3 ;
"""
    counts = kernels.mma_counts(sass)
    assert list(counts.values()) == [2, 0]
