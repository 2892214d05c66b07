"""Guided-diffusion UNet in PyTorch (twin of models/diffusion/unet.py).

The module tree and parameter names follow the reference guided-diffusion
`UNetModel` (models/DDNM/guided_diffusion/unet.py:396), so a real
`256x256_diffusion_uncond.pt` state dict loads with `load_state_dict` as
it is: `time_embed.{0,2}`, `input_blocks.{i}.{j}...`, `middle_block.{j}`,
`output_blocks.{i}.{j}`, `out.{0,2}`; ResBlock `in_layers.{0,2}`,
`emb_layers.1`, `out_layers.{0,3}`, `skip_connection`; AttentionBlock
`norm`, `qkv`, `proj_out` (1-d convs); Downsample `op`, Upsample `conv`.

Numerics follow the JAX package: the torso computes in `dtype` (bf16 on
the card), GroupNorm (32 groups) in fp32, the final norm + conv in fp32.
Each conv and linear casts its input, weight and bias to the compute dtype
at use, as flax does, so the parameters may be stored in it (inference:
`set_compute_dtype(bf16)`) or kept fp32 for training
(`set_compute_dtype(bf16, keep_fp32_params=True)`).
The public layout is the JAX package's: x [N, H, W, 3] -> eps [N, H, W, 6].
Attention runs on K2 (`attention.attention_qkv`).

w8a8 (`UNetModel(quant=True)`, or `quantize_unet_` on an fp32 model): the
torso's convolutions and attention projections become `QConv8` /
`QDense8`, at the JAX package's sites (unet.py:66-126, `_FP_MODULES`):
int8 weights per output channel, per-tensor int8 activations, on K7
(quantize) and K8 (int8 implicit-GEMM conv) of `kernels/quant.py`.  The
activation scales follow the `ActScales` the forward is given: dynamic,
collected per step into a device table, or static from such a table,
indexed by the step the sampler passes (no host sync).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...kernels.quant import act_scale, int8_conv, quantize, quantize_act
from .attention import attention_qkv


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def unet_plan(model_channels=256, num_res_blocks=2,
              channel_mult=(1, 1, 2, 2, 4, 4), attention_ds=(8, 16, 32),
              resblock_updown=True):
    """The reference constructor's block layout (unet.py:470-607), as the
    JAX package's `unet_plan`: (input_plan, middle_plan, output_plan) of
    (kind, out_ch, flags) entries."""
    ch = int(channel_mult[0] * model_channels)
    input_plan: List[List[Tuple]] = [[("conv", ch, {})]]
    ds = 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            ch = int(mult * model_channels)
            layers = [("res", ch, {})]
            if ds in attention_ds:
                layers.append(("attn", ch, {}))
            input_plan.append(layers)
        if level != len(channel_mult) - 1:
            input_plan.append([("res", ch, {"down": True})] if resblock_updown
                              else [("down", ch, {})])
            ds *= 2
    middle_plan = [("res", ch, {}), ("attn", ch, {}), ("res", ch, {})]
    output_plan: List[List[Tuple]] = []
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            ch = int(model_channels * mult)
            layers = [("res", ch, {})]
            if ds in attention_ds:
                layers.append(("attn", ch, {}))
            if level and i == num_res_blocks:
                layers.append(("res", ch, {"up": True}) if resblock_updown
                              else ("up", ch, {}))
                ds //= 2
            output_plan.append(layers)
    return input_plan, middle_plan, output_plan


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm32 in fp32 (the output stays fp32)."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                        norm.bias.float(), norm.eps)


@dataclass(frozen=True)
class ActScales:
    """How a w8a8 forward scales its activations, passed down the forward
    as the JAX package passes its `act_scales` variables and gathers its
    `calib` collection: `mode` 'dynamic' (max |x| of each call), 'collect'
    (dynamic, the amax written to `table[site, step]`) or 'static'
    (`table[site, step]` is the amax).  `table` is a device fp32 [n_sites,
    n_steps]: each site reads or writes a one-element view of it, so a
    loop over steps syncs nothing.  The model keeps none of it, so
    threads that share one model each pass their own."""
    mode: str = "dynamic"
    table: Optional[torch.Tensor] = None
    step: int = 0

    def __post_init__(self):
        if self.mode not in ("dynamic", "collect", "static"):
            raise ValueError(f"unknown activation-scale mode {self.mode!r}")
        if (self.mode == "dynamic") != (self.table is None):
            raise ValueError(f"mode {self.mode!r} with table "
                             f"{self.table is not None}")

    def slot(self, site: int) -> Optional[torch.Tensor]:
        if self.table is None:
            return None
        return self.table[site, self.step:self.step + 1]


DYNAMIC = ActScales()


class QConv8(nn.Module):
    """w8a8 convolution (twin of the JAX QConv8): `kernel_q` int8
    [Cout, kh, kw, Cin], `kernel_s` fp32 [Cout] (per-output-channel
    max |w| / 127), `bias` fp32 [Cout]; K7 quantizes the input with a
    per-tensor scale, K8 convolves in int32 and dequantizes to the compute
    dtype.  Writes NCHW, or rows [B*Ho*Wo, Cout] (`rows=True`)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, device=None):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.padding = k, stride, padding
        self.kernel_q = nn.Parameter(torch.zeros(
            (cout, k, k, cin), dtype=torch.int8, device=device),
            requires_grad=False)
        self.kernel_s = nn.Parameter(torch.ones(cout, device=device),
                                     requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device),
                                 requires_grad=False)
        self.site = -1                       # set by the UNetModel

    def forward(self, x, dtype, scales: ActScales = DYNAMIC,
                channels_last: bool = False, rows: bool = False):
        static = scales.slot(self.site) if scales.mode == "static" else None
        calib = scales.slot(self.site) if scales.mode == "collect" else None
        xq, ax = quantize_act(x, channels_last, static, calib)
        # an NCHW conv input keeps its H x W; a dense layer's rows are
        # B x S x 1 pixels
        h, w = (x.shape[2], x.shape[3]) \
            if x.dim() == 4 and not channels_last else (xq.shape[1], 1)
        k = self.kernel_size
        return int8_conv(xq.view(x.shape[0], h, w, -1),
                         self.kernel_q.view(self.kernel_q.shape[0], -1), ax,
                         self.kernel_s, self.bias, k, k, self.stride,
                         self.padding, dtype, rows)


class QDense8(QConv8):
    """w8a8 dense layer (the attention's qkv / proj), a 1x1 QConv8 over
    [B, C, T] (or channels last [B, T, C]); `kernel_q` [Cout, 1, 1, Cin]."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__(cin, cout, 1, 1, 0, device)


def _conv(conv, x: torch.Tensor, dtype,
          scales: ActScales = DYNAMIC) -> torch.Tensor:
    """The conv in `dtype`: input, weight and bias cast at use (no-ops when
    the weights are stored in `dtype`); a QConv8 quantizes x itself."""
    if isinstance(conv, QConv8):
        return conv(x, dtype, scales)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _nearest_up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _avg_down2(x):
    return F.avg_pool2d(x.float(), 2).to(x.dtype)


class ResBlock(nn.Module):
    """reference unet.py:143-257 (scale-shift norm, optional up/down)."""

    def __init__(self, channels, out_channels, emb_channels, up=False,
                 down=False, use_scale_shift_norm=True):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3,
                                                 padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels
                                 if use_scale_shift_norm else out_channels))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_channels),
                                        nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(out_channels, out_channels,
                                                  3, padding=1))
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else nn.Conv2d(channels, out_channels, 1))

    def forward(self, x, emb, dtype, scales: ActScales = DYNAMIC):
        h = F.silu(_group_norm(self.in_layers[0], x).to(dtype))
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_down2(h), _avg_down2(x)
        h = _conv(self.in_layers[2], h, dtype, scales)
        emb_out = _linear(self.emb_layers[1], F.silu(emb), dtype)
        emb_out = emb_out[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = _group_norm(self.out_layers[0], h).to(dtype) * (1 + scale) \
                + shift
        else:
            h = _group_norm(self.out_layers[0], h + emb_out).to(dtype)
        h = _conv(self.out_layers[3], F.silu(h), dtype, scales)
        if not isinstance(self.skip_connection, nn.Identity):
            x = _conv(self.skip_connection, x, dtype, scales)
        return x.to(dtype) + h


class AttentionBlock(nn.Module):
    """reference unet.py:259-305 + QKVAttentionLegacy; attention on K2."""

    def __init__(self, channels, num_head_channels=64):
        super().__init__()
        self.num_heads = channels // num_head_channels
        self.norm = nn.GroupNorm(32, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, dtype, scales: ActScales = DYNAMIC):
        b, c, hh, ww = x.shape
        y = _group_norm(self.norm, x.reshape(b, c, hh * ww)).to(dtype)
        if isinstance(self.qkv, QDense8):
            # K8 writes qkv as rows (K2's packed [b,t,3c]) and proj as NCHW
            qkv = self.qkv(y, dtype, scales, rows=True).view(
                b, hh * ww, 3 * c)
            a = attention_qkv(qkv, self.num_heads)            # [b,t,c]
            out = self.proj_out(a, dtype, scales,
                                channels_last=True)           # [b,c,t]
            return x + out.reshape(b, c, hh, ww).to(x.dtype)
        y = y.transpose(1, 2)                                  # [b,t,c]
        qkv = F.linear(y, self.qkv.weight[:, :, 0].to(dtype),
                       self.qkv.bias.to(dtype))
        a = attention_qkv(qkv.contiguous(), self.num_heads)   # [b,t,c]
        out = F.linear(a, self.proj_out.weight[:, :, 0].to(dtype),
                       self.proj_out.bias.to(dtype))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww).to(x.dtype)


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x, dtype, scales: ActScales = DYNAMIC):
        return _conv(self.op, x, dtype, scales)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, dtype, scales: ActScales = DYNAMIC):
        return _conv(self.conv, _nearest_up2(x), dtype, scales)


class UNetModel(nn.Module):
    """Twin of the JAX `UNetModel` with the reference's module tree."""

    def __init__(self, model_channels: int = 256, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 attention_ds: Sequence[int] = (8, 16, 32),
                 num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, in_channels: int = 3,
                 quant: bool = False):
        super().__init__()
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        # the widths `convert.params_from_jax` needs to map a flax tree
        self.plan_kwargs = dict(model_channels=model_channels,
                                num_res_blocks=num_res_blocks,
                                channel_mult=tuple(channel_mult),
                                attention_ds=tuple(attention_ds))
        self.dtype = torch.float32
        emb_ch = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_ch),
                                        nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        input_plan, middle_plan, output_plan = unet_plan(
            model_channels, num_res_blocks, tuple(channel_mult),
            tuple(attention_ds), resblock_updown)
        self._plans = (input_plan, middle_plan, output_plan)
        ch = in_channels

        def layer(kind, cin, cout, flags):
            if kind == "conv":
                return nn.Conv2d(cin, cout, 3, padding=1)
            if kind == "res":
                return ResBlock(cin, cout, emb_ch, up=flags.get("up", False),
                                down=flags.get("down", False),
                                use_scale_shift_norm=use_scale_shift_norm)
            if kind == "attn":
                return AttentionBlock(cin, num_head_channels)
            if kind == "down":
                return Downsample(cin)
            if kind == "up":
                return Upsample(cin)
            raise ValueError(kind)

        skips = []
        self.input_blocks = nn.ModuleList()
        for layers in input_plan:
            mods = nn.ModuleList()
            for kind, oc, flags in layers:
                mods.append(layer(kind, ch, oc, flags))
                ch = oc
            self.input_blocks.append(mods)
            skips.append(ch)
        self.middle_block = nn.ModuleList()
        for kind, oc, flags in middle_plan:
            self.middle_block.append(layer(kind, ch, oc, flags))
            ch = oc
        self.output_blocks = nn.ModuleList()
        for layers in output_plan:
            mods = nn.ModuleList()
            ch = ch + skips.pop()
            for kind, oc, flags in layers:
                mods.append(layer(kind, ch, oc, flags))
                ch = oc
            self.output_blocks.append(mods)
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))
        self.quant = False
        self.n_sites = 0
        if quant:
            _install_sites(self, lambda mod: _qsite_like(mod))

    def set_compute_dtype(self, dtype: torch.dtype,
                          keep_fp32_params: bool = False) -> "UNetModel":
        """Compute the torso in `dtype`; norms and the final conv stay fp32.
        The torso's conv/linear weights are stored in `dtype` (inference),
        or, with `keep_fp32_params`, kept fp32 and cast at each use, as
        flax keeps them (training: Adam's lr-sized updates vanish in bf16
        master weights)."""
        self.dtype = dtype
        if keep_fp32_params:
            return self
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)) \
                    and name != "out.2":
                mod.to(dtype)
        return self

    @staticmethod
    def _run(mod, h, emb, dtype, scales):
        if isinstance(mod, ResBlock):
            return mod(h, emb, dtype, scales)
        if isinstance(mod, nn.Conv2d):
            return _conv(mod, h, dtype)
        return mod(h, dtype, scales)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                scales: ActScales = DYNAMIC) -> torch.Tensor:
        """x [N, H, W, 3] float, timesteps [N] -> [N, H, W, out] fp32;
        `scales` for the w8a8 sites (a table of one row per site)."""
        if scales.table is not None and scales.table.shape[0] != self.n_sites:
            raise ValueError(f"scale table {tuple(scales.table.shape)} for "
                             f"{self.n_sites} sites")
        dt = self.dtype
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = _linear(self.time_embed[0], emb, dt)
        emb = _linear(self.time_embed[2], F.silu(emb), dt)
        h = x.permute(0, 3, 1, 2).to(dt)
        hs = []
        for mods in self.input_blocks:
            for mod in mods:
                h = self._run(mod, h, emb, dt, scales)
            hs.append(h)
        for mod in self.middle_block:
            h = self._run(mod, h, emb, dt, scales)
        for mods in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for mod in mods:
                h = self._run(mod, h, emb, dt, scales)
        h = F.silu(_group_norm(self.out[0], h))
        h = _conv(self.out[2], h, torch.float32)
        return h.permute(0, 2, 3, 1)


def imagenet256_unet(quant: bool = False) -> UNetModel:
    """The demo's exact model (imagenet_256.yml:14-33), 552.8M params;
    `quant` for its w8a8 torso."""
    return UNetModel(quant=quant)


# ---------------------------------------------------------------------------
# w8a8 sites and the weight transform

# per block type: (attribute, index in it, the JAX module name) of each
# site; everything else (time embeddings, the blocks' emb projections, the
# first and the last conv) stays floating point, as `_FP_MODULES` and the
# top-level exemptions of the JAX `quantize_unet_params` keep it
_SITE_ATTRS = {
    ResBlock: (("in_layers", 2, "in_conv"), ("out_layers", 3, "out_conv"),
               ("skip_connection", None, "skip")),
    AttentionBlock: (("qkv", None, "qkv"), ("proj_out", None, "proj")),
    Downsample: (("op", None, "conv"),),
    Upsample: (("conv", None, "conv"),),
}


def _jax_block_name(name: str) -> str:
    """'input_blocks.3.0' -> 'input_3_0', 'middle_block.1' -> 'middle_1'."""
    head, *idx = name.split(".")
    return "_".join([head.split("_")[0]] + idx)


def quant_sites(model: UNetModel) -> Iterator[Tuple[nn.Module, str,
                                                    Optional[int], str,
                                                    Tuple[str, str]]]:
    """Every w8a8 site of the model in module order: (block, attribute,
    index or None, the port's module name, the JAX package's path
    (block, module)).  The site's module is `getattr(block, attribute)`
    (indexed): an nn.Conv2d / nn.Conv1d in an fp model, a QConv8 /
    QDense8 in a quantized one."""
    for name, mod in model.named_modules():
        for attr, idx, jname in _SITE_ATTRS.get(type(mod), ()):
            target = getattr(mod, attr)
            if idx is not None:
                target = target[idx]
            if isinstance(target, nn.Identity):
                continue
            port = f"{name}.{attr}" + ("" if idx is None else f".{idx}")
            yield mod, attr, idx, port, (_jax_block_name(name), jname)


def _site_module(block, attr, idx):
    target = getattr(block, attr)
    return target if idx is None else target[idx]


def _qsite_like(mod: nn.Module) -> QConv8:
    """An empty QConv8 / QDense8 with the shape of an fp site."""
    dev = mod.weight.device
    if isinstance(mod, nn.Conv1d):
        return QDense8(mod.in_channels, mod.out_channels, device=dev)
    return QConv8(mod.in_channels, mod.out_channels, mod.kernel_size[0],
                  mod.stride[0], mod.padding[0], device=dev)


def _install_sites(model: UNetModel, make) -> UNetModel:
    """Replace every site's module by make(module) and number the sites
    (their rows in a scale table)."""
    sites = list(quant_sites(model))
    for n, (block, attr, idx, _, _) in enumerate(sites):
        new = make(_site_module(block, attr, idx))
        new.site = n
        if idx is None:
            setattr(block, attr, new)
        else:
            getattr(block, attr)[idx] = new
    model.n_sites = len(sites)
    model.quant = True
    return model


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of an fp weight [Cout, ...] (the JAX
    `quantize_unet_params` formula, in fp32): s = max(max |w|, 1e-12) /
    127 over everything but Cout, q = clip(round(w / s), -127, 127) -- the
    activations' formula with one scale a channel."""
    wf = w.float()
    s = act_scale(wf.abs().amax(dim=tuple(range(1, wf.dim()))))
    return quantize(wf, s.view(-1, *([1] * (wf.dim() - 1)))), s


@torch.no_grad()
def quantize_unet_(model: UNetModel) -> UNetModel:
    """fp UNet -> its w8a8 twin, in place (twin of the JAX
    `quantize_unet_params`): each site's weight becomes `kernel_q` int8
    [Cout, kh, kw, Cin] and `kernel_s` from its fp32 values (quantize
    before `set_compute_dtype` casts the torso to bf16), the bias fp32."""
    if model.quant:
        raise ValueError("the model is quantized already")

    def make(mod):
        q = _qsite_like(mod)
        w = mod.weight.float()
        if w.dim() == 3:                   # Conv1d [O, I, 1]
            w = w[..., None]
        kq, ks = quantize_weight(w)
        q.kernel_q.copy_(kq.permute(0, 2, 3, 1))
        q.kernel_s.copy_(ks)
        q.bias.copy_(mod.bias.float())
        return q

    return _install_sites(model, make)


@torch.no_grad()
def calibrate_act_scales(model: UNetModel, xs, ts,
                         margin: float = 1.3) -> torch.Tensor:
    """Static activation scales of a w8a8 model (twin of the JAX
    `calibrate_act_scales`): each site's max |activation| over the
    calibration inputs (dynamic scales), times `margin`, as a [n_sites, 1]
    table for `ActScales('static', table)`."""
    xs, ts = list(xs), list(ts)
    if not xs:
        raise ValueError("calibrate_act_scales: empty calibration input")
    table = torch.zeros((model.n_sites, len(xs)), dtype=torch.float32,
                        device=xs[0].device)
    for i, (x, t) in enumerate(zip(xs, ts)):
        model(x, t, ActScales("collect", table, i))
    return (table.amax(1, keepdim=True) * margin).float()


_ZERO_INIT = ("out_layers.3", "proj_out")


@torch.no_grad()
def init_random_(model: UNetModel, seed: int = 0) -> UNetModel:
    """Seeded random initialization, drawn directly on the model's device
    (flax's defaults, as the JAX package's random init: lecun-normal conv
    and dense kernels, zero biases, unit norms, and zero for the layers
    the reference zero-initializes: ResBlock out convs, attention
    proj_out and the final conv)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)):
            mod.bias.zero_()
            if name.endswith(_ZERO_INIT) or name == "out.2":
                mod.weight.zero_()
                continue
            fan_in = mod.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            w = torch.empty(mod.weight.shape, dtype=torch.float32,
                            device=dev)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            mod.weight.copy_(w * std)
    return model
