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
The torso's activations are channels last in memory (NCHW shapes over
NHWC storage, the public layout's own), so the convolutions need no
transposes and each GroupNorm, with the ResBlock's scale-shift and the
SiLU after it, is one K5 launch (`kernels.groupnorm.fused_groupnorm`) on
the [B, H*W, C] view; where autograd needs the norm's gradient, or its
groups are not 32 whole ones (a tp shard), it runs the unfused chain.
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
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ...kernels.groupnorm import GROUPS, fused_groupnorm
from ...kernels.quant import act_scale, int8_conv, quantize, quantize_act
from ...ops.image import resize_linear_hwc
from ...parallel.mesh import (all_reduce, copy_to_tp, reduce_from_tp, rows,
                              shard_params_dp_tp)
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


def _fused_norm_ok(norm: nn.GroupNorm, x: torch.Tensor,
                   ss: Optional[torch.Tensor]) -> bool:
    """Whether K5 can take the norm: its 32 groups (not a tp shard's
    32 / tp) and no gradient to carry (K5 has no backward)."""
    return norm.num_groups == GROUPS and not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, norm.weight, norm.bias, ss)))


def _norm_act(norm: nn.GroupNorm, x: torch.Tensor,
              ss: Optional[torch.Tensor] = None, silu: bool = True,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """GroupNorm32 (fp32 statistics) of x [B, C, *spatial], then with `ss`
    [1 or B, 2C] (scale, shift) y * (1 + scale) + shift, then the SiLU, in
    `out_dtype`.  One K5 launch on the channels-last view [B, S, C] (free
    when x is channels last in memory), the result a channels-last view
    of x's shape; else the unfused chain: the norm in fp32, cast, the
    scale-shift in `out_dtype` (the JAX package's order)."""
    if _fused_norm_ok(norm, x, ss):
        b, c = x.shape[:2]
        xl = x.movedim(1, -1)
        if ss is not None:
            ss = ss.expand(b, 2 * c).float().contiguous()
        y = fused_groupnorm(xl.reshape(b, -1, c), norm.weight, norm.bias, ss,
                            silu=silu, eps=norm.eps, out_dtype=out_dtype)
        return y.view(xl.shape).movedim(-1, 1)
    h = F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                     norm.bias.float(), norm.eps).to(out_dtype)
    if ss is not None:
        scale, shift = ss.reshape(ss.shape + (1,) * (x.dim() - 2)).chunk(
            2, dim=1)
        h = h * (1 + scale) + shift
    return F.silu(h) if silu else h


@dataclass(frozen=True)
class ActScales:
    """How a w8a8 forward scales its activations, passed down the forward
    as the JAX package passes its `act_scales` variables and gathers its
    `calib` collection: `mode` 'dynamic' (max |x| of each call), 'collect'
    (dynamic, the amax written to `table[site, step]`) or 'static'
    (`table[site, step]` is the amax).  `table` is a device fp32 [n_sites,
    n_steps]: each site reads or writes a one-element view of it, so a
    loop over steps syncs nothing.  The model keeps none of it, so
    threads that share one model each pass their own.  `group` (a mesh
    axis, views over dp): a dynamic or collected amax is the max over the
    axis' ranks, all_reduce(MAX), the global batch's as under GSPMD."""
    mode: str = "dynamic"
    table: Optional[torch.Tensor] = None
    step: int = 0
    group: object = None

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
    dtype.  A torso input [B, C, H, W] is read as its NHWC view (no copy
    when it is channels last in memory) and K8 writes rows, so the output
    [B, Cout, Ho, Wo] is channels last too.  A dense layer reads [B, T, C]
    and writes rows [B*T, Cout]."""

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

    def forward(self, x, dtype, scales: ActScales = DYNAMIC):
        static = scales.slot(self.site) if scales.mode == "static" else None
        calib = scales.slot(self.site) if scales.mode == "collect" else None
        if static is None and scales.group is not None:
            static = all_reduce(x.abs().amax().float().reshape(1),
                                scales.group, dist.ReduceOp.MAX)
        # NHWC; a dense layer's rows are B x T x 1 pixels
        xl = x.permute(0, 2, 3, 1) if x.dim() == 4 else x[:, :, None]
        b, h, w = xl.shape[:3]
        k = self.kernel_size
        xq, ax = quantize_act(xl, static, calib)
        y = int8_conv(xq.view(b, h, w, -1),
                      self.kernel_q.view(self.kernel_q.shape[0], -1), ax,
                      self.kernel_s, self.bias, k, k, self.stride,
                      self.padding, dtype)
        if x.dim() == 3:
            return y
        ho, wo = [(n + 2 * self.padding - k) // self.stride + 1
                  for n in (h, w)]
        return y.view(b, ho, wo, -1).permute(0, 3, 1, 2)


class QDense8(QConv8):
    """w8a8 dense layer (the attention's qkv / proj), a 1x1 QConv8 over
    [B, T, C] to rows [B*T, Cout]; `kernel_q` [Cout, 1, 1, Cin]."""

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
    """reference unet.py:143-257 (scale-shift norm, optional up/down).
    `tp` (set by `shard_unet_tp_`): in_conv holds this rank's output
    channels, the out norm its 32 / tp groups, out_conv its input
    channels, whose partial sums are reduced over tp."""

    tp = None

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
        h = _norm_act(self.in_layers[0], x, out_dtype=dtype)
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_down2(h), _avg_down2(x)
        tp = self.tp
        if tp is not None:               # in_conv column-parallel
            h = copy_to_tp(h, tp)
        h = _conv(self.in_layers[2], h, dtype, scales)
        emb_out = _linear(self.emb_layers[1], F.silu(emb), dtype)
        if tp is not None:
            # emb stays replicated: this rank's channels of each half
            emb_out = copy_to_tp(emb_out, tp)
            sl = rows(self.out_layers[0].num_channels * tp.size, tp)
            emb_out = torch.cat([e[:, sl] for e in emb_out.chunk(
                1 + self.use_scale_shift_norm, dim=1)], dim=1)
        if self.use_scale_shift_norm:
            h = _norm_act(self.out_layers[0], h, emb_out, out_dtype=dtype)
        else:
            h = _norm_act(self.out_layers[0], h + emb_out[:, :, None, None],
                          out_dtype=dtype)
        if tp is not None:               # out_conv row-parallel
            conv = self.out_layers[3]
            h = reduce_from_tp(F.conv2d(h, conv.weight.to(dtype), None,
                                        conv.stride, conv.padding), tp)
            h = h + conv.bias.to(dtype)[:, None, None]
        else:
            h = _conv(self.out_layers[3], h, dtype, scales)
        if not isinstance(self.skip_connection, nn.Identity):
            x = _conv(self.skip_connection, x, dtype, scales)
        return x.to(dtype) + h


class AttentionBlock(nn.Module):
    """reference unet.py:259-305 + QKVAttentionLegacy; attention on K2.
    `tp` (set by `shard_unet_tp_`): qkv holds this rank's heads (its rows
    are head-major), proj_out their input columns, reduced over tp."""

    tp = None

    def __init__(self, channels, num_head_channels=64):
        super().__init__()
        self.num_heads = channels // num_head_channels
        self.norm = nn.GroupNorm(32, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, dtype, scales: ActScales = DYNAMIC):
        b, c, hh, ww = x.shape
        # [b,t,c]: a view of the norm's output, contiguous where it is
        # channels last (K5), transposed where the chain wrote NCHW
        y = _norm_act(self.norm, x, silu=False, out_dtype=dtype).reshape(
            b, c, hh * ww).transpose(1, 2)
        if isinstance(self.qkv, QDense8):
            # K8 writes qkv as rows (K2's packed [b,t,3c]), proj as rows
            # (the block's channels-last output)
            qkv = self.qkv(y, dtype, scales).view(b, hh * ww, 3 * c)
            a = attention_qkv(qkv, self.num_heads)            # [b,t,c]
            out = self.proj_out(a, dtype, scales)             # [b*t,c]
            return x + out.view(b, hh, ww, c).permute(0, 3, 1, 2).to(x.dtype)
        tp = self.tp
        if tp is not None:    # qkv column (local heads), proj_out row
            y = copy_to_tp(y, tp)
        qkv = F.linear(y, self.qkv.weight[:, :, 0].to(dtype),
                       self.qkv.bias.to(dtype))
        a = attention_qkv(qkv, self.num_heads)                # [b,t,c/tp]
        if tp is not None:
            out = reduce_from_tp(F.linear(
                a, self.proj_out.weight[:, :, 0].to(dtype)), tp) \
                + self.proj_out.bias.to(dtype)
        else:
            out = F.linear(a, self.proj_out.weight[:, :, 0].to(dtype),
                           self.proj_out.bias.to(dtype))
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2).to(x.dtype)


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


def _make_layer(kind, cin, cout, flags, emb_ch, num_head_channels,
                use_scale_shift_norm):
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
        ch, skips, output_plan = self._build_encoder(
            model_channels, num_res_blocks, channel_mult, attention_ds,
            num_head_channels, use_scale_shift_norm, resblock_updown,
            in_channels)
        self.output_blocks = nn.ModuleList()
        for layers in output_plan:
            mods = nn.ModuleList()
            ch = ch + skips.pop()
            for kind, oc, flags in layers:
                mods.append(self._layer(kind, ch, oc, flags))
                ch = oc
            self.output_blocks.append(mods)
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))
        self.quant = False
        self.n_sites = 0
        if quant:
            _install_sites(self, lambda mod: _qsite_like(mod))

    def _build_encoder(self, model_channels, num_res_blocks, channel_mult,
                       attention_ds, num_head_channels, use_scale_shift_norm,
                       resblock_updown, in_channels):
        """The time embedding, input and middle blocks (shared with
        `EncoderUNetModel`); returns (channels, skip channels, output
        plan)."""
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
        self._layer_args = (emb_ch, num_head_channels, use_scale_shift_norm)
        ch = in_channels
        skips = []
        self.input_blocks = nn.ModuleList()
        for layers in input_plan:
            mods = nn.ModuleList()
            for kind, oc, flags in layers:
                mods.append(self._layer(kind, ch, oc, flags))
                ch = oc
            self.input_blocks.append(mods)
            skips.append(ch)
        self.middle_block = nn.ModuleList()
        for kind, oc, flags in middle_plan:
            self.middle_block.append(self._layer(kind, ch, oc, flags))
            ch = oc
        return ch, skips, output_plan

    def _layer(self, kind, cin, cout, flags):
        return _make_layer(kind, cin, cout, flags, *self._layer_args)

    def set_compute_dtype(self, dtype: torch.dtype,
                          keep_fp32_params: bool = False) -> "UNetModel":
        """Compute the torso in `dtype`; norms and the head (`out`) stay
        fp32.  The torso's conv/linear weights are stored in `dtype`
        (inference), or, with `keep_fp32_params`, kept fp32 and cast at
        each use, as flax keeps them (training: Adam's lr-sized updates
        vanish in bf16 master weights).  Stored for inference, every 2-d
        conv's weight is channels last, the activations' layout (cuDNN
        would copy it to that layout at each call)."""
        self.dtype = dtype
        if keep_fp32_params:
            return self
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)) \
                    and not name.startswith("out."):
                mod.to(dtype)
            if isinstance(mod, nn.Conv2d):
                mod.weight.data = mod.weight.data.contiguous(
                    memory_format=torch.channels_last)
        return self

    @staticmethod
    def _run(mod, h, emb, dtype, scales):
        if isinstance(mod, ResBlock):
            return mod(h, emb, dtype, scales)
        if isinstance(mod, nn.Conv2d):
            return _conv(mod, h, dtype)
        return mod(h, dtype, scales)

    def _encode(self, x: torch.Tensor, timesteps: torch.Tensor,
                scales: ActScales = DYNAMIC, keep_skips: bool = True):
        """The input and middle blocks: (h [N, C, H, W], channels last in
        memory as every block's output, the skips, emb)."""
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
            if keep_skips:
                hs.append(h)
        for mod in self.middle_block:
            h = self._run(mod, h, emb, dt, scales)
        return h, hs, emb

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                scales: ActScales = DYNAMIC) -> torch.Tensor:
        """x [N, H, W, C_in] float, timesteps [N] (or [1], shared by every
        row) -> [N, H, W, out] fp32; `scales` for the w8a8 sites (a table
        of one row per site)."""
        dt = self.dtype
        h, hs, emb = self._encode(x, timesteps, scales)
        for mods in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for mod in mods:
                h = self._run(mod, h, emb, dt, scales)
        h = _norm_act(self.out[0], h, out_dtype=torch.float32)
        h = _conv(self.out[2], h, torch.float32)
        return h.permute(0, 2, 3, 1)


def imagenet256_unet(quant: bool = False) -> UNetModel:
    """The demo's exact model (imagenet_256.yml:14-33), 552.8M params;
    `quant` for its w8a8 torso."""
    return UNetModel(quant=quant)


class SuperResModel(UNetModel):
    """Super-resolution UNet (reference unet.py:667-683; twin of the JAX
    `SuperResModel`): the UNet over x concatenated with `low_res`
    bilinearly upsampled to x's size (`ops.image.resize_linear`, as
    `jax.image.resize`), so its input conv takes 2 x `in_channels`.  The
    state-dict names are the reference's (a `UNetModel`'s)."""

    def __init__(self, in_channels: int = 3, **kwargs):
        super().__init__(in_channels=2 * in_channels, **kwargs)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: torch.Tensor,
                scales: ActScales = DYNAMIC) -> torch.Tensor:
        """x [N, H, W, C], low_res [N, h, w, C] -> [N, H, W, out] fp32."""
        up = resize_linear_hwc(low_res.float(), x.shape[1:3])
        return super().forward(torch.cat([x, up.to(x.dtype)], dim=-1),
                               timesteps, scales)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (reference unet.py:22-51): the spatial
    mean prepended as a query token (T = HW + 1), a learned positional
    embedding added, one QKV attention in the NEW order (q, k, v split
    first, then heads), the pooled token out.  fp32 `torch.matmul`s, as
    the JAX package's einsums outside Pallas; the reference's parameter
    names and layouts (`positional_embedding` [C, HW + 1], `qkv_proj` and
    `c_proj` 1-d convs)."""

    def __init__(self, spacial_dim: int, embed_dim: int,
                 num_head_channels: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim, 1)
        self.num_head_channels = num_head_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] fp32 -> [B, output_dim]."""
        b, c = x.shape[:2]
        t = x.reshape(b, c, -1).transpose(1, 2)                 # [b, hw, c]
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t + self.positional_embedding.float().T[None]
        qkv = F.linear(t, self.qkv_proj.weight[:, :, 0].float(),
                       self.qkv_proj.bias.float())
        hd = self.num_head_channels
        q, k, v = (a.reshape(b, -1, c // hd, hd) for a in qkv.chunk(3, -1))
        scale = 1.0 / math.sqrt(math.sqrt(hd))
        logits = torch.einsum("bthd,bshd->bhts", q * scale, k * scale)
        weights = torch.softmax(logits, dim=-1)
        a = torch.einsum("bhts,bshd->bthd", weights, v).reshape(b, -1, c)
        return F.linear(a[:, 0], self.c_proj.weight[:, :, 0].float(),
                        self.c_proj.bias.float())


class EncoderUNetModel(UNetModel):
    """The half-UNet classifier (reference unet.py:684-850; twin of the
    JAX `EncoderUNetModel`): the UNet's input and middle blocks, then a
    pooled head on GroupNorm + SiLU, `pool` 'adaptive' (global mean, then
    a zero-initialised 1x1 conv, `out.3`) or 'attention'
    (`AttentionPool2d`, `out.2`, over the (image_size / 2^(levels-1))^2
    pixels the torso leaves).  The attention blocks run on K2."""

    def __init__(self, model_channels: int = 256, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 attention_ds: Sequence[int] = (8, 16, 32),
                 num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, in_channels: int = 3,
                 pool: str = "adaptive", image_size: int = 256):
        nn.Module.__init__(self)
        ch, _, _ = self._build_encoder(
            model_channels, num_res_blocks, channel_mult, attention_ds,
            num_head_channels, use_scale_shift_norm, resblock_updown,
            in_channels)
        self.pool = pool
        if pool == "adaptive":
            self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                     nn.AdaptiveAvgPool2d((1, 1)),
                                     nn.Conv2d(ch, out_channels, 1),
                                     nn.Flatten())
        elif pool == "attention":
            side = image_size // 2 ** (len(channel_mult) - 1)
            self.out = nn.Sequential(
                nn.GroupNorm(32, ch), nn.SiLU(),
                AttentionPool2d(side, ch, num_head_channels, out_channels))
        else:
            raise ValueError(f"unsupported pool '{pool}'")
        self.quant = False
        self.n_sites = 0

    def forward(self, x: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C] float, timesteps [N] -> logits [N, out] fp32."""
        h, _, _ = self._encode(x, timesteps, keep_skips=False)
        h = _norm_act(self.out[0], h, out_dtype=torch.float32)
        if self.pool == "adaptive":
            conv = self.out[3]
            return F.linear(h.mean(dim=(2, 3)),
                            conv.weight[:, :, 0, 0].float(), conv.bias.float())
        return self.out[2](h)


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


def _shard_(mod: nn.Module, name: str, dim: int, sl: slice) -> None:
    p = getattr(mod, name)
    idx = (slice(None),) * dim + (sl,)
    setattr(mod, name, nn.Parameter(p.detach()[idx].clone(),
                                    requires_grad=p.requires_grad))


@torch.no_grad()
def shard_unet_tp_(model: UNetModel, mesh) -> UNetModel:
    """Keep this rank's tp shard of each ResBlock and AttentionBlock that
    `parallel.mesh.unet_shard_rule` splits (the Megatron pairing), in
    place; the blocks' forwards then reduce their partial sums over the
    mesh's tp axis.  tp == 1 changes nothing.  A w8a8 model stays whole
    on every rank: JAX's rule splits none of its int8 kernels (only the
    biases and norms between them, which GSPMD gathers back), so each tp
    rank runs the whole int8 forward, and the result is one device's."""
    tp = mesh.tp
    if tp.size == 1 or model.quant:
        return model
    if 32 % tp.size:
        raise ValueError(f"tp={tp.size} does not divide GroupNorm's 32 "
                         "groups")
    rule = shard_params_dp_tp(
        {n: tuple(p.shape) for n, p in model.named_parameters()}, mesh)
    for name, mod in list(model.named_modules()):
        if isinstance(mod, ResBlock):
            # the rule splits the pair and the norm between on one width
            if rule[f"{name}.in_layers.2.weight"] is None:
                continue
            c = mod.in_layers[2].out_channels
            sl = rows(c, tp)
            _shard_(mod.in_layers[2], "weight", 0, sl)
            _shard_(mod.in_layers[2], "bias", 0, sl)
            old = mod.out_layers[0]
            norm = nn.GroupNorm(old.num_groups // tp.size, c // tp.size,
                                old.eps, device=old.weight.device,
                                dtype=old.weight.dtype)
            norm.weight.copy_(old.weight[sl])
            norm.bias.copy_(old.bias[sl])
            norm.requires_grad_(old.weight.requires_grad)
            mod.out_layers[0] = norm
            _shard_(mod.out_layers[3], "weight", 1, sl)
            mod.tp = tp
        elif isinstance(mod, AttentionBlock):
            if rule[f"{name}.qkv.weight"] is None:
                continue
            if mod.num_heads % tp.size:
                raise ValueError(f"{name}: {mod.num_heads} heads do not "
                                 f"split over tp={tp.size}")
            c = mod.proj_out.out_channels
            _shard_(mod.qkv, "weight", 0, rows(3 * c, tp))
            _shard_(mod.qkv, "bias", 0, rows(3 * c, tp))
            _shard_(mod.proj_out, "weight", 1, rows(c, tp))
            mod.num_heads //= tp.size
            mod.tp = tp
    return model


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
    proj_out, the final conv and the adaptive head's 1x1; an attention
    pool's positional embedding normal with std C^-1/2)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, AttentionPool2d):
            c = mod.positional_embedding.shape[0]
            mod.positional_embedding.copy_(torch.randn(
                mod.positional_embedding.shape, generator=gen, device=dev)
                / math.sqrt(c))
        elif isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)):
            mod.bias.zero_()
            if name.endswith(_ZERO_INIT) or name in ("out.2", "out.3"):
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
