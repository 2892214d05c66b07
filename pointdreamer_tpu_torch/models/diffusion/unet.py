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
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """The conv in `dtype`: input, weight and bias cast at use (no-ops when
    the weights are stored in `dtype`)."""
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

    def forward(self, x, emb, dtype):
        h = F.silu(_group_norm(self.in_layers[0], x).to(dtype))
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_down2(h), _avg_down2(x)
        h = _conv(self.in_layers[2], h, dtype)
        emb_out = _linear(self.emb_layers[1], F.silu(emb), dtype)
        emb_out = emb_out[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = _group_norm(self.out_layers[0], h).to(dtype) * (1 + scale) \
                + shift
        else:
            h = _group_norm(self.out_layers[0], h + emb_out).to(dtype)
        h = _conv(self.out_layers[3], F.silu(h), dtype)
        if not isinstance(self.skip_connection, nn.Identity):
            x = _conv(self.skip_connection, x, dtype)
        return x.to(dtype) + h


class AttentionBlock(nn.Module):
    """reference unet.py:259-305 + QKVAttentionLegacy; attention on K2."""

    def __init__(self, channels, num_head_channels=64):
        super().__init__()
        self.num_heads = channels // num_head_channels
        self.norm = nn.GroupNorm(32, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, dtype):
        b, c, hh, ww = x.shape
        y = _group_norm(self.norm, x.reshape(b, c, hh * ww)).to(dtype)
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

    def forward(self, x, dtype):
        return _conv(self.op, x, dtype)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, dtype):
        return _conv(self.conv, _nearest_up2(x), dtype)


class UNetModel(nn.Module):
    """Twin of the JAX `UNetModel` with the reference's module tree."""

    def __init__(self, model_channels: int = 256, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 attention_ds: Sequence[int] = (8, 16, 32),
                 num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, in_channels: int = 3):
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
    def _run(mod, h, emb, dtype):
        if isinstance(mod, ResBlock):
            return mod(h, emb, dtype)
        if isinstance(mod, nn.Conv2d):
            return _conv(mod, h, dtype)
        return mod(h, dtype)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor
                ) -> torch.Tensor:
        """x [N, H, W, 3] float, timesteps [N] -> [N, H, W, out] fp32."""
        dt = self.dtype
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = _linear(self.time_embed[0], emb, dt)
        emb = _linear(self.time_embed[2], F.silu(emb), dt)
        h = x.permute(0, 3, 1, 2).to(dt)
        hs = []
        for mods in self.input_blocks:
            for mod in mods:
                h = self._run(mod, h, emb, dt)
            hs.append(h)
        for mod in self.middle_block:
            h = self._run(mod, h, emb, dt)
        for mods in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for mod in mods:
                h = self._run(mod, h, emb, dt)
        h = F.silu(_group_norm(self.out[0], h))
        h = _conv(self.out[2], h, torch.float32)
        return h.permute(0, 2, 3, 1)


def imagenet256_unet() -> UNetModel:
    """The demo's exact model (imagenet_256.yml:14-33), 552.8M params."""
    return UNetModel()


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
