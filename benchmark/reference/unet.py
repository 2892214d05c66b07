"""The ADM UNet of openai/guided-diffusion (guided_diffusion/unet.py,
`UNetModel` with `QKVAttentionLegacy`), written again in plain PyTorch
and computed in float32.

It imports nothing of the program under test.  Parameter names are the
published state dict's (`time_embed.{0,2}`, `input_blocks.{i}.{j}`,
`middle_block.{j}`, `output_blocks.{i}.{j}`, `out.{0,2}`; ResBlock
`in_layers.{0,2}`, `emb_layers.1`, `out_layers.{0,3}`, `skip_connection`;
AttentionBlock `norm`, `qkv`, `proj_out`), so one dict of tensors loads
into this model and into the program's.

Layout as the program's entry takes it: x [N, H, W, C_in] and timesteps
[N] or [1] -> [N, H, W, C_out].  `quant` makes it the control of a
configuration that computes in int8: the same sites that a w8a8 UNet
quantizes (each ResBlock's two 3x3 convs and its 1x1 skip, each attention
block's qkv and proj) get per-output-channel weights and per-tensor
activations rounded to `quant` bits, symmetric, computed in float32.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def set_exact_fp32() -> None:
    """Float32 products stay float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(x: torch.Tensor, bits: int, dims=None) -> torch.Tensor:
    """Symmetric rounding to 2^(bits-1) - 1 levels a side; the scale is
    max |x| over everything (`dims` None) or over `dims`."""
    q = 2 ** (bits - 1) - 1
    amax = x.abs().amax() if dims is None else x.abs().amax(dim=dims,
                                                              keepdim=True)
    s = amax.clamp(min=1e-12) / q
    return torch.clamp(torch.round(x / s), -q, q) * s


class Site:
    """A quantizable convolution: the module and how it is applied."""

    def __init__(self, owner: "UNet"):
        self.owner = owner

    def conv(self, mod: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
        w, bits = mod.weight, self.owner.quant
        if bits:
            w = fake_quant(w, bits, dims=tuple(range(1, w.dim())))
            x = fake_quant(x, bits)
        self.owner.record(mod, x, w, True)
        if w.dim() == 3:
            return F.conv1d(x, w, mod.bias)
        return F.conv2d(x, w, mod.bias, **kw)


def plain_conv(owner, mod, x, **kw):
    owner.record(mod, x, mod.weight, False)
    return F.conv2d(x, mod.weight, mod.bias, **kw)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class ResBlock(nn.Module):
    def __init__(self, owner, ch, out_ch, emb_ch, up=False, down=False):
        super().__init__()
        self.owner = [owner]
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                       nn.Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_ch, 2 * out_ch))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_ch), nn.SiLU(),
                                        nn.Dropout(0.0),
                                        nn.Conv2d(out_ch, out_ch, 3,
                                                  padding=1))
        self.skip_connection = (nn.Identity() if ch == out_ch
                                else nn.Conv2d(ch, out_ch, 1))

    def forward(self, x, emb):
        site = Site(self.owner[0])
        h = F.silu(self.in_layers[0](x))
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = site.conv(self.in_layers[2], h, padding=1)
        lin = self.emb_layers[1]
        self.owner[0].record(lin, None, lin.weight, False,
                             rows=emb.shape[0])
        scale, shift = F.linear(F.silu(emb), lin.weight, lin.bias)[
            :, :, None, None].chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = site.conv(self.out_layers[3], F.silu(h), padding=1)
        if not isinstance(self.skip_connection, nn.Identity):
            x = site.conv(self.skip_connection, x)
        return x + h


class AttentionBlock(nn.Module):
    """QKVAttentionLegacy: each head's [q | k | v] rows are contiguous."""

    def __init__(self, owner, ch, head_ch):
        super().__init__()
        self.owner = [owner]
        self.heads = ch // head_ch
        self.norm = nn.GroupNorm(32, ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x, emb=None):
        b, c, hh, ww = x.shape
        site = Site(self.owner[0])
        qkv = site.conv(self.qkv, self.norm(x.reshape(b, c, hh * ww)))
        t = hh * ww
        ch = c // self.heads
        q, k, v = qkv.reshape(b * self.heads, 3 * ch, t).split(ch, dim=1)
        self.owner[0].attention_calls.append((b, self.heads, t, ch))
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.softmax(torch.einsum("bct,bcs->bts", q * scale, k * scale),
                          dim=-1)
        a = torch.einsum("bts,bcs->bct", w, v).reshape(b, c, t)
        return x + site.conv(self.proj_out, a).reshape(b, c, hh, ww)


class UNet(nn.Module):
    """guided-diffusion's UNetModel with scale-shift norm, res-block
    up/down sampling and learned sigma (out_channels 6)."""

    def __init__(self, image_size: int = 256, in_channels: int = 3,
                 model_channels: int = 256, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 num_head_channels: int = 64, quant: int = 0, **_):
        super().__init__()
        self.quant = quant
        self.model_channels = model_channels
        self.calls: List[tuple] = []
        self.attention_calls: List[tuple] = []
        attn_ds = {image_size // r for r in attention_resolutions}
        emb_ch = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_ch),
                                        nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(in_channels, ch, 3, padding=1)])])
        skips, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(self, ch, mult * model_channels, emb_ch)]
                ch = mult * model_channels
                if ds in attn_ds:
                    layers.append(AttentionBlock(self, ch, num_head_channels))
                self.input_blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList(
                    [ResBlock(self, ch, ch, emb_ch, down=True)]))
                skips.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(self, ch, ch, emb_ch),
            AttentionBlock(self, ch, num_head_channels),
            ResBlock(self, ch, ch, emb_ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(self, ch + skips.pop(),
                                   mult * model_channels, emb_ch)]
                ch = mult * model_channels
                if ds in attn_ds:
                    layers.append(AttentionBlock(self, ch, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(self, ch, ch, emb_ch, up=True))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    def record(self, mod, x, w, is_site: bool, rows: Optional[int] = None):
        """Notes each product's call shape: (is_site, multiply-adds, M, N,
        K, kernel side, input elements).  Read by `flops`."""
        if isinstance(mod, nn.Linear):
            self.calls.append((is_site, rows * w.numel(), rows, w.shape[0],
                               w.shape[1], 1, rows * w.shape[1]))
            return
        k = w.shape[2] if w.dim() == 4 else 1
        stride = mod.stride[0]
        spatial = list(x.shape[2:])
        out_sp = [(s + 2 * mod.padding[0] - k) // stride + 1
                  for s in spatial]
        m = x.shape[0] * math.prod(out_sp)
        kk = w[0].numel()
        self.calls.append((is_site, m * w.shape[0] * kk, m, w.shape[0], kk,
                           k, x.numel()))

    def _run(self, mod, h, emb):
        if isinstance(mod, nn.Conv2d):
            return plain_conv(self, mod, h, padding=1)
        return mod(h, emb)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor
                ) -> torch.Tensor:
        self.calls, self.attention_calls = [], []
        t = timesteps.reshape(-1)
        emb = timestep_embedding(t, self.model_channels)
        l0, l2 = self.time_embed[0], self.time_embed[2]
        self.record(l0, None, l0.weight, False, rows=emb.shape[0])
        self.record(l2, None, l2.weight, False, rows=emb.shape[0])
        emb = F.linear(F.silu(F.linear(emb, l0.weight, l0.bias)),
                       l2.weight, l2.bias)
        h = x.permute(0, 3, 1, 2).float()
        hs = []
        for layers in self.input_blocks:
            for mod in layers:
                h = self._run(mod, h, emb)
            hs.append(h)
        for mod in self.middle_block:
            h = self._run(mod, h, emb)
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for mod in layers:
                h = self._run(mod, h, emb)
        h = F.silu(self.out[0](h))
        h = plain_conv(self, self.out[2], h, padding=1)
        return h.permute(0, 2, 3, 1)


def build(widths: dict, device="meta", quant: int = 0) -> UNet:
    """The UNet of a configuration's `unet` widths, its parameters empty
    on `device`."""
    with torch.device(device):
        return UNet(quant=quant, **widths)
