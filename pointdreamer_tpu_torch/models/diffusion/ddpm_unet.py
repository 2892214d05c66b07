"""The DDPM "simple" UNet of DDNM's CelebA-HQ / LSUN checkpoints (twin of
models/diffusion/ddpm_unet.py; reference models/DDNM/guided_diffusion/
models.py `Model`, :192-341).

Ho et al.'s architecture: swish, GroupNorm(32, eps 1e-6), ResnetBlocks
with an additive timestep projection, single-head self-attention at
`attn_resolutions`, a bottom/right zero pad before the stride-2 VALID
downsampling conv, nearest upsampling.  Its timestep embedding spaces the
frequencies by /(half - 1) and puts sin before cos, unlike the
guided-diffusion UNet's.

`DDPMUNet` is an `nn.Module` whose parameter names are the reference
`Model`'s (`temb.dense.0`, `down.{i}.block.{j}.conv1`, `mid.attn_1.q`,
`up.{i}.upsample.conv`, `norm_out`, ...), so its checkpoints load with
`load_state_dict`.  Everything computes in fp32 and takes x NHWC, as the
JAX package.  The attention is single-head with hd = C (512 at
`celeba_plan`), a head size K2 does not take: it stays `torch.matmul`
with fp32 logits, as the JAX package keeps it in einsums outside Pallas.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class DDPMPlan(NamedTuple):
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    resolution: int = 256
    resamp_with_conv: bool = True


def celeba_plan() -> DDPMPlan:
    """configs/celeba_hq.yml of the reference DDNM CLI."""
    return DDPMPlan()


def ddpm_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """models.py:6-24: frequencies spaced by /(half - 1), sin then cos."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _swish(x):
    return x * torch.sigmoid(x)


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, c), c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_ch: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb):
        h = self.conv1(_swish(self.norm1(x)))
        h = h + self.temb_proj(_swish(temb))[:, :, None, None]
        h = self.conv2(_swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, c, hh * ww).transpose(1, 2)     # [b, t, c]
        k = self.k(h).reshape(b, c, hh * ww)                     # [b, c, t]
        v = self.v(h).reshape(b, c, hh * ww).transpose(1, 2)
        w = torch.softmax(torch.matmul(q, k) * (c ** -0.5), dim=2)
        h = torch.matmul(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, c: int, with_conv: bool):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        if self.with_conv:                     # models.py:67-71
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    def __init__(self, c: int, with_conv: bool):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.with_conv else x


class _Level(nn.Module):
    """One resolution of the down or up path (`block`, `attn`, and
    `downsample` / `upsample`)."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class DDPMUNet(nn.Module):
    """The reference `Model` (models.py:192-341) on NHWC fp32 input."""

    def __init__(self, plan: DDPMPlan = DDPMPlan()):
        super().__init__()
        self.plan = plan
        ch, temb_ch = plan.ch, 4 * plan.ch
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch),
                                         nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(plan.in_channels, ch, 3, padding=1)
        n_lvl = len(plan.ch_mult)
        in_mult = (1,) + tuple(plan.ch_mult)
        curr_res = plan.resolution
        self.down = nn.ModuleList()
        block_in = ch
        for i in range(n_lvl):
            lvl = _Level()
            block_in = ch * in_mult[i]
            block_out = ch * plan.ch_mult[i]
            for _ in range(plan.num_res_blocks):
                lvl.block.append(ResnetBlock(block_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in plan.attn_resolutions:
                    lvl.attn.append(AttnBlock(block_in))
            if i != n_lvl - 1:
                lvl.downsample = Downsample(block_in, plan.resamp_with_conv)
                curr_res //= 2
            self.down.append(lvl)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch)
        up = []
        for i in reversed(range(n_lvl)):
            lvl = _Level()
            block_out = ch * plan.ch_mult[i]
            skip_in = ch * plan.ch_mult[i]
            for j in range(plan.num_res_blocks + 1):
                if j == plan.num_res_blocks:
                    skip_in = ch * in_mult[i]
                lvl.block.append(ResnetBlock(block_in + skip_in, block_out,
                                             temb_ch))
                block_in = block_out
                if curr_res in plan.attn_resolutions:
                    lvl.attn.append(AttnBlock(block_in))
            if i != 0:
                lvl.upsample = Upsample(block_in, plan.resamp_with_conv)
                curr_res *= 2
            up.insert(0, lvl)
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, plan.out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] NHWC, t [B] -> eps [B, H, W, out_ch] (models.py:
        301-341)."""
        plan = self.plan
        temb = ddpm_timestep_embedding(t, plan.ch)
        temb = self.temb.dense[1](_swish(self.temb.dense[0](temb)))
        hs = [self.conv_in(x.permute(0, 3, 1, 2).float())]
        n_lvl = len(plan.ch_mult)
        for i in range(n_lvl):
            lvl = self.down[i]
            for j in range(plan.num_res_blocks):
                h = lvl.block[j](hs[-1], temb)
                if len(lvl.attn):
                    h = lvl.attn[j](h)
                hs.append(h)
            if i != n_lvl - 1:
                hs.append(lvl.downsample(hs[-1]))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)),
                             temb)
        for i in reversed(range(n_lvl)):
            lvl = self.up[i]
            for j in range(plan.num_res_blocks + 1):
                h = lvl.block[j](torch.cat([h, hs.pop()], dim=1), temb)
                if len(lvl.attn):
                    h = lvl.attn[j](h)
            if i != 0:
                h = lvl.upsample(h)
        h = self.conv_out(_swish(self.norm_out(h)))
        return h.permute(0, 2, 3, 1)


def ddpm_params_from_jax(params: Dict) -> Dict[str, np.ndarray]:
    """The JAX package's flat DDPM dict (conv kernels HWIO, linear [I, O];
    `convert_ddpm_state_dict`'s output) -> the reference state dict (conv
    OIHW, linear [O, I])."""
    sd = {}
    for k, v in params.items():
        a = np.asarray(v, np.float32)
        if k.endswith(".weight") and a.ndim == 4:        # conv HWIO
            a = a.transpose(3, 2, 0, 1)
        elif k.endswith(".weight") and a.ndim == 2:      # linear
            a = a.T
        sd[k] = np.ascontiguousarray(a)
    return sd


@torch.no_grad()
def init_ddpm_(model: DDPMUNet, seed: int = 0) -> DDPMUNet:
    """Seeded random parameters drawn on the model's device (the
    counterpart of `init_ddpm_params`): convs and linears uniform in
    +-fan_in^-1/2 (weights and biases), norms at 1 and 0."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            for p in (mod.weight, mod.bias):
                p.copy_(torch.rand(p.shape, generator=gen, device=dev)
                        * (2 * bound) - bound)
    return model


def build_ddpm_unet(plan: DDPMPlan = DDPMPlan(), device="cuda",
                    seed: int = 0, checkpoint_path=None) -> DDPMUNet:
    """The DDPM UNet on `device` (fp32, eval mode): a reference checkpoint
    (`Model` state dict), else `init_ddpm_` from `seed`.  Built on the
    meta device first, so no host copy of the weights is made."""
    from ...pipeline.pipeline import resolve_device

    dev = resolve_device(device)
    with torch.device("meta"):
        model = DDPMUNet(plan)
    model = model.to_empty(device=dev)
    if checkpoint_path:
        model.load_state_dict(torch.load(checkpoint_path, map_location="cpu",
                                         weights_only=True))
    else:
        init_ddpm_(model, seed)
    return model.eval().requires_grad_(False)
