"""Synthetic image family for self-contained DDNM training (twin of
models/diffusion/synthetic_images.py): smooth two-colour gradients, soft
sinusoidal stripes toward a third colour, and three soft-edged circles.

The randomness is split from the image math: `images_from_draws` takes the
ten draws the JAX function makes, so a test can feed both packages the
same numbers; `sample_images` draws them with a `torch.Generator` on the
device, so training makes every batch on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_CIRCLES = 3


class ImageDraws(NamedTuple):
    """The draws of one batch, in the JAX function's order and ranges."""
    c0: torch.Tensor     # [B,1,1,3]  U[0,1)
    c1: torch.Tensor     # [B,1,1,3]  U[0,1)
    ang: torch.Tensor    # [B]        U[0,2pi)
    f: torch.Tensor      # [B,1,1]    U[1,4)
    ph: torch.Tensor     # [B,1,1]    U[0,2pi)
    sc: torch.Tensor     # [B,1,1,3]  U[0,1)
    w: torch.Tensor      # [B,1,1,1]  U[0,0.45)
    ctr: torch.Tensor    # [B,3,2]    U[0.15,0.85)
    rad: torch.Tensor    # [B,3]      U[0.08,0.25)
    col: torch.Tensor    # [B,3,3]    U[0,1)


def _linspace01(res: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, res) as JAX computes it: iota / (res - 1), then
    the end point."""
    if res == 1:
        return torch.zeros(1, device=device)
    return torch.cat([torch.arange(res - 1, dtype=torch.float32,
                                   device=device) / float(res - 1),
                      torch.ones(1, device=device)])


def images_from_draws(draws: ImageDraws, res: int) -> torch.Tensor:
    """[B, res, res, 3] in [0, 1], on the draws' device."""
    c0, c1, ang, f, ph, sc, w, ctr, rad, col = draws
    dev = c0.device
    lin = _linspace01(res, dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    pos = torch.stack([xx, yy], -1)                          # [R,R,2]

    d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)    # [B,2]
    t = torch.einsum("rcx,bx->brc", pos, d)
    tmin = t.amin(dim=(1, 2), keepdim=True)
    tmax = t.amax(dim=(1, 2), keepdim=True)
    t = (t - tmin) / (tmax - tmin + 1e-6)
    img = c0 + (c1 - c0) * t[..., None]                      # [B,R,R,3]

    s = 0.5 + 0.5 * torch.sin(2.0 * math.pi * f * t + ph)
    img = img * (1 - w * s[..., None]) + sc * (w * s[..., None])

    for i in range(N_CIRCLES):
        dist = torch.linalg.vector_norm(
            pos[None] - ctr[:, None, None, i], dim=-1)
        m = torch.sigmoid((rad[:, None, None, i] - dist) * 60.0)[..., None]
        img = img * (1 - m) + col[:, None, None, i] * m
    return img.clamp(0.0, 1.0)


def draw_images(generator: torch.Generator, batch: int,
                device) -> ImageDraws:
    def u(shape, lo=0.0, hi=1.0):
        r = torch.rand(shape, generator=generator, device=device)
        return r * (hi - lo) + lo

    two_pi = 2.0 * math.pi
    return ImageDraws(
        c0=u((batch, 1, 1, 3)), c1=u((batch, 1, 1, 3)),
        ang=u((batch,), 0.0, two_pi), f=u((batch, 1, 1), 1.0, 4.0),
        ph=u((batch, 1, 1), 0.0, two_pi), sc=u((batch, 1, 1, 3)),
        w=u((batch, 1, 1, 1), 0.0, 0.45),
        ctr=u((batch, N_CIRCLES, 2), 0.15, 0.85),
        rad=u((batch, N_CIRCLES), 0.08, 0.25),
        col=u((batch, N_CIRCLES, 3)))


def sample_images(generator: torch.Generator, batch: int, res: int = 32,
                  device=None) -> torch.Tensor:
    """[B, res, res, 3] in [0, 1], drawn on `device` (the generator's
    device by default)."""
    device = generator.device if device is None else device
    return images_from_draws(draw_images(generator, batch, device), res)
