"""DDNM's inpainting step (Wang et al., "Zero-Shot Image Restoration Using
Denoising Diffusion Null-Space Model", ICLR 2023; PointDreamer's
models/DDNM, diffusion.py), written again in plain PyTorch.

With A the mask of known pixels and y = A(2 * img - 1):
  x0_t   = (x_t - e_t sqrt(1 - a_t)) / sqrt(a_t)
  x0_hat = x0_t - (A(x0_t) - y)
  x_next = sqrt(a_next) x0_hat + sigma (c1 z + c2 e_t),
  sigma  = sqrt(1 - a_next^2)   (the reference code's square),
  c1 = sqrt(1 - a_next) eta,  c2 = sqrt(1 - a_next) sqrt(1 - eta^2)
over linear betas from 1e-4 to 0.02, the 1000-step schedule walked in
`steps` equal jumps; a_next = 1 after the last step.  The draws: x_T and
then one z a step, all from one CUDA generator seeded with `seed`.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def schedule(steps: int, num_timesteps: int = 1000):
    """(t of each step, a_t, a_next), t counting down from the top."""
    skip = num_timesteps // steps
    ts = np.arange(steps - 1, -1, -1, dtype=np.int64) * skip
    nxt = np.concatenate([ts[1:], [-1]])
    betas = np.linspace(1e-4, 0.02, num_timesteps, dtype=np.float64)
    abar = np.concatenate([[1.0], np.cumprod(1.0 - betas)])
    return ts, abar[ts + 1], abar[nxt + 1]


def draws(shape, steps: int, seed: int, device) -> List[torch.Tensor]:
    """x_T and the `steps` z's, in the order the sampler draws them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) for _ in range(steps + 1)]


def step(x, eps, z, img, mask, a_t: float, a_next: float, eta: float,
         dtype=torch.float64) -> torch.Tensor:
    """One step in `dtype` (float64: the reference; a lower one: the
    control).  img [B,H,W,3] in [0,1], mask [B,H,W,1] with 1 = known."""
    x, eps, z, img, mask = (v.to(dtype) for v in (x, eps, z, img, mask))
    y = (img * 2.0 - 1.0) * mask
    x0 = (x - eps * (1.0 - a_t) ** 0.5) / a_t ** 0.5
    x0_hat = x0 - (x0 * mask - y)
    sigma = (1.0 - a_next ** 2) ** 0.5
    c1 = (1.0 - a_next) ** 0.5 * eta
    c2 = (1.0 - a_next) ** 0.5 * (1.0 - eta ** 2) ** 0.5
    return (a_next ** 0.5 * x0_hat + sigma * (c1 * z + c2 * eps)).to(dtype)


def image(x: torch.Tensor) -> torch.Tensor:
    """The sampler's last state as an image in [0, 1]."""
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0)
