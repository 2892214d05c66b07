"""A network's weights, made on the device from the run's seed (the
DDNM network's UNet: benchmark/networks/ddnm.py).

One float32 draw from a CUDA generator covers every parameter, in the
order of the reference model's state dict, and each parameter is a slice
of it scaled in place: convolution and linear weights by fan_in^-1/2,
biases and norm shifts by 0.1, norm scales 1 + 0.1 N(0, 1).  No layer is
zero (the UNet's published initialisation zeroes the residual convs and
the output conv, which would make every noise estimate 0).  The same
seed on the same device gives the same bits, so the program and the
reference each get the weights made anew from it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def seed_of(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a purpose."""
    return (seed * 1_000_003 + salt) % (2 ** 63 - 1)


@torch.no_grad()
def make(shapes: Dict[str, torch.Size], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor for every entry of `shapes` (name -> shape, in
    order), float32 on `device`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 1))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        p = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            p.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif leaf == "weight":            # a GroupNorm's scale
            p.mul_(0.1).add_(1.0)
        else:                             # a bias or a norm's shift
            p.mul_(0.1)
        out[name] = p
    return out
