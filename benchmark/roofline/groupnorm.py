"""K5 (csrc/groupnorm.cu `gn_fused`): the least time of one fused
GroupNorm32, with the ResBlock's scale-shift and the SiLU where the site
has them, over x [B, S, C].

Bytes: x read once (the torso's bf16, 2 bytes an element), the output
written once at its dtype's bytes (bf16, fp32 at the head's norm, which
feeds the fp32 head conv), gamma and beta in fp32, and the scale-shift
[B, 2C] in fp32 at a ResBlock's out norm.  A handful of operations an
element leaves K5 far below the card's ridge: its bound is the bytes."""
from __future__ import annotations

from typing import List, Tuple

X_BYTES = 2


def sites(widths: dict, batch: int, res: int
          ) -> List[Tuple[int, int, int, int, bool]]:
    """(B, S, C, output bytes, scale-shift) of each GroupNorm of one forward
    of the UNet of `widths` at the sampler's batch, in order: the reference
    UNet (benchmark/reference/unet.py) run on the meta device, its norms'
    inputs recorded by forward hooks."""
    import torch
    from torch import nn

    from reference import unet as runet

    model = runet.build(widths, "meta")
    found = []

    def hook(name):
        def record(mod, args, out):
            x = args[0]
            found.append((x.shape[0], x[0, 0].numel(), x.shape[1],
                          4 if name == "out.0" else 2,
                          name.endswith("out_layers.0")))
        return record

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules()
               if isinstance(m, nn.GroupNorm)]
    try:
        model(torch.empty((batch, res, res, widths["in_channels"]),
                          device="meta"), torch.empty((1,), device="meta"))
    finally:
        for h in handles:
            h.remove()
    return found


def bytes_moved(b: int, s: int, c: int, out_bytes: int, ss: bool) -> float:
    return float(b * s * c * (X_BYTES + out_bytes) + 8 * c
                 + (8 * b * c if ss else 0))


def bound_s(norms, peaks) -> float:
    """Sum over `norms` [(B, S, C, output bytes, scale-shift)] of the time
    at the HBM bandwidth."""
    return sum(bytes_moved(*n) for n in norms) / peaks["hbm_bytes_per_s"]
