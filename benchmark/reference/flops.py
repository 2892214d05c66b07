"""Operations of one UNet forward, counted at the calls it makes (a
frozen copy of the program's `profile_unet.count_flops` rule): 2 per
multiply-add of every convolution and linear layer, and 4 B T^2 C for
the two products of each attention call.  Found by running the
reference UNet on the meta device, so nothing is computed."""
from __future__ import annotations

from typing import Dict

import torch

from . import unet as runet


def forward_calls(widths: dict, batch: int, res: int) -> Dict[str, object]:
    """{'convs': [(is_int8_site, multiply-adds, M, N, K, kernel side,
    input elements)], 'attention': [(B, heads, T, head channels)],
    'float_ops', 'site_ops'}: the site convolutions are those a w8a8 UNet
    computes in int8; the timestep is one row, as the sampler passes it."""
    model = runet.build(widths, "meta")
    x = torch.empty((batch, res, res, widths["in_channels"]), device="meta")
    model(x, torch.empty((1,), device="meta"))
    site = sum(2.0 * c[1] for c in model.calls if c[0])
    plain = sum(2.0 * c[1] for c in model.calls if not c[0])
    attn = sum(4.0 * b * h * t * t * d for b, h, t, d in model.attention_calls)
    return {"convs": list(model.calls), "attention":
            list(model.attention_calls), "float_ops": plain + attn,
            "site_ops": site}
