"""VGG16 feature extractor and the LPIPS perceptual distance (twin of
models/perception/vgg.py).

Reference counterpart: the `lpips` package as the texture evaluation uses
it (data/run_evaluation.py:18,141-171, `lpips.LPIPS(net='vgg')`): a
torchvision VGG16 torso tapped at relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, each tap unit-normalized over channels, squared difference,
learned non-negative 1x1 "lin" heads, spatial mean, summed over the taps.

Public tensors are channel-last [N, H, W, 3], as in the JAX package; the
convolutions run channel-first inside.  Parameter names follow
torchvision's `features.{i}` and lpips' `lin{k}.model.1.weight`, so the
published files load as they are (convert.py).  fp32 throughout.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision cfg 'D': conv channel plan, 'M' = 2x2 maxpool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
# conv indices (0-based, in conv order) after whose ReLU LPIPS taps
LPIPS_TAPS = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

# lpips ScalingLayer constants (lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 convolutional torso; returns the 5 LPIPS tap activations.

    `features` is torchvision's nn.Sequential layout (conv at index i,
    ReLU at i + 1, max-pool where the plan says 'M')."""

    def __init__(self):
        super().__init__()
        layers, in_c = [], 3
        for item in VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_c, item, 3, padding=1),
                           nn.ReLU(inplace=False)]
                in_c = item
        self.features = nn.Sequential(*layers)
        ci, tap_after = 0, []
        for i, layer in enumerate(layers):
            if isinstance(layer, nn.Conv2d):
                if ci in LPIPS_TAPS:
                    tap_after.append(i + 1)
                ci += 1
        self.tap_after = tuple(tap_after)

    def taps_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.tap_after:
                out.append(x)
            if i == self.tap_after[-1]:
                break
        return tuple(out)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[N,H,W,3] -> the 5 taps, each [N,h,w,C] (channel-last)."""
        return tuple(t.permute(0, 2, 3, 1)
                     for t in self.taps_nchw(x.permute(0, 3, 1, 2)))


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips normalize_tensor: unit L2 norm over the channel axis (NCHW)."""
    norm = torch.sqrt((feat * feat).sum(1, keepdim=True))
    return feat / (norm + eps)


class LPIPS(nn.Module):
    """LPIPS(net='vgg') distance.  forward(a, b): images [N,H,W,3] in
    [-1, 1] (the reference feeds `pred*2-1`, run_evaluation.py:157) ->
    [N] distances.  Parameters: `vgg` and the heads `lin{k}` (1x1, no
    bias)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for k, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = a.shape[0]
        x = torch.cat([a, b]).permute(0, 3, 1, 2)
        taps = self.vgg.taps_nchw((x - self.shift) / self.scale)
        total = 0.0
        for k, t in enumerate(taps):
            d = (_unit_normalize(t[:n]) - _unit_normalize(t[n:])) ** 2
            w = F.conv2d(d, getattr(self, f"lin{k}").weight)   # [N,1,h,w]
            total = total + w.mean(dim=(2, 3))[:, 0]
        return total
