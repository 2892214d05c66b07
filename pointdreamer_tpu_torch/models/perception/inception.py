"""InceptionV3 feature extractor, the FID embedding (twin of
models/perception/inception.py).

Reference counterpart: utils/metric_utils/inception.py (torchvision's
`inception_v3(pretrained=True)` cut at the final average pool, 2048-d
features) feeding utils/metric_utils/fid.py, used by
data/run_evaluation.py:174-215.

torchvision's Inception3 layout: every conv is BasicConv2d = Conv (no
bias) + BatchNorm (eps 1e-3, running statistics) + ReLU, with the module
names of torchvision's state dict (`Mixed_5b.branch1x1.conv.weight` ...).
The classifier and AuxLogits are left out (FID needs neither).  Pools as
torchvision's: max-pool 3x3 stride 2 with no padding, and the branches'
avg-pool 3x3 stride 1 padding 1 dividing by 9 (count_include_pad).

Input contract of the reference wrapper (inception.py:70-90): images
[N,H,W,3] in [0,1], resized to 299x299 by jax.image.resize's bilinear
(antialiased when it shrinks: `ops/image.py::resize_linear`, not
F.interpolate) and scaled to [-1,1].  fp32 throughout.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.image import resize_linear


class BasicConv2d(nn.Module):
    def __init__(self, in_c: int, out_c: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_c, eps=1e-3)

    def forward(self, x):
        bn = self.bn   # running statistics whatever the module's mode
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean,
                                   bn.running_var, bn.weight, bn.bias,
                                   False, 0.0, bn.eps))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _maxpool3(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_c: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_c, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_c, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_c, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_c, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_c, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_c, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_c: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_c, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_c, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_c, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_c, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_c, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_c, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          _maxpool3(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_c: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_c, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_c, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_c, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_c, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionV3Features(nn.Module):
    """torchvision Inception3 cut at the final average pool -> [N, 2048].

    forward: [N,H,W,3] in [0,1]; resized to 299 (`resize_input`) and
    scaled to [-1,1] (`normalize_input`) inside, as the reference wrapper
    does (inception.py:70-90)."""

    def __init__(self, resize_input: bool = True,
                 normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_linear(x, (299, 299), antialias=True)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3(x)))
        x = _maxpool3(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))          # global average pool -> 2048


def conv_shapes() -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """(name, (out, in, kh, kw)) of every BasicConv2d, sorted by name: the
    order in which the JAX package's random_inception_state_dict draws
    (its walk of the flax parameter tree, whose keys JAX flattens
    sorted).  Built on the meta device: nothing is allocated."""
    with torch.device("meta"):
        model = InceptionV3Features()
    return sorted((name, tuple(m.conv.weight.shape))
                  for name, m in model.named_modules()
                  if isinstance(m, BasicConv2d))
