"""FKAConv backbone + K-heads attention decoder (twin of
models/occupancy/fkaconv.py).

The reference POCO network:
  Convolution_FKAConv      lightconvpoint/nn/conv_fkaconv.py:9-145
  ResidualBlock            networks/backbone/fkaconv_network.py:13-43
  FKAConvNetwork (seg)     networks/backbone/fkaconv_network.py:45-238
  InterpAttentionKHeadsNet networks/decoder/interp_attention_Kheads.py:8-107

Modules mirror the JAX package's parameter tree: a module's attribute
names are the tree's keys (net.cv0.*, net.resnetb10.*, projection.fc1.*),
so `convert.state_from_tree` is a flatten.  Features are [B, N, C] (a
batch of clouds of one size, points, channels last): every 1x1 conv is an
`nn.Linear`, every gather indexes one cloud.  BatchNorm always uses its
running statistics, in training too, as the JAX trainer does (batch
statistics would mix the clouds of a batch).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS_BN = 1e-5
EPS_IN = 1e-5


def gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], ids [B, ...] -> [B, ..., C]: each cloud's rows."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows.view((-1,) + (1,) * (ids.dim() - 1)), ids]


class BatchNorm(nn.Module):
    """BatchNorm1d over the channel (last) axis with its running
    statistics (the JAX `batchnorm(train=False)`).  The statistics are
    parameters: the JAX trainer's parameter tree holds them, so its Adam
    steps move them by their gradient, and so do the port's."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.running_mean = nn.Parameter(torch.zeros(c))
        self.running_var = nn.Parameter(torch.ones(c))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + EPS_BN)
        return y * self.weight + self.bias


class InstanceNormGlobal(nn.Module):
    """torch InstanceNorm2d on one cloud's [1, C, M, k]: each channel
    normalized over all (M, k) positions of its own cloud (x [B, M, k, C])."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean((1, 2), keepdim=True)
        var = x.var((1, 2), keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + EPS_IN)
        return y * self.weight + self.bias


class _Kernel(nn.Module):
    """The (1, k) conv of an FKAConv: weight [O, I, k]."""

    def __init__(self, o: int, i: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(o, i, k))


class FKAConv(nn.Module):
    """Convolution_FKAConv, adaptive_normalization=True (reference
    conv_fkaconv.py:62-145)."""

    def __init__(self, in_c: int, out_c: int, k: int = 16):
        super().__init__()
        self.cv = _Kernel(out_c, in_c, k)
        self.norm_radius = nn.Parameter(torch.ones(1))
        self.alpha = nn.Parameter(torch.ones(1))
        self.beta = nn.Parameter(torch.ones(1))
        self.fc1 = nn.Linear(3, k, bias=False)
        self.fc2 = nn.Linear(2 * k, k, bias=False)
        self.fc3 = nn.Linear(2 * k, k, bias=False)
        self.bn1 = InstanceNormGlobal(k)
        self.bn2 = InstanceNormGlobal(k)

    def forward(self, x, pos, support, ids):
        """x [B, N, Cin], pos [B, N, 3], support [B, M, 3], ids [B, M, k]
        -> [B, M, Cout]."""
        pts = gather(pos, ids) - support[:, :, None, :]      # [B,M,k,3]
        xg = gather(x, ids)                                  # [B,M,k,Cin]

        distances = torch.sqrt((pts ** 2).sum(-1))           # [B,M,k]
        pts = pts / self.norm_radius

        dw = torch.sigmoid(-self.alpha * distances + self.beta)
        dws = dw.sum(-1, keepdim=True)
        dws = dws + (dws == 0) + 1e-6
        dw = (dw / dws * distances.shape[-1])[..., None]     # [B,M,k,1]

        mat = F.relu(self.bn1(self.fc1(pts)))
        mat = torch.cat([mat, (mat * dw).amax(2, keepdim=True)
                         .expand_as(mat)], -1)
        mat = F.relu(self.bn2(self.fc2(mat)))
        mat = torch.cat([mat, (mat * dw).amax(2, keepdim=True)
                         .expand_as(mat)], -1)
        mat = F.relu(self.fc3(mat)) * dw                     # [B,M,k,16]

        # x^T mat, then the (1, 16) conv: a double contraction
        inner = torch.einsum("bmkc,bmkj->bmcj", xg, mat)
        return torch.einsum("bmcj,ocj->bmo", inner, self.cv.weight)


def max_pool_nbr(x, ids):
    """Max over gathered neighbours (lightconvpoint nn/max_pooling.py)."""
    return gather(x, ids).amax(2)


def interpolate_nn(x, ids):
    """kNN-mean upsample (lightconvpoint nn/interpolation.py:16-34)."""
    return gather(x, ids).mean(2)


class ResidualBlock(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.cv0 = nn.Linear(i, i // 2)
        self.bn0 = BatchNorm(i // 2)
        self.cv1 = FKAConv(i // 2, i // 2)
        self.bn1 = BatchNorm(i // 2)
        self.cv2 = nn.Linear(i // 2, o)
        self.bn2 = BatchNorm(o)
        if i != o:
            self.shortcut = nn.Linear(i, o)
            self.bn_shortcut = BatchNorm(o)

    def forward(self, x, pos, support, ids):
        h = F.relu(self.bn0(self.cv0(x)))
        h = F.relu(self.bn1(self.cv1(h, pos, support, ids)))
        h = self.bn2(self.cv2(h))
        xs = (self.bn_shortcut(self.shortcut(x)) if hasattr(self, "shortcut")
              else x)
        if xs.shape[1] != h.shape[1]:
            xs = max_pool_nbr(xs, ids)
        return F.relu(h + xs)


class FKAConvNetwork(nn.Module):
    """The segmentation backbone (fkaconv_network.py:177-224): per-point
    latents [B, N, latent] from features x [B, N, in_channels] and the
    spatial dict of `spatial.compute_spatial`."""

    def __init__(self, in_channels: int = 3, hidden: int = 64,
                 latent: int = 32):
        super().__init__()
        h = hidden
        self.cv0 = FKAConv(in_channels, h)
        self.bn0 = BatchNorm(h)
        for name, i, o in (("resnetb01", h, h), ("resnetb10", h, 2 * h),
                           ("resnetb11", 2 * h, 2 * h),
                           ("resnetb20", 2 * h, 4 * h),
                           ("resnetb21", 4 * h, 4 * h),
                           ("resnetb30", 4 * h, 8 * h),
                           ("resnetb31", 8 * h, 8 * h),
                           ("resnetb40", 8 * h, 16 * h),
                           ("resnetb41", 16 * h, 16 * h)):
            setattr(self, name, ResidualBlock(i, o))
        for lvl, i, o in (("3", 24 * h, 8 * h), ("2", 12 * h, 4 * h),
                          ("1", 6 * h, 2 * h), ("0", 3 * h, h)):
            setattr(self, f"cv{lvl}d", nn.Linear(i, o))
            setattr(self, f"bn{lvl}d", BatchNorm(o))
        self.fcout = nn.Linear(h, latent)

    def forward(self, x, spatial: Dict[str, torch.Tensor]):
        pos = spatial["pos"]
        s1, s2, s3, s4 = (spatial["support1"], spatial["support2"],
                          spatial["support3"], spatial["support4"])

        x0 = F.relu(self.bn0(self.cv0(x, pos, pos, spatial["ids00"])))
        x0 = self.resnetb01(x0, pos, pos, spatial["ids00"])
        x1 = self.resnetb10(x0, pos, s1, spatial["ids01"])
        x1 = self.resnetb11(x1, s1, s1, spatial["ids11"])
        x2 = self.resnetb20(x1, s1, s2, spatial["ids12"])
        x2 = self.resnetb21(x2, s2, s2, spatial["ids22"])
        x3 = self.resnetb30(x2, s2, s3, spatial["ids23"])
        x3 = self.resnetb31(x3, s3, s3, spatial["ids33"])
        x4 = self.resnetb40(x3, s3, s4, spatial["ids34"])
        x4 = self.resnetb41(x4, s4, s4, spatial["ids44"])

        x3d = interpolate_nn(x4, spatial["ids43"])
        x3d = F.relu(self.bn3d(self.cv3d(torch.cat([x3d, x3], -1))))
        x2d = interpolate_nn(x3d, spatial["ids32"])
        x2d = F.relu(self.bn2d(self.cv2d(torch.cat([x2d, x2], -1))))
        x1d = interpolate_nn(x2d, spatial["ids21"])
        x1d = F.relu(self.bn1d(self.cv1d(torch.cat([x1d, x1], -1))))
        xout = interpolate_nn(x1d, spatial["ids10"])
        xout = F.relu(self.bn0d(self.cv0d(torch.cat([xout, x0], -1))))
        return self.fcout(xout)


class InterpAttentionKHeadsNet(nn.Module):
    """The default decoder (interp_attention_Kheads.py:59-107): logits
    [B, Q, n_labels] from latents [B, N, L], pos [B, N, 3], queries
    [B, Q, 3] and their K nearest points proj_indices [B, Q, K]."""

    def __init__(self, latent: int = 32, n_labels: int = 2, heads: int = 64):
        super().__init__()
        self.fc1 = nn.Linear(latent + 3, latent)
        self.fc2 = nn.Linear(latent, latent)
        self.fc3 = nn.Linear(latent, latent)
        self.fc8 = nn.Linear(latent, n_labels)
        self.fc_query = nn.Linear(latent, heads)
        self.fc_value = nn.Linear(latent, latent)

    def forward(self, latents, pos, queries, proj_indices):
        xg = gather(latents, proj_indices)                         # [B,Q,K,L]
        rel = queries[:, :, None, :] - gather(pos, proj_indices)   # [B,Q,K,3]
        h = F.relu(self.fc1(torch.cat([xg, rel], -1)))
        h = F.relu(self.fc2(h))
        h = F.relu(self.fc3(h))
        attn = torch.softmax(self.fc_query(h), dim=2).mean(-1)     # [B,Q,K]
        agg = torch.einsum("bqk,bqkl->bql", attn, self.fc_value(h))
        return self.fc8(agg)


def occupancy_field(logits: torch.Tensor) -> torch.Tensor:
    """2-class logits [..., 2] -> signed field [...], negative inside
    (reference generate.py:100-109 with class_dim=1)."""
    z = torch.softmax(torch.stack([logits[..., 1], logits[..., 0]], -1), -1)
    return z[..., 1] - z[..., 0]        # p(out) - p(in)
