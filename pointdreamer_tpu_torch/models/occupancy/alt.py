"""The other POCO decoders and the PointNet backbone (twin of
models/occupancy/alt.py), selected by the reference's network_decoder /
network_backbone config keys (generate.py:304-305).

Reference: networks/decoder/{interp_attention,interp_mean,interp_max,
interp_inv_dist,interp_mean_prefix,interp_inv_dist_prefix}.py and
networks/backbone/pointnet.py.  Every decoder takes (latents [B, N, L],
pos [B, N, 3], queries [B, Q, 3], proj_indices [B, Q, K]) and returns
logits [B, Q, n_labels], as `fkaconv.InterpAttentionKHeadsNet` does.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .fkaconv import InterpAttentionKHeadsNet, gather


def _gather(latents, pos, queries, proj_indices):
    xg = gather(latents, proj_indices)                         # [B,Q,K,L]
    rel = queries[:, :, None, :] - gather(pos, proj_indices)   # [B,Q,K,3]
    return xg, rel


def _inv_dist(rel):
    """Inverse distances over K, clamped at 1e-7."""
    return 1.0 / torch.linalg.norm(rel, dim=-1).clamp(min=1e-7)


class _InterpMLP(nn.Module):
    """fc_in -> (relu -> mlp_i) x 2 -> ... -> fc_out: the trunk the
    interp_* decoders share (interp_mean.py:22-26)."""

    def __init__(self, latent: int = 32, n_labels: int = 2):
        super().__init__()
        self.fc_in = nn.Linear(latent + 3, latent)
        self.mlp_0 = nn.Linear(latent, latent)
        self.mlp_1 = nn.Linear(latent, latent)
        self.fc_out = nn.Linear(latent, n_labels)

    def mlp(self, h):
        h = self.fc_in(h)
        h = self.mlp_0(F.relu(h))
        return self.mlp_1(F.relu(h))


class InterpMeanNet(_InterpMLP):
    """Per-neighbour MLP, mean over K, fc_out (interp_mean.py:110-121)."""

    def forward(self, latents, pos, queries, proj_indices):
        xg, rel = _gather(latents, pos, queries, proj_indices)
        return self.fc_out(self.mlp(torch.cat([xg, rel], -1)).mean(2))


class InterpMaxNet(_InterpMLP):
    """Max over K (interp_max.py:89-94)."""

    def forward(self, latents, pos, queries, proj_indices):
        xg, rel = _gather(latents, pos, queries, proj_indices)
        return self.fc_out(self.mlp(torch.cat([xg, rel], -1)).amax(2))


class InterpInvDistNet(_InterpMLP):
    """Inverse-distance weighted pool over K (interp_inv_dist.py:89-98)."""

    def forward(self, latents, pos, queries, proj_indices):
        xg, rel = _gather(latents, pos, queries, proj_indices)
        h = self.mlp(torch.cat([xg, rel], -1))
        w = _inv_dist(rel)
        agg = (h * w[..., None]).sum(2) / w.sum(2)[..., None]
        return self.fc_out(agg)


class InterpMeanPrefixNet(_InterpMLP):
    """Latents and relative positions pooled over K first, then the MLP
    (interp_mean_prefix.py:88-97)."""

    def forward(self, latents, pos, queries, proj_indices):
        xg, rel = _gather(latents, pos, queries, proj_indices)
        h = torch.cat([xg.mean(2), rel.mean(2)], -1)
        return self.fc_out(self.mlp(h))


class InterpInvDistPrefixNet(_InterpMLP):
    """Inverse-distance pool first, then the MLP
    (interp_inv_dist_prefix.py:88-100)."""

    def forward(self, latents, pos, queries, proj_indices):
        xg, rel = _gather(latents, pos, queries, proj_indices)
        w = _inv_dist(rel)
        wn = (w / w.sum(2, keepdim=True))[..., None]
        h = torch.cat([(xg * wn).sum(2), (rel * wn).sum(2)], -1)
        return self.fc_out(self.mlp(h))


class InterpAttentionNet(nn.Module):
    """The single-head attention decoder (interp_attention.py:68-98):
    scalar query logits softmaxed over K weight the values."""

    def __init__(self, latent: int = 32, n_labels: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(latent + 3, latent)
        self.fc2 = nn.Linear(latent, latent)
        self.fc3 = nn.Linear(latent, latent)
        self.fc_query = nn.Linear(latent, 1)
        self.fc_value = nn.Linear(latent, latent)
        self.fc8 = nn.Linear(latent, n_labels)

    def forward(self, latents, pos, queries, proj_indices):
        xg, rel = _gather(latents, pos, queries, proj_indices)
        h = F.relu(self.fc1(torch.cat([xg, rel], -1)))
        h = F.relu(self.fc2(h))
        h = F.relu(self.fc3(h))
        attn = torch.softmax(self.fc_query(h)[..., 0], dim=-1)    # [B,Q,K]
        agg = torch.einsum("bqk,bqkl->bql", attn, self.fc_value(h))
        return self.fc8(agg)


DECODERS = {
    "InterpAttentionKHeadsNet": InterpAttentionKHeadsNet,   # the default
    "InterpAttentionNet": InterpAttentionNet,
    "InterpMeanNet": InterpMeanNet,
    "InterpMaxNet": InterpMaxNet,
    "InterpInvDistNet": InterpInvDistNet,
    "InterpMeanPrefixNet": InterpMeanPrefixNet,
    "InterpInvDistPrefixNet": InterpInvDistPrefixNet,
}


class PointNet(nn.Module):
    """PointNet segmentation backbone (pointnet.py:32-66, as POCO uses
    it): fc_in, then 3 rounds of (relu -> conv -> concat the cloud's
    max), fc_3, a last concat and fc_out.  x [B, N, C] with spatial['pos']
    [B, N, 3] -> per-point latents [B, N, out_channels]."""

    def __init__(self, in_channels: int = 3, out_channels: int = 32,
                 hidden: int = 128):
        super().__init__()
        self.fc_in = nn.Linear(in_channels + 3, 2 * hidden)
        for i in range(3):
            setattr(self, f"mlp_{i}", nn.Linear(2 * hidden, hidden))
        self.fc_3 = nn.Linear(2 * hidden, hidden)
        self.fc_out = nn.Linear(2 * hidden, out_channels)

    def forward(self, x, spatial: Dict[str, torch.Tensor]):
        def with_max(h):
            return torch.cat([h, h.amax(1, keepdim=True).expand_as(h)], -1)

        h = self.fc_in(torch.cat([x, spatial["pos"]], -1))
        for i in range(3):
            h = with_max(getattr(self, f"mlp_{i}")(F.relu(h)))
        return self.fc_out(with_max(self.fc_3(F.relu(h))))


# --------------------------------------------------------------------------
# torch state-dict converters + random init (numpy trees, the JAX layout)
# --------------------------------------------------------------------------

def _conv_entry(sd, name):
    def arr(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v)

    w = arr(sd[name + ".weight"])
    w = w.reshape(w.shape[0], w.shape[1])      # Conv1d/2d 1x1 -> [O, I]
    return {"weight": w.astype(np.float32),
            "bias": arr(sd[name + ".bias"]).astype(np.float32)}


def convert_decoder_state_dict(sd: Dict, decoder: str) -> Dict:
    """A reference decoder's torch state dict -> its parameter tree."""
    if decoder in ("InterpAttentionNet",):
        return {k: _conv_entry(sd, k)
                for k in ["fc1", "fc2", "fc3", "fc_query", "fc_value",
                          "fc8"]}
    p = {"fc_in": _conv_entry(sd, "fc_in"),
         "fc_out": _conv_entry(sd, "fc_out")}
    for i in range(2):
        p[f"mlp_{i}"] = _conv_entry(sd, f"mlp_layers.{i}")
    return p


def convert_pointnet_state_dict(sd: Dict) -> Dict:
    p = {"fc_in": _conv_entry(sd, "fc_in"),
         "fc_3": _conv_entry(sd, "fc_3"),
         "fc_out": _conv_entry(sd, "fc_out")}
    for i in range(3):
        p[f"mlp_{i}"] = _conv_entry(sd, f"mlp_layers.{i}")
    return p


def _rand_lin(rng, o, i):
    b = 1.0 / math.sqrt(i)
    return {"weight": rng.uniform(-b, b, (o, i)).astype(np.float32),
            "bias": rng.uniform(-b, b, (o,)).astype(np.float32)}


def init_alt_decoder_params(decoder: str, seed: int = 0, latent: int = 32,
                            n_labels: int = 2) -> Dict:
    rng = np.random.default_rng(seed)
    if decoder == "InterpAttentionNet":
        return {"fc1": _rand_lin(rng, latent, latent + 3),
                "fc2": _rand_lin(rng, latent, latent),
                "fc3": _rand_lin(rng, latent, latent),
                "fc_query": _rand_lin(rng, 1, latent),
                "fc_value": _rand_lin(rng, latent, latent),
                "fc8": _rand_lin(rng, n_labels, latent)}
    return {"fc_in": _rand_lin(rng, latent, latent + 3),
            "mlp_0": _rand_lin(rng, latent, latent),
            "mlp_1": _rand_lin(rng, latent, latent),
            "fc_out": _rand_lin(rng, n_labels, latent)}


def init_pointnet_params(seed: int = 0, in_channels: int = 3,
                         out_channels: int = 32,
                         hidden: int = 128) -> Dict:
    rng = np.random.default_rng(seed)
    return {"fc_in": _rand_lin(rng, 2 * hidden, in_channels + 3),
            "mlp_0": _rand_lin(rng, hidden, 2 * hidden),
            "mlp_1": _rand_lin(rng, hidden, 2 * hidden),
            "mlp_2": _rand_lin(rng, hidden, 2 * hidden),
            "fc_3": _rand_lin(rng, hidden, 2 * hidden),
            "fc_out": _rand_lin(rng, out_channels, 2 * hidden)}
