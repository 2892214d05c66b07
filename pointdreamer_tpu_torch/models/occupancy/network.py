"""The POCO network: latent encoding, occupancy queries and the field the
geometry stage evaluates (twin of models/occupancy/network.py).

Reference: networks/network.py Network (get_latent/from_latent split) and
the PointDreamer facade generate_1.py POCO_get_geo (:70-290): per-point
latents averaged over random 3,000-point subsets that cover every point
`cover` times, then occupancy queries over a grid.

The subsets are drawn in the JAX package's order from its generator, so
both packages encode the same subsets; the port then encodes up to
`SUBSETS_PER_PASS` of them in one batched pass (FPS, kNN and the
backbone over a leading subset axis) where the JAX package jits one
subset at a time.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ...ops.knn import knn
from .alt import DECODERS
from .convert import state_from_tree
from .fkaconv import FKAConvNetwork, occupancy_field
from .spatial import compute_spatial

# subsets encoded in one batched pass: the default path's 10 covers of a
# 30,000-point cloud in 3,000-point subsets
SUBSETS_PER_PASS = 100


class Network(nn.Module):
    """FKAConv backbone (`net`) + a `DECODERS` decoder (`projection`)."""

    def __init__(self, hidden: int = 64, latent: int = 32, n_labels: int = 2,
                 decoder: str = "InterpAttentionKHeadsNet",
                 in_channels: int = 3):
        super().__init__()
        self.net = FKAConvNetwork(in_channels, hidden, latent)
        self.projection = DECODERS[decoder](latent, n_labels)

    def encode(self, pos: torch.Tensor) -> torch.Tensor:
        """Per-point latents [B, N, L] of clouds pos [B, N, 3], features
        all ones (reference generate_1.py:74 x=ones)."""
        return self.net(torch.ones_like(pos), compute_spatial(pos))


def network_from_tree(tree: Dict, decoder: str = "InterpAttentionKHeadsNet",
                      device="cuda") -> Network:
    """A `Network` on `device` holding a parameter tree's weights (widths
    read from the tree; the reference's unused net.cv5 / net.bn5 head is
    dropped)."""
    net = {k: v for k, v in tree["net"].items() if k not in ("cv5", "bn5")}
    proj = tree["projection"]
    cv0 = np.shape(net["cv0"]["cv"]["weight"])
    n_labels = np.shape(proj["fc8" if "fc8" in proj else "fc_out"]["weight"])
    with torch.device("meta"):
        model = Network(hidden=cv0[0], latent=np.shape(
            net["fcout"]["weight"])[0], n_labels=n_labels[0],
            decoder=decoder, in_channels=cv0[1])
    model = model.to_empty(device=device)
    model.load_state_dict(state_from_tree({"net": net, "projection": proj}))
    return model.eval()


def subset_indices(n: int, subsample: int, cover: int,
                   rng: np.random.Generator) -> np.ndarray:
    """The subsets [S, subsample] encode_latents encodes, drawn as the JAX
    package draws them: one padded subset when n <= subsample, else per
    cover a permutation of the cloud, padded by random indices to whole
    subsets."""
    if n <= subsample:
        return np.concatenate([np.arange(n), rng.integers(
            0, n, subsample - n)])[None].astype(np.int64)
    n_batches = -(-n // subsample)
    pad = n_batches * subsample - n
    subsets = []
    for _ in range(cover):
        perm = rng.permutation(n)
        if pad:
            perm = np.concatenate([perm, rng.integers(0, n, pad)])
        subsets.append(perm.reshape(n_batches, subsample))
    return np.concatenate(subsets).astype(np.int64)


@torch.no_grad()
def encode_latents(network: Network, points: torch.Tensor,
                   subsample: int = 3000, cover: int = 10,
                   rng: Optional[np.random.Generator] = None
                   ) -> torch.Tensor:
    """Per-point latents [N, L] averaged over `cover` coverages of random
    `subsample`-point subsets (generate_1.py:191-233,
    gen_subsample_manifold=3000, gen_subsample_manifold_iter=10).  The
    sums are `index_add_`s: on the card their order is the atomics'."""
    n = points.shape[0]
    rng = rng or np.random.default_rng(42)
    subsets = torch.as_tensor(subset_indices(n, subsample, cover, rng),
                              device=points.device)
    latent_sum = counts = None
    for g in range(0, len(subsets), SUBSETS_PER_PASS):
        idx = subsets[g:g + SUBSETS_PER_PASS]
        lat = network.encode(points[idx])
        if latent_sum is None:
            latent_sum = torch.zeros((n, lat.shape[-1]), device=points.device)
            counts = torch.zeros((n, 1), device=points.device)
        latent_sum.index_add_(0, idx.reshape(-1),
                              lat.reshape(-1, lat.shape[-1]))
        counts.index_add_(0, idx.reshape(-1),
                          torch.ones((idx.numel(), 1), device=points.device))
    return latent_sum / counts


@torch.no_grad()
def encode_latents_chunked(network: Network, points: torch.Tensor,
                           chunk: int = 100_000, cover: int = 3
                           ) -> torch.Tensor:
    """Big-cloud latent path (generate_1.py:119-156): until every point
    is covered `cover` times, take the first least-covered point, encode
    its `chunk` nearest neighbours (a spatially coherent patch) and
    accumulate (the reference's n_views=3; its random seed pick is the
    first argmin here, as in the JAX package)."""
    n = points.shape[0]
    pts_np = points.cpu().numpy()
    counts = np.zeros((n,), np.int32)
    latent_sum = None
    while counts.min() < cover:
        seed = int(np.flatnonzero(counts == counts.min())[0])
        d2 = ((pts_np - pts_np[seed]) ** 2).sum(-1)
        neigh = np.argpartition(d2, min(chunk, n) - 1)[:chunk]
        lat = network.encode(
            points[torch.as_tensor(neigh, device=points.device)][None])[0]
        if latent_sum is None:
            latent_sum = np.zeros((n, lat.shape[-1]), np.float32)
        latent_sum[neigh] += lat.cpu().numpy()
        counts[neigh] += 1
    return torch.as_tensor(latent_sum / counts[:, None],
                           device=points.device)


def autoscale_factor(points: np.ndarray, target: float = 0.01,
                     device="cuda") -> float:
    """Reference gen_autoscale (generate_1.py:101-110): the scale that
    makes the mean nearest-neighbour distance `target` (0.01, estimated
    on shapenet-3000)."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    d, _ = knn(pts, pts, 2)
    mean_dist = float(torch.sqrt(d[:, 1].clamp(min=0.0)).mean())
    return target / max(mean_dist, 1e-12)


@torch.no_grad()
def query_occupancy(network: Network, latents: torch.Tensor,
                    points: torch.Tensor, queries: torch.Tensor,
                    k: int = 64) -> torch.Tensor:
    """Signed occupancy [M] at queries [M, 3] (negative inside), through
    the network's decoder over each query's k nearest points."""
    _, proj = knn(queries, points, k)
    logits = network.projection(latents[None], points[None], queries[None],
                                proj[None])[0]
    return occupancy_field(logits)


def make_poco_field(network: Network, points, noise_std: float = 0.005,
                    rng: Optional[np.random.Generator] = None,
                    subsample: Optional[int] = 3000,
                    big_threshold: int = 100_000):
    """Returns the field [M, 3] -> [M] (tensors on the network's device)
    for pipeline.geometry (geo_from='POCO').

    Adds sigma = 0.005 noise to clean inputs like the reference
    (generate_1.py:71-72), encodes the latents once, then closes over
    them.  With subsample=None and more than `big_threshold` points it
    takes the chunked-neighbourhood latent path (generate_1.py:119-156).
    """
    rng = rng or np.random.default_rng(42)
    pts = np.asarray(points, np.float32)
    if noise_std:
        pts = pts + rng.normal(0, noise_std, pts.shape).astype(np.float32)
    pts = torch.as_tensor(pts, device=next(network.parameters()).device)
    if subsample is None and pts.shape[0] > big_threshold:
        latents = encode_latents_chunked(network, pts)
    else:
        latents = encode_latents(network, pts, subsample=subsample or 3000,
                                 rng=rng)

    def field(queries):
        return query_occupancy(network, latents, pts, queries)

    return field
