"""Spatial precomputation of the occupancy network (twin of
models/occupancy/spatial.py): the four-level point pyramid by farthest
point sampling and its 13 kNN graphs.

Every function takes clouds with a leading batch axis ([B, N, 3]), all of
one size: the JAX package gets that axis from `jax.vmap`, and the port
runs the ~1,000 dependent FPS steps of a 3,000-point subset once for all
subsets of an encode instead of once a subset.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...ops.knn import knn

# the distance tiles of one kNN call stay under this many elements
KNN_TILE = 1 << 25


def farthest_point_sampling(points: torch.Tensor,
                            n_support: int) -> torch.Tensor:
    """[B, N, 3] -> indices [B, n_support] by FPS, seeded at point 0 and
    taking the first maximum on ties: the JAX package's scan, step for
    step, for every cloud at once."""
    b, n, _ = points.shape
    mind = torch.full((b, n), float("inf"), device=points.device)
    last = torch.zeros(b, dtype=torch.long, device=points.device)
    picked = []
    for _ in range(n_support):
        picked.append(last)
        diff = points - torch.gather(points, 1,
                                     last[:, None, None].expand(b, 1, 3))
        sq = diff * diff
        mind = torch.minimum(mind, sq[..., 0] + sq[..., 1] + sq[..., 2])
        last = torch.argmax(mind, dim=1)
    return torch.stack(picked, 1)


def quantized_sampling(points, n_support: int, seed: int = 0) -> np.ndarray:
    """Host port of the reference's quantized-voxel sampling
    (lightconvpoint sampling_quantized.py:10-75) for one cloud [N, 3]:
    random rotation, voxel clustering at size bbox_diag/sqrt(n), one point
    per occupied voxel, repeated on the remainder until n_support points
    are picked.  Tests compare its occupancy output with the FPS default;
    FPS stays the production sampler."""
    pts_all = np.asarray(points)
    n = pts_all.shape[0]
    if n_support >= n:
        return np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(seed)
    diag = np.linalg.norm(pts_all.max(0) - pts_all.min(0))
    vox = diag / np.sqrt(n_support)
    ids = np.arange(n)
    pts = pts_all
    sampled = []
    count = 0
    while True:
        angs = rng.uniform(-np.pi, np.pi, 3)
        rots = []
        for ax, a in enumerate(angs):
            c, s = np.cos(a), np.sin(a)
            m = np.eye(3)
            i, j = [(1, 2), (0, 2), (0, 1)][ax]
            m[i, i] = c; m[i, j] = -s; m[j, i] = s; m[j, j] = c
            rots.append(m)
        r = rots[2] @ rots[1] @ rots[0]
        rp = pts @ r.T
        keys = np.floor((rp - rp.min(0)) / vox).astype(np.int64)
        flat = (keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663
                ^ keys[:, 2] * 83492791)
        _, perm = np.unique(flat, return_index=True)
        if count + len(perm) < n_support:
            sampled.append(ids[perm])
            count += len(perm)
            keep = np.ones(len(ids), bool)
            keep[perm] = False
            ids = ids[keep]
            pts = pts[keep]
        else:
            pick = rng.permutation(len(perm))[: n_support - count]
            sampled.append(ids[perm[pick]])
            break
    return np.concatenate(sampled).astype(np.int32)


def knn_ids(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, M, min(k, N)] of each query's nearest refs, cloud by
    cloud ([B, M, 3] against [B, N, 3])."""
    chunk = max(1, KNN_TILE // (query.shape[0] * ref.shape[1]))
    return knn(query, ref, min(k, ref.shape[1]), chunk=chunk)[1]


def compute_spatial(pos: torch.Tensor,
                    decoder_queries: Optional[torch.Tensor] = None,
                    decoder_k: int = 64,
                    sampler: Optional[Callable] = None
                    ) -> Dict[str, torch.Tensor]:
    """pos [B, N, 3] -> the reference's spatial keys: support1..4,
    ids00..ids44, ids43..ids10 (+ proj_indices [B, Q, k] for queries
    [B, Q, 3]).  Level sizes are ceil(n/4) four times.  `sampler`:
    (points [B, n, 3], m) -> indices [B, m]; FPS by default."""
    n = pos.shape[1]
    sizes = [max(1, -(-n // 4))]
    for _ in range(3):
        sizes.append(max(1, -(-sizes[-1] // 4)))
    sampler = sampler or farthest_point_sampling

    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    out = {"pos": pos}
    supports = [pos]
    for lvl, m in enumerate(sizes, start=1):
        sup = supports[-1][rows, sampler(supports[-1], m)]
        out[f"support{lvl}"] = sup
        supports.append(sup)

    p, s1, s2, s3, s4 = supports
    for key, src, dst, k in (
            ("ids00", p, p, 16), ("ids01", p, s1, 16), ("ids11", s1, s1, 16),
            ("ids12", s1, s2, 16), ("ids22", s2, s2, 16),
            ("ids23", s2, s3, 16), ("ids33", s3, s3, 16),
            ("ids34", s3, s4, 16), ("ids44", s4, s4, 16),
            ("ids43", s4, s3, 1), ("ids32", s3, s2, 1), ("ids21", s2, s1, 1),
            ("ids10", s1, p, 1)):
        out[key] = knn_ids(dst, src, k)
    if decoder_queries is not None:
        out["proj_indices"] = knn_ids(decoder_queries, p, decoder_k)
    return out
