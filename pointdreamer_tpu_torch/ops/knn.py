"""Brute-force chunked k-nearest-neighbour search (twin of ops/knn.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis as elementwise multiply-adds in coordinate
    order: no reduction kernel, so the card and the CPU round alike and
    rank the same neighbours."""
    out = x[..., 0] * x[..., 0]
    for d in range(1, x.shape[-1]):
        out = out + x[..., d] * x[..., d]
    return out


def _cross(q: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """q . ref^T ([..., M, D] by [..., N, D]) in full fp32 whatever the
    TF32 switches say (the JAX package asks for Precision.HIGHEST:
    distance ranks are wrong in reduced precision), written out as
    broadcast multiply-adds over the 2 or 3 coordinates."""
    out = q[..., :1] * ref[..., None, :, 0]
    for d in range(1, q.shape[-1]):
        out = out + q[..., d:d + 1] * ref[..., None, :, d]
    return out


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        ref_valid: Optional[torch.Tensor] = None, chunk: int = 2048
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists [..., M, k], indices [..., M, k]) of the k nearest refs,
    from |q|^2 - 2 q.r + |r|^2 as the JAX package computes it (exact for
    the integer pixel coordinates of the edge augmentation).  Leading
    axes of `query` [..., M, D] and `ref` [..., N, D] are batch axes (one
    cloud each, as under the JAX package's vmap); `chunk` queries of
    every cloud are searched at a time."""
    k = min(k, ref.shape[-2])
    r2 = _sq_norm(ref)
    if ref_valid is not None:
        r2 = torch.where(ref_valid, r2, torch.full_like(r2, float("inf")))
    dists, idxs = [], []
    for q in torch.split(query, chunk, dim=-2):
        d2 = _sq_norm(q)[..., None] - 2.0 * _cross(q, ref) \
            + r2[..., None, :]
        if k == 1:
            idx = torch.argmin(d2, dim=-1, keepdim=True)
            dists.append(torch.gather(d2, -1, idx))
            idxs.append(idx)
        else:
            neg, idx = torch.topk(-d2, k, dim=-1)
            dists.append(-neg)
            idxs.append(idx)
    return torch.cat(dists, -2).clamp(min=0.0), torch.cat(idxs, -2)


def nearest(query: torch.Tensor, ref: torch.Tensor,
            ref_valid: Optional[torch.Tensor] = None, chunk: int = 2048):
    """1-NN: (sq_dists [M], indices [M])."""
    d, i = knn(query, ref, 1, ref_valid, chunk)
    return d[:, 0], i[:, 0]


def knn_2d_pixels(query_pix: torch.Tensor, ref_pix: torch.Tensor, k: int,
                  ref_valid: Optional[torch.Tensor] = None,
                  chunk: int = 1024):
    """kNN between 2D pixel sets (edge-pixel colour lookup)."""
    return knn(query_pix.float(), ref_pix.float(), k, ref_valid, chunk)
