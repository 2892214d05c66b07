"""Point-cloud training transforms (twin of
models/occupancy/transforms.py, the same numpy draws).

Reference: models/POCO/lightconvpoint/utils/transforms.py (FixedPoints,
RandomRotate, RandomNoiseNormal, Permutation, Compose and friends) — the
augmentations the reference wires into its occupancy-training datasets.

Here a transform is a callable `(pts, queries, occ, rng) -> (pts,
queries, occ)` over one sample: host-side numpy (augmentation runs on
the data path, not in the train step), applied by the dataset
`batches(..., transform=...)` iterators.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

Sample = Tuple[np.ndarray, np.ndarray, np.ndarray]


class Compose:
    """Apply transforms in order (reference transforms.py Compose)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, pts, queries, occ, rng):
        for t in self.transforms:
            pts, queries, occ = t(pts, queries, occ, rng)
        return pts, queries, occ


class FixedPoints:
    """Random fixed-size subsample of the input points (reference
    FixedPoints; replace=False when enough points exist)."""

    def __init__(self, num: int):
        self.num = num

    def __call__(self, pts, queries, occ, rng):
        idx = rng.choice(len(pts), self.num, replace=len(pts) < self.num)
        return pts[idx], queries, occ


class RandomRotate:
    """Random rotation about one axis, degrees in [-d, d] (reference
    RandomRotate). Rotates input points AND occupancy queries together so
    labels stay valid."""

    def __init__(self, degrees: float = 180.0, axis: int = 2):
        self.degrees = degrees
        self.axis = axis

    def __call__(self, pts, queries, occ, rng):
        a = np.radians(rng.uniform(-self.degrees, self.degrees))
        c, s = np.cos(a), np.sin(a)
        i, j = [k for k in range(3) if k != self.axis]
        R = np.eye(3, dtype=np.float32)
        R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
        return pts @ R.T, queries @ R.T, occ


class RandomNoiseNormal:
    """Gaussian jitter on the input points only (reference
    RandomNoiseNormal, the sigma=0.005 training-noise counterpart of
    generate_1.py:71-72)."""

    def __init__(self, sigma: float = 0.005):
        self.sigma = sigma

    def __call__(self, pts, queries, occ, rng):
        return (pts + rng.normal(0.0, self.sigma, pts.shape)
                .astype(pts.dtype), queries, occ)


class RandomScaleAniso:
    """Per-axis random scale (reference RandomScaleAniso)."""

    def __init__(self, lo: float = 0.9, hi: float = 1.1):
        self.lo, self.hi = lo, hi

    def __call__(self, pts, queries, occ, rng):
        s = rng.uniform(self.lo, self.hi, (1, 3)).astype(np.float32)
        return pts * s, queries * s, occ


class Permutation:
    """Random permutation of the point order (reference Permutation —
    breaks any ordering the sampler could latch onto)."""

    def __call__(self, pts, queries, occ, rng):
        return pts[rng.permutation(len(pts))], queries, occ


def default_train_transform(n_points: Optional[int] = None,
                            noise_sigma: float = 0.005) -> Compose:
    """The reference's standard training stack: subsample, jitter,
    rotate about gravity, shuffle."""
    ts = []
    if n_points:
        ts.append(FixedPoints(n_points))
    ts += [RandomNoiseNormal(noise_sigma), RandomRotate(180.0, 2),
           Permutation()]
    return Compose(ts)
