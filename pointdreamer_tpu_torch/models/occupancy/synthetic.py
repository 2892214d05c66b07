"""Synthetic occupancy shapes (twin of models/occupancy/synthetic.py,
the same numpy draws): analytic SDF family for self-contained POCO
training (the offline stand-in for the ShapeNet occupancy data of
models/POCO/datasets/shapenet.py — no reference checkpoint ships, so the
learned geometry path is proven end-to-end on shapes we can label
exactly: spheres, boxes, tori under random rigid motion).

Each sample provides what the POCO training loop consumes
(train.py / reference models/POCO/train.py:160-247):
  - a surface point cloud (the network input),
  - query points (uniform + near-surface, the POCO recipe),
  - exact occupancy labels from the analytic SDF.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _rand_rotation(rng) -> np.ndarray:
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class Shape:
    """One analytic shape: local-frame SDF + surface sampler + rigid pose."""

    def __init__(self, kind: str, params: Dict, R: np.ndarray,
                 t: np.ndarray):
        self.kind, self.params, self.R, self.t = kind, params, R, t

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        """pts [M,3] world -> signed distance (negative inside)."""
        p = (pts - self.t) @ self.R          # world -> local (R orthonormal)
        k = self.params
        if self.kind == "sphere":
            return np.linalg.norm(p, axis=-1) - k["r"]
        if self.kind == "box":
            d = np.abs(p) - k["half"]
            outside = np.linalg.norm(np.maximum(d, 0), axis=-1)
            inside = np.minimum(d.max(-1), 0)
            return outside + inside
        if self.kind == "torus":
            q = np.stack([np.linalg.norm(p[:, :2], axis=-1) - k["R"],
                          p[:, 2]], axis=-1)
            return np.linalg.norm(q, axis=-1) - k["r"]
        raise ValueError(self.kind)

    def sample_surface(self, n: int, rng) -> np.ndarray:
        k = self.params
        if self.kind == "sphere":
            d = rng.standard_normal((n, 3))
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            local = d * k["r"]
        elif self.kind == "box":
            h = k["half"]
            areas = np.array([h[1] * h[2], h[0] * h[2], h[0] * h[1]])
            face = rng.choice(3, n, p=areas / areas.sum())
            sign = rng.choice([-1.0, 1.0], n)
            local = (rng.random((n, 3)) * 2 - 1) * h
            local[np.arange(n), face] = sign * h[face]
        elif self.kind == "torus":
            # area element ~ (R + r cos(phi)): rejection-sample phi
            phi = np.empty(0)
            while len(phi) < n:
                cand = rng.uniform(-np.pi, np.pi, 2 * n)
                acc = rng.random(2 * n) < (
                    (k["R"] + k["r"] * np.cos(cand)) / (k["R"] + k["r"]))
                phi = np.concatenate([phi, cand[acc]])
            phi = phi[:n]
            theta = rng.uniform(-np.pi, np.pi, n)
            rad = k["R"] + k["r"] * np.cos(phi)
            local = np.stack([rad * np.cos(theta), rad * np.sin(theta),
                              k["r"] * np.sin(phi)], axis=-1)
        else:
            raise ValueError(self.kind)
        return (local.astype(np.float32) @ self.R.T) + self.t


def random_shape(rng, kinds=("sphere", "box", "torus")) -> Shape:
    kind = kinds[rng.integers(len(kinds))]
    R = _rand_rotation(rng)
    t = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    if kind == "sphere":
        params = {"r": rng.uniform(0.2, 0.4)}
    elif kind == "box":
        params = {"half": rng.uniform(0.12, 0.38, 3).astype(np.float32)}
    else:
        R_maj = rng.uniform(0.18, 0.3)
        params = {"R": R_maj, "r": rng.uniform(0.06, min(0.14, R_maj * 0.8))}
    return Shape(kind, params, R, t)


def make_sample(shape: Shape, rng, n_points: int = 1024,
                n_queries: int = 512, noise_std: float = 0.005
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input cloud [N,3], queries [Q,3], occupancy [Q]) — half the
    queries uniform in the unit cube, half near-surface (the POCO data
    recipe; occupancy 1 = inside, matching datasets.py layouts)."""
    pts = shape.sample_surface(n_points, rng)
    if noise_std:
        pts = pts + rng.normal(0, noise_std, pts.shape).astype(np.float32)
    nu = n_queries // 2
    q_uni = rng.uniform(-0.5, 0.5, (nu, 3)).astype(np.float32)
    q_near = (shape.sample_surface(n_queries - nu, rng)
              + rng.normal(0, 0.05, (n_queries - nu, 3))).astype(np.float32)
    q = np.concatenate([q_uni, q_near])
    occ = (shape.sdf(q) < 0).astype(np.int32)
    return pts.astype(np.float32), q, occ


def batch_iterator(seed: int, batch: int = 4, n_points: int = 1024,
                   n_queries: int = 512, noise_std: float = 0.005):
    """Infinite generator of training batches."""
    rng = np.random.default_rng(seed)
    while True:
        pos, qs, occ = [], [], []
        for _ in range(batch):
            s = random_shape(rng)
            p, q, o = make_sample(s, rng, n_points, n_queries, noise_std)
            pos.append(p); qs.append(q); occ.append(o)
        yield (np.stack(pos), np.stack(qs), np.stack(occ))
