"""Coloured point clouds drawn from (seed, index): the union of a few
rigidly moved spheres, boxes and tori, its surface sampled and coloured
by a smooth analytic field.  Copies of the program's seeded generators
(models/occupancy/synthetic.py `random_shape`, synthetic.py
`analytic_color`), frozen here so the traffic cannot change with the
program."""
from __future__ import annotations

import os

import numpy as np


def _rotation(rng) -> np.ndarray:
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


class Part:
    """One sphere, box or torus under a rotation R and a shift t."""

    def __init__(self, rng, kinds):
        self.kind = kinds[rng.integers(len(kinds))]
        self.R = _rotation(rng)
        self.t = rng.uniform(-0.05, 0.05, 3)
        if self.kind == "sphere":
            self.r = rng.uniform(0.2, 0.4)
        elif self.kind == "box":
            self.half = rng.uniform(0.12, 0.38, 3)
        else:
            self.R_maj = rng.uniform(0.18, 0.3)
            self.r = rng.uniform(0.06, min(0.14, self.R_maj * 0.8))

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        p = (pts - self.t) @ self.R
        if self.kind == "sphere":
            return np.linalg.norm(p, axis=-1) - self.r
        if self.kind == "box":
            d = np.abs(p) - self.half
            return (np.linalg.norm(np.maximum(d, 0), axis=-1)
                    + np.minimum(d.max(-1), 0))
        q = np.stack([np.linalg.norm(p[:, :2], axis=-1) - self.R_maj,
                      p[:, 2]], axis=-1)
        return np.linalg.norm(q, axis=-1) - self.r

    def area(self) -> float:
        if self.kind == "sphere":
            return 4 * np.pi * self.r ** 2
        if self.kind == "box":
            h = self.half
            return 8 * (h[0] * h[1] + h[1] * h[2] + h[0] * h[2])
        return 4 * np.pi ** 2 * self.R_maj * self.r

    def sample(self, n: int, rng) -> np.ndarray:
        if self.kind == "sphere":
            d = rng.standard_normal((n, 3))
            local = d / np.linalg.norm(d, axis=-1, keepdims=True) * self.r
        elif self.kind == "box":
            h = self.half
            areas = np.array([h[1] * h[2], h[0] * h[2], h[0] * h[1]])
            face = rng.choice(3, n, p=areas / areas.sum())
            sign = rng.choice([-1.0, 1.0], n)
            local = (rng.random((n, 3)) * 2 - 1) * h
            local[np.arange(n), face] = sign * h[face]
        else:
            phi = np.empty(0)
            while len(phi) < n:
                cand = rng.uniform(-np.pi, np.pi, 2 * n)
                keep = rng.random(2 * n) < (
                    (self.R_maj + self.r * np.cos(cand))
                    / (self.R_maj + self.r))
                phi = np.concatenate([phi, cand[keep]])
            phi = phi[:n]
            theta = rng.uniform(-np.pi, np.pi, n)
            rad = self.R_maj + self.r * np.cos(phi)
            local = np.stack([rad * np.cos(theta), rad * np.sin(theta),
                              self.r * np.sin(phi)], axis=-1)
        return local @ self.R.T + self.t


def analytic_color(p: np.ndarray) -> np.ndarray:
    """Smooth low-frequency RGB field on [-0.5, 0.5]^3 -> [0, 1]^3."""
    r = 0.5 + 0.45 * np.sin(2.0 * np.pi * p[..., 0])
    g = np.clip(p[..., 1] + 0.5, 0.0, 1.0)
    b = 0.5 + 0.45 * np.cos(2.0 * np.pi * (p[..., 2] + p[..., 0]))
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def cloud(seed: int, index: int, points: int, parts: int, kinds):
    """(xyz float32 [points, 3], rgb uint8 [points, 3]) of the union of
    `parts` shapes: each part's surface samples that lie outside every
    other part, drawn in proportion to the part's area, then exactly
    `points` of them."""
    rng = np.random.default_rng([seed, index])
    shapes = [Part(rng, tuple(kinds)) for _ in range(parts)]
    areas = np.array([s.area() for s in shapes])
    pts = np.zeros((0, 3))
    while len(pts) < points:
        for i, s in enumerate(shapes):
            n = int(np.ceil(2 * points * areas[i] / areas.sum()))
            p = s.sample(n, rng)
            for j, o in enumerate(shapes):
                if j != i:
                    p = p[o.sdf(p) > 0]
            pts = np.concatenate([pts, p])
    pts = pts[rng.permutation(len(pts))[:points]]
    rgb = np.floor(analytic_color(pts) * 255.0 + 0.5).astype(np.uint8)
    return pts.astype(np.float32), rgb


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian PLY: float x, y, z and uchar red, green, blue."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rec = np.empty(len(xyz), dtype=[("x", "<f4"), ("y", "<f4"),
                                    ("z", "<f4"), ("red", "u1"),
                                    ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb[:, i]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(xyz)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + rec.tobytes())
