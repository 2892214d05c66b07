"""Pinhole camera rig batched over views (twin of core/camera.py).

Conventions as in the JAX package: camera x = screen-right, y =
screen-down, z = view depth; NDC in [-1, 1] with pixel col = (x+1)/2*res,
row = (y+1)/2*res, row 0 at the top; depth is linear view-space z.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


def fibonacci_sphere(samples: int, radius: float) -> np.ndarray:
    """Golden-angle spiral eye positions (reference camera_utils.py:86-102)."""
    pts = np.zeros((samples, 3))
    phi = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(samples):
        y = 1.0 - (i / float(samples - 1)) * 2.0
        r_y = math.sqrt(max(0.0, 1.0 - y * y))
        theta = phi * i
        pts[i] = (math.cos(theta) * r_y * radius, y * radius,
                  math.sin(theta) * r_y * radius)
    return pts


def dodecahedron_eyes() -> np.ndarray:
    """20 dodecahedron-vertex eyes of the reference 'blender' rig."""
    phi = (1 + math.sqrt(5)) / 2.0
    d = [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
         [0, -phi, -1 / phi], [0, -phi, 1 / phi],
         [0, phi, -1 / phi], [0, phi, 1 / phi],
         [-1 / phi, 0, -phi], [-1 / phi, 0, phi],
         [1 / phi, 0, -phi], [1 / phi, 0, phi],
         [-phi, -1 / phi, 0], [-phi, 1 / phi, 0],
         [phi, -1 / phi, 0], [phi, 1 / phi, 0]]
    eyes = np.array(d, dtype=float) * 1.2
    M = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0.0]])
    return eyes @ M.T


def calculate_up_vector(eye: np.ndarray, at: np.ndarray) -> np.ndarray:
    gaze = at - eye
    world_up = np.array([0.0, 1.0, 0.0])
    if np.allclose(np.cross(gaze, world_up), 0):
        return np.array([0.0, 0.0, 1.0])
    side = np.cross(gaze, world_up)
    up = np.cross(side, gaze)
    return up / np.linalg.norm(up)


class CameraRig(NamedTuple):
    """Batched pinhole cameras; tensors stacked over the view axis."""

    eyes: torch.Tensor       # [V, 3]
    rot: torch.Tensor        # [V, 3, 3] world->camera rows: right, down, fwd
    base_dirs: torch.Tensor  # [V, 3] eye - at
    up_dirs: torch.Tensor    # [V, 3]
    tan_half_fov: float
    res: int

    @property
    def num_views(self) -> int:
        return self.eyes.shape[0]

    def transform(self, points: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N,3] world points -> (ndc [V,N,2], depth [V,N])."""
        rel = points[None, :, :] - self.eyes[:, None, :]
        cam = torch.einsum("vij,vnj->vni", self.rot, rel)
        z = cam[..., 2]
        xy = cam[..., :2] / (torch.clamp(z[..., None], min=1e-9)
                             * self.tan_half_fov)
        return xy, z


def make_camera_rig(num_views: int = 8, distance: float = 1.6,
                    res: int = 512, fov_deg: float = 45.0,
                    distribution: str = "fibonacci_sphere",
                    device="cuda") -> CameraRig:
    if distribution == "fibonacci_sphere":
        eyes = fibonacci_sphere(num_views, distance)
    elif distribution in ("blender", "exact_blender"):
        eyes = dodecahedron_eyes()
        num_views = len(eyes)
    elif distribution == "self_defined" and num_views == 6:
        eyes = distance * np.array(
            [[0, 0, -1.0], [0, 0, 1.0], [0, -1.0, 0],
             [0, 1.0, 0], [-1.0, 0, 0], [1.0, 0, 0]])
    else:
        raise ValueError(f"unknown camera distribution {distribution}")

    at = np.zeros(3)
    rots = np.zeros((num_views, 3, 3))
    ups = np.zeros((num_views, 3))
    for i, eye in enumerate(eyes):
        up = calculate_up_vector(eye, at)
        fwd = at - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        rots[i] = np.stack([right, down, fwd], axis=0)
        ups[i] = up

    fov = math.pi * fov_deg / 180.0
    if distribution == "exact_blender":
        fov = 0.8575560450553894

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraRig(eyes=f32(eyes), rot=f32(rots),
                     base_dirs=f32(eyes - at[None]), up_dirs=f32(ups),
                     tan_half_fov=float(math.tan(fov / 2.0)), res=res)
