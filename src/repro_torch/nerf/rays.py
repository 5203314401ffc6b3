"""Cameras, ray generation and ray-sample generation (Indexing stage ``I``).

Port of ``repro.nerf.rays``. Conventions: OpenCV-style pinhole camera,
``c2w`` a 4x4 camera-to-world matrix, the camera looks down +Z, image
(v, u) = (row, col), row-major pixel order. All math is float32.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics (Eq. 1/3 of the paper use f, cx, cy)."""

    height: int
    width: int
    focal: float
    cx: float
    cy: float

    @staticmethod
    def square(res: int, fov_deg: float = 50.0) -> "Camera":
        half = np.float32(np.deg2rad(np.float32(fov_deg))) / np.float32(2.0)
        focal = np.float32(0.5 * res) / np.float32(np.tan(np.float64(half)))
        return Camera(height=res, width=res, focal=float(focal),
                      cx=res / 2.0, cy=res / 2.0)


def look_at(eye: torch.Tensor, target: torch.Tensor,
            up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """c2w pose with the camera at ``eye`` looking at ``target``."""
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], device=eye.device)
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-9)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.norm(right) + 1e-9)
    down = torch.linalg.cross(fwd, right)
    c2w = torch.eye(4, device=eye.device)
    # camera axes: x=right, y=down (image v), z=forward
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def orbit_pose(t: float, radius: float = 2.6, height: float = 0.9,
               target: Optional[torch.Tensor] = None,
               wobble: float = 0.0) -> torch.Tensor:
    """Camera orbiting the origin; ``t`` in radians. Built on the CPU."""
    t = torch.tensor(t, dtype=torch.float32)
    if target is None:
        target = torch.zeros(3)
    eye = torch.stack([radius * torch.cos(t),
                       height + wobble * torch.sin(3.0 * t),
                       radius * torch.sin(t)])
    return look_at(eye, target)


@functools.lru_cache(maxsize=None)
def camera_dirs(cam: Camera) -> np.ndarray:
    """Camera-space per-pixel ray directions [H*W, 3] (row-major), a
    pose-independent numpy constant computed once per camera."""
    v, u = np.meshgrid(np.arange(cam.height, dtype=np.float32),
                       np.arange(cam.width, dtype=np.float32), indexing="ij")
    x = (u + 0.5 - cam.cx) / cam.focal
    y = (v + 0.5 - cam.cy) / cam.focal
    return np.stack([x, y, np.ones_like(x)], axis=-1).reshape(-1, 3)


_DIRS_ON_DEVICE: Dict[Tuple[Camera, torch.device], torch.Tensor] = {}


def camera_dirs_on(cam: Camera, device: torch.device) -> torch.Tensor:
    """:func:`camera_dirs` uploaded once per (camera, device)."""
    key = (cam, torch.device(device))
    dirs = _DIRS_ON_DEVICE.get(key)
    if dirs is None:
        dirs = torch.as_tensor(camera_dirs(cam), device=device)
        _DIRS_ON_DEVICE[key] = dirs
    return dirs


def generate_rays(cam: Camera, c2w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space ray (origins [H*W, 3], unit directions [H*W, 3])."""
    o, d = generate_rays_batch(cam, c2w[None])
    return o[0], d[0]


def generate_rays_batch(cam: Camera, c2ws: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for a pose batch [N,4,4] -> ([N,H*W,3], [N,H*W,3])."""
    dirs = camera_dirs_on(cam, c2ws.device)
    dirs_world = dirs[None] @ c2ws[:, :3, :3].transpose(1, 2)
    dirs_world = dirs_world / torch.linalg.norm(dirs_world, dim=-1,
                                                keepdim=True)
    origins = c2ws[:, None, :3, 3].expand(dirs_world.shape)
    return origins, dirs_world


Jitter = Union[None, torch.Tensor, torch.Generator]


def sample_along_rays(origins: torch.Tensor, dirs: torch.Tensor, near: float,
                      far: float, num_samples: int, jitter: Jitter = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Samples along each ray: (points [R, N, 3], t [R, N]).

    Without ``jitter`` the depths are evenly spaced from ``near`` to
    ``far``. With it they are stratified, as the reference's ``key``
    makes them: each depth gets an offset in ``[0, (far - near) / N)``,
    either the ``[R, N]`` tensor given (the offsets themselves, so a test
    can hand in the reference's draw) or ``U(0, 1) * (far - near) / N``
    drawn from the ``torch.Generator`` given, on the rays' device.
    """
    r = origins.shape[0]
    t = torch.linspace(near, far, num_samples, dtype=torch.float32,
                       device=origins.device)
    t = t.expand(r, num_samples)
    if isinstance(jitter, torch.Generator):
        u = torch.rand((r, num_samples), generator=jitter,
                       device=origins.device)
        jitter = u * ((far - near) / num_samples)
    if jitter is not None:
        t = t + jitter
    points = origins[:, None, :] + dirs[:, None, :] * t[..., None]
    return points, t
