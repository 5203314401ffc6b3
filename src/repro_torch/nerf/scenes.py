"""Procedural scenes with analytic density/radiance fields.

Port of ``repro.nerf.scenes``: the scene record, its crc32-seeded
construction, the signed distance field, density, shaded albedo, the
view-dependent radiance the analytic ``oracle`` model renders, and the
baked dense table. A scene is a set of soft-boundary spheres plus a
ground plane inside [-1, 1]^3.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

_LIGHT = (0.35, 0.8, 0.49)  # directional light (normalized where used)

# Eight scenes mirroring Synthetic-NeRF's eight
SCENE_NAMES = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic",
               "ship"]


@dataclass(frozen=True)
class Scene:
    name: str
    centers: np.ndarray  # [K, 3] float32
    radii: np.ndarray  # [K] float32
    albedos: np.ndarray  # [K, 3] float32
    sharpness: float = 40.0  # soft sdf -> density steepness
    density_scale: float = 60.0
    specular: float = 0.0  # view-dependent lobe strength (0 => diffuse)
    spec_power: float = 16.0
    ground: float = -0.55  # ground plane height (y)
    ground_albedo: Tuple[float, float, float] = (0.65, 0.62, 0.58)


def make_scene(name: str, num_spheres: int = 6, specular: float = 0.0,
               seed: int = 0) -> Scene:
    # zlib.crc32, not the builtin string hash: that one is randomized per
    # process, which would re-roll the geometry on every run
    rng = np.random.default_rng(zlib.crc32(name.encode("utf-8")) + seed)
    centers = rng.uniform(-0.55, 0.55, size=(num_spheres, 3))
    centers[:, 1] = rng.uniform(-0.35, 0.45, size=num_spheres)
    radii = rng.uniform(0.12, 0.3, size=num_spheres)
    albedos = rng.uniform(0.15, 0.95, size=(num_spheres, 3))
    return Scene(name=name, centers=centers.astype(np.float32),
                 radii=radii.astype(np.float32),
                 albedos=albedos.astype(np.float32), specular=specular)


# (id(scene), device) -> (scene, its constants on the device): made at the
# first call on a device, so a CUDA-graph capture (the oracle's tick
# programs) uploads nothing; the entry holds the scene, so an id is never
# reused while cached
_CONSTS: Dict[Tuple[int, torch.device],
              Tuple[Scene, Dict[str, torch.Tensor]]] = {}
_MAX_CONSTS = 16


def _consts(scene: Scene, device: torch.device) -> Dict[str, torch.Tensor]:
    """The scene's spheres, albedos (the ground's last), the unit light and
    the ground's normal as tensors on ``device``."""
    key = (id(scene), device)
    hit = _CONSTS.get(key)
    if hit is not None and hit[0] is scene:
        return hit[1]
    light = torch.tensor(_LIGHT, device=device)
    albs = np.concatenate([scene.albedos,
                           np.asarray([scene.ground_albedo], np.float32)])
    consts = {"centers": torch.as_tensor(scene.centers, device=device),
              "radii": torch.as_tensor(scene.radii, device=device),
              "albedos": torch.as_tensor(albs, device=device),
              "light": light / torch.linalg.norm(light),
              "ground_n": torch.tensor([0.0, 1.0, 0.0], device=device)}
    if len(_CONSTS) >= _MAX_CONSTS:
        _CONSTS.pop(next(iter(_CONSTS)))
    _CONSTS[key] = (scene, consts)
    return consts


def _sdf(scene: Scene, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed distance to the nearest object + its index (K = ground)."""
    k = _consts(scene, p.device)
    d_spheres = torch.linalg.norm(p[:, None, :] - k["centers"][None],
                                  dim=-1) - k["radii"][None]
    d_ground = (p[:, 1] - scene.ground)[:, None]
    d_all = torch.cat([d_spheres, d_ground], dim=1)  # [S, K+1]
    d, idx = torch.min(d_all, dim=1)
    return d, idx


def _normal(scene: Scene, p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    k = _consts(scene, p.device)
    sphere_n = p[:, None, :] - k["centers"][None]
    sphere_n = sphere_n / (torch.linalg.norm(sphere_n, dim=-1, keepdim=True)
                           + 1e-9)
    ground_n = k["ground_n"].expand(p.shape[0], 1, 3)
    normals = torch.cat([sphere_n, ground_n], dim=1)  # [S, K+1, 3]
    return torch.take_along_dim(normals, idx[:, None, None], dim=1)[:, 0]


def scene_density(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    """Soft-boundary density field sigma(p) >= 0. p: [S,3]."""
    d, _ = _sdf(scene, p)
    inside_box = torch.all(torch.abs(p) <= 1.0, dim=-1)
    sigma = scene.density_scale * torch.sigmoid(-scene.sharpness * d)
    return torch.where(inside_box, sigma, 0.0)


def scene_albedo(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    """View-independent shaded colour at p (bakeable). [S,3] -> [S,3]."""
    _, idx = _sdf(scene, p)
    alb = _consts(scene, p.device)["albedos"][idx]
    n = _normal(scene, p, idx)
    light = _consts(scene, p.device)["light"]
    lambert = 0.35 + 0.65 * torch.clamp((n * light).sum(-1, keepdim=True),
                                        0.0, 1.0)
    # mild spatial texture so warping errors are visible in PSNR
    tex = 0.9 + 0.1 * torch.sin(9.0 * p[:, :1]) * torch.cos(7.0 * p[:, 2:3])
    return torch.clamp(alb * lambert * tex, 0.0, 1.0)


def scene_radiance(scene: Scene, p: torch.Tensor,
                   view_dirs: torch.Tensor) -> torch.Tensor:
    """Radiance with the view-dependent Blinn-Phong lobe (strength
    ``specular``, exponent ``spec_power``). p [S,3]; view_dirs [S,3] point
    from the camera to p (the ray directions)."""
    base = scene_albedo(scene, p)
    if scene.specular <= 0.0:
        return base
    _, idx = _sdf(scene, p)
    n = _normal(scene, p, idx)
    light = _consts(scene, p.device)["light"]
    # half vector between the light and the direction back to the camera
    h = light[None, :] - view_dirs
    h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-9)
    spec = scene.specular * torch.clamp(
        (n * h).sum(-1, keepdim=True), 0.0, 1.0) ** scene.spec_power
    return torch.clamp(base + spec, 0.0, 1.0)


def bake_dense_table(scene: Scene, res: int, channels: int = 4,
                     device=None) -> torch.Tensor:
    """Bake (sigma, rgb) at the grid vertices -> table [res^3, channels].

    Vertex ids are x-major, matching ``grids.corner_ids_weights``.
    """
    axes = torch.linspace(-1.0, 1.0, res, dtype=torch.float32, device=device)
    x, y, z = torch.meshgrid(axes, axes, axes, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    table = torch.cat([scene_density(scene, pts)[:, None],
                       scene_albedo(scene, pts)], dim=-1)
    if channels > 4:
        table = torch.nn.functional.pad(table, (0, channels - 4))
    return table
