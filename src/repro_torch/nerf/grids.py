"""Feature representations of the paper's three model families (port of
``repro.nerf.grids``); the scene domain is the cube [-1, 1]^3.

* dense grid (DirectVoxGO): corner ids, trilinear weights and the
  reference gather (the streaming backend's Gathering Unit walks this);
* hash grid (Instant-NGP): per level a dense or spatially hashed table;
* VM grid (TensoRF): three planes times three lines, then a basis.

The hash and VM queries are plain tensor code, as in the reference, where
they are plain ``jnp`` on every backend (the paper's NGP-level fallback).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

_CORNER_LIST = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
_CORNERS_ON: Dict[torch.device, torch.Tensor] = {}


def corners(device) -> torch.Tensor:
    """The 8 voxel-corner offsets [8, 3] int64, in v order."""
    device = torch.device(device)
    c = _CORNERS_ON.get(device)
    if c is None:
        c = torch.tensor(_CORNER_LIST, dtype=torch.int64, device=device)
        _CORNERS_ON[device] = c
    return c


def to_grid_coords(points: torch.Tensor, res: int) -> torch.Tensor:
    """Map [-1,1]^3 -> [0, res-1) continuous grid coordinates (float32;
    the upper clip ``res - 1 - 1e-4`` rounds to float32 as in the
    reference)."""
    x = (points + 1.0) * 0.5 * (res - 1)
    return torch.clamp(x, 0.0, res - 1 - 1e-4)


def trilerp_weights(frac: torch.Tensor) -> torch.Tensor:
    """[S, 3] fractional offsets -> [S, 8] trilinear corner weights."""
    on = corners(frac.device)[None] == 1
    cw = torch.where(on, frac[:, None, :], 1.0 - frac[:, None, :])
    return cw[..., 0] * cw[..., 1] * cw[..., 2]


def corner_ids_weights(points: torch.Tensor, res: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """8 corner vertex ids + trilinear weights per point.

    points [S, 3] -> (ids [S, 8] int64, weights [S, 8] float32); vertex id
    = (x * res + y) * res + z (x-major, the DRAM layout order).
    """
    g = to_grid_coords(points, res)
    base = torch.floor(g)
    frac = g - base
    c = base.long()[:, None, :] + corners(points.device)[None]
    c = torch.clamp(c, 0, res - 1)
    ids = (c[..., 0] * res + c[..., 1]) * res + c[..., 2]
    return ids, trilerp_weights(frac)


def gather_trilerp_ref(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Reference gather + interpolation: out[s] = sum_v w[s,v] table[ids[s,v]]."""
    return torch.einsum("svc,sv->sc", table[ids].float(), weights)


@dataclass(frozen=True)
class DenseGridCfg:
    res: int = 64
    channels: int = 8


def dense_query(params: dict, points: torch.Tensor,
                cfg: DenseGridCfg) -> torch.Tensor:
    ids, w = corner_ids_weights(points, cfg.res)
    return gather_trilerp_ref(params["table"], ids, w)


def dense_init(generator: torch.Generator, cfg: DenseGridCfg,
               device=None) -> dict:
    """A random dense table ``0.01 * N(0, 1)`` of ``[res^3, channels]``
    drawn from ``generator`` (the reference's shape and scale)."""
    return {"table": _normal(generator, (cfg.res**3, cfg.channels), 0.01,
                             device)}


def _normal(generator: torch.Generator, shape: Tuple[int, ...],
            scale: float, device) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape`` drawn on the generator's device,
    then moved to ``device``."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (scale * w).to(device)


# ----------------------------------------------------------------------------
# HashGrid (Instant-NGP)
# ----------------------------------------------------------------------------

# the reference's uint32 primes; products are formed in int64 and masked
# back to 32 bits, which is the reference's uint32 wraparound
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridCfg:
    num_levels: int = 8
    base_res: int = 16
    max_res: int = 256
    table_size: int = 2**14  # T per level
    channels: int = 2  # F per level

    @property
    def out_channels(self) -> int:
        return self.num_levels * self.channels

    def level_res(self, level: int) -> int:
        if self.num_levels == 1:
            return self.base_res
        b = (self.max_res / self.base_res) ** (1.0 / (self.num_levels - 1))
        return int(round(self.base_res * b**level))

    def level_dense(self, level: int) -> bool:
        """Low-resolution levels are stored dense; the others hash (the
        paper: NGP levels past ~5 leave the streaming path)."""
        res = self.level_res(level)
        return res**3 <= self.table_size


def _hash_coords(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of non-negative integer coords [..., 3] -> [0,
    table_size): each coordinate times its prime modulo 2^32, XORed, then
    modulo ``table_size`` (int64, equal to the reference's uint32 ids)."""
    c = coords.long()
    h = (c[..., 0] * _PRIMES[0]) & _U32
    h = h ^ ((c[..., 1] * _PRIMES[1]) & _U32)
    h = h ^ ((c[..., 2] * _PRIMES[2]) & _U32)
    return h % table_size


def hash_init(generator: torch.Generator, cfg: HashGridCfg,
              device=None) -> dict:
    """One ``0.01 * N(0, 1)`` table ``[table_size, channels]`` per level."""
    return {"tables": [_normal(generator, (cfg.table_size, cfg.channels),
                               1e-2, device)
                       for _ in range(cfg.num_levels)]}


def hash_level_ids_weights(points: torch.Tensor, cfg: HashGridCfg,
                           level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level ``level``'s 8 corner table rows ([S, 8] int64) and trilinear
    weights ([S, 8]) of each point: raster ids modulo the table on a dense
    level, the spatial hash on the others."""
    res = cfg.level_res(level)
    g = to_grid_coords(points, res)
    base = torch.floor(g)
    frac = g - base
    c = torch.clamp(base.long()[:, None, :] + corners(points.device)[None],
                    0, res - 1)
    if cfg.level_dense(level):
        ids = ((c[..., 0] * res + c[..., 1]) * res + c[..., 2]) \
            % cfg.table_size
    else:
        ids = _hash_coords(c, cfg.table_size)
    return ids, trilerp_weights(frac)


def hash_query(params: dict, points: torch.Tensor,
               cfg: HashGridCfg) -> torch.Tensor:
    """Features [S, num_levels * channels], level-major."""
    outs = []
    for level in range(cfg.num_levels):
        ids, w = hash_level_ids_weights(points, cfg, level)
        outs.append(gather_trilerp_ref(params["tables"][level], ids, w))
    return torch.cat(outs, dim=-1)


# ----------------------------------------------------------------------------
# TensoRFGrid (VM decomposition)
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class TensoRFCfg:
    res: int = 64
    rank: int = 8
    channels: int = 8  # output channels


def tensorf_init(generator: torch.Generator, cfg: TensoRFCfg,
                 device=None) -> dict:
    """Three ``0.1 * N(0, 1)`` planes ``[res, res, rank]``, three lines
    ``[res, rank]`` and a basis ``N(0, 1) / sqrt(3 rank)`` of ``[3 rank,
    channels]``."""
    r, k = cfg.res, cfg.rank
    planes = [_normal(generator, (r, r, k), 0.1, device) for _ in range(3)]
    lines = [_normal(generator, (r, k), 0.1, device) for _ in range(3)]
    basis = _normal(generator, (3 * k, cfg.channels),
                    1.0 / math.sqrt(3.0 * k), device)
    return {"planes": planes, "lines": lines, "basis": basis}


def _bilerp(plane: torch.Tensor, xy: torch.Tensor, res: int) -> torch.Tensor:
    g = to_grid_coords(xy, res)
    fb = torch.floor(g)
    f = g - fb
    b = fb.long()
    b1 = torch.clamp(b + 1, max=res - 1)
    v00 = plane[b[:, 0], b[:, 1]]
    v01 = plane[b[:, 0], b1[:, 1]]
    v10 = plane[b1[:, 0], b[:, 1]]
    v11 = plane[b1[:, 0], b1[:, 1]]
    w00 = (1 - f[:, :1]) * (1 - f[:, 1:2])
    w01 = (1 - f[:, :1]) * f[:, 1:2]
    w10 = f[:, :1] * (1 - f[:, 1:2])
    w11 = f[:, :1] * f[:, 1:2]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def _lerp1d(line: torch.Tensor, z: torch.Tensor, res: int) -> torch.Tensor:
    g = torch.clamp((z + 1.0) * 0.5 * (res - 1), 0.0, res - 1 - 1e-4)
    fb = torch.floor(g)
    f = (g - fb)[:, None]
    b = fb.long()
    return line[b] * (1 - f) + line[torch.clamp(b + 1, max=res - 1)] * f


_VM_AXES = ((0, 1, 2), (0, 2, 1), (1, 2, 0))  # (plane axes, line axis)


def tensorf_query(params: dict, points: torch.Tensor,
                  cfg: TensoRFCfg) -> torch.Tensor:
    """Features [S, channels]: the three plane x line products [S, rank]
    concatenated, times the basis (a plain ``torch.matmul``, outside any
    kernel in the reference too)."""
    feats = []
    for k, (a, b, c) in enumerate(_VM_AXES):
        # two column views stacked: a tuple index would upload an index
        # tensor, which a CUDA-graph capture refuses
        xy = torch.stack((points[:, a], points[:, b]), dim=-1)
        plane_feat = _bilerp(params["planes"][k], xy, cfg.res)
        line_feat = _lerp1d(params["lines"][k], points[:, c], cfg.res)
        feats.append(plane_feat * line_feat)  # [S, rank]
    return torch.cat(feats, dim=-1) @ params["basis"]
