"""Dense voxel-vertex grid (DirectVoxGO): corner ids, trilinear weights and
the reference gather. Port of the dense part of ``repro.nerf.grids``; the
scene domain is the cube [-1, 1]^3.
"""
from __future__ import annotations

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
