"""Volume rendering: alpha compositing of ray samples (port of
``repro.nerf.volrend``).

  alpha_i = 1 - exp(-sigma_i * delta_i),  T_i = prod_{j<i} (1 - alpha_j),
  w_i = T_i alpha_i,  C = sum_i w_i c_i,  D = sum_i w_i t_i + (1 - acc) far
"""
from __future__ import annotations

from typing import Tuple

import torch


def composite(sigmas: torch.Tensor, rgbs: torch.Tensor, t_vals: torch.Tensor,
              far: float, white_bkgd: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sigmas [R, N], rgbs [R, N, 3], t_vals [R, N] -> (colour [R,3],
    depth [R], weights [R,N]). Rays that hit nothing get depth ``far``, so
    void pixels warp like a skybox."""
    deltas = torch.diff(t_vals, dim=-1)
    deltas = torch.cat([deltas, deltas[:, -1:]], dim=-1)
    alpha = 1.0 - torch.exp(-torch.clamp(sigmas, min=0.0) * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = trans * alpha
    acc = weights.sum(dim=-1)
    color = torch.einsum("rn,rnc->rc", weights, rgbs)
    depth = torch.einsum("rn,rn->r", weights, t_vals) + (1.0 - acc) * far
    if white_bkgd:
        color = color + (1.0 - acc)[:, None]
    return color, depth, weights
