"""Feature Computation (``F``): decode gathered features into (sigma, rgb).

Port of ``repro.nerf.mlp``. Two decoders:

* ``mlp``    — the paper's lightweight radiance MLP (the NPU workload);
* ``direct`` — features already hold (sigma_raw, r, g, b), as in grids
               baked from the analytic scenes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class DecoderCfg:
    mode: str = "mlp"  # mlp | direct
    in_channels: int = 8
    hidden: int = 64
    view_dirs: bool = True


def _dir_enc(dirs: torch.Tensor) -> torch.Tensor:
    """View-direction encoding: raw + 2nd-order terms (9 dims)."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    return torch.cat([dirs, x * y, y * z, x * z, x * x, y * y, z * z], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` without a linear cut-over (``F.softplus`` turns
    linear above 20; the reference's softplus is ``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def decoder_init(generator: torch.Generator, cfg: DecoderCfg,
                 device=None) -> dict:
    """Random decoder weights drawn from ``generator`` (same shapes and
    scales as the reference; the numbers differ, since the two packages'
    generators differ — tests carry weights across with
    ``repro_torch.convert.params_from_numpy``)."""
    if cfg.mode == "direct":
        return {}
    d_in, hid = cfg.in_channels, cfg.hidden
    d_dir = 9 if cfg.view_dirs else 0

    def normal(rows: int, cols: int) -> torch.Tensor:
        w = torch.randn((rows, cols), generator=generator,
                        device=generator.device)
        return (w / math.sqrt(rows)).to(device)

    zeros = lambda n: torch.zeros((n,), device=device)
    return {"w1": normal(d_in, hid), "b1": zeros(hid),
            "w2": normal(hid, hid), "b2": zeros(hid),
            "w_sigma": normal(hid, 1),
            "w_rgb": normal(hid + d_dir, 3), "b_rgb": zeros(3)}


def decode(params: dict, feats: torch.Tensor, dirs: torch.Tensor,
           cfg: DecoderCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [S, C], dirs [S, 3] -> (sigma [S], rgb [S,3])."""
    if cfg.mode == "direct":
        sigma = torch.clamp(feats[:, 0], min=0.0)
        rgb = torch.clamp(feats[:, 1:4], 0.0, 1.0)
        return sigma, rgb
    h = torch.relu(feats @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    sigma = softplus(h @ params["w_sigma"])[:, 0]
    rgb_in = torch.cat([h, _dir_enc(dirs)], dim=-1) if cfg.view_dirs else h
    rgb = torch.sigmoid(rgb_in @ params["w_rgb"] + params["b_rgb"])
    return sigma, rgb


def decoder_flops(cfg: DecoderCfg) -> int:
    """2 * multiply-adds per ray sample of the decoder."""
    if cfg.mode == "direct":
        return 8
    d_dir = 9 if cfg.view_dirs else 0
    macs = cfg.in_channels * cfg.hidden + cfg.hidden * cfg.hidden
    macs += cfg.hidden + (cfg.hidden + d_dir) * 3
    return 2 * macs
