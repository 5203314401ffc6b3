"""Carry weights across from the JAX reference package.

The reference's parameters, handed over as numpy arrays
(``{"table", "decoder": {w1, b1, w2, b2, w_sigma, w_rgb, b_rgb}}``,
optionally ``"mv_table"``), become the port's tensors on a device, so that
both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import DeviceLike, resolve_device


def params_from_numpy(params: dict, device: DeviceLike = None) -> dict:
    """Nested dict of array-likes -> the same dict of tensors on ``device``
    (default: the CUDA card; raises without one). float arrays stay in
    their precision (bfloat16 cannot pass through numpy; cast after)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(params)
