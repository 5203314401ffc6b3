"""Carry weights across from the JAX reference package.

The reference's parameters, handed over as numpy arrays, become the port's
tensors on a device, so that both packages compute the same function: the
NeRF's (``{"table" | "tables" | "planes", "lines", "basis", "decoder":
{w1, b1, w2, b2, w_sigma, w_rgb, b_rgb}}``, optionally ``"mv_table"``)
with :func:`params_from_numpy`, the LM's
(``lm.init_params``'s tree) with :func:`lm_params_from_numpy` and its
AdamW state (``adamw_init``'s ``{"m", "v"}``) with
:func:`lm_opt_state_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of
from repro_torch.utils import DeviceLike, resolve_device


def params_from_numpy(params: dict, device: DeviceLike = None) -> dict:
    """Nested dict of array-likes -> the same dict of tensors on ``device``
    (default: the CUDA card; raises without one). A list stays a list of
    tensors (NGP's level tables, TensoRF's planes and lines). float arrays
    stay in their precision (bfloat16 cannot pass through numpy; cast
    after)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(params)


def _tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy holds it as ml_dtypes' type
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _lm_tree(cfg: ModelConfig, tree: dict, dev: torch.device,
             dtype: torch.dtype) -> dict:
    """The reference's LM layout (``{"embed", "blocks", "final_norm",
    "head"?}``) -> the port's (``{"embed", "layers", "final_norm",
    "head"?}``), each leaf in ``dtype`` on ``dev``; an MoE router stays
    float32, as ``moe_init`` makes it."""
    def conv(x, pick=None, name=None):
        if isinstance(x, dict):
            return {k: conv(v, pick, k) for k, v in x.items()}
        a = np.asarray(x) if pick is None else np.asarray(x)[pick]
        return _tensor(a, dev).to(torch.float32 if name == "router"
                                  else dtype)

    period = tree["blocks"]
    if len(period) != cfg.period:
        raise ValueError(f"{cfg.name}: {len(period)} pattern layers in the "
                         f"tree, the config has {cfg.period}")
    out = {"embed": conv(tree["embed"]),
           "layers": [conv(period[i], p) for p in range(cfg.num_periods)
                      for i in range(cfg.period)],
           "final_norm": conv(tree["final_norm"])}
    if "head" in tree:
        out["head"] = conv(tree["head"])
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: dict,
                         device: DeviceLike = None) -> dict:
    """The reference's LM parameters (``{"embed", "blocks", "final_norm",
    "head"?}``, leaves as numpy arrays) -> the port's (``{"embed",
    "layers", "final_norm", "head"?}``) on ``device`` (default: the CUDA
    card; raises without one), in ``cfg.dtype``.

    ``tree["blocks"]`` holds one dict per layer of the pattern, each leaf
    stacked on a leading ``num_periods`` axis; layer ``p * period + i`` is
    entry ``i`` at index ``p``. An MoE layer's ``ffn`` (``router [D, E]``,
    ``wg``/``wu [E, D, F]``, ``wd [E, F, D]``, ``shared``) comes across
    the same way; its router stays float32."""
    dev = resolve_device(device)
    return _lm_tree(cfg, tree, dev, dtype_of(cfg.dtype))


def lm_opt_state_from_numpy(cfg: ModelConfig, state: dict,
                            device: DeviceLike = None) -> dict:
    """The reference's AdamW state of an LM (``{"m": tree, "v": tree}``,
    each tree in its parameters' layout) -> the port's, laid out as
    :func:`lm_params_from_numpy` lays out the parameters, on ``device``
    (default: the CUDA card; raises without one). The moments stay
    float32, whatever ``cfg.dtype``."""
    dev = resolve_device(device)
    return {k: _lm_tree(cfg, state[k], dev, torch.float32)
            for k in ("m", "v")}
