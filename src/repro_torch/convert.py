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

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, lm
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
             dtype: Optional[torch.dtype]) -> dict:
    """The reference's LM layout (``{"embed", "blocks", "final_norm",
    "head"?, "encoder"?: {"blocks", "final_norm"}}``) -> the port's
    (``{"embed", "layers", "final_norm", "head"?, "encoder"?: {"layers",
    "final_norm"}}``) on ``dev``: every leaf in ``dtype``, or with ``dtype``
    None each in the dtype the reference's init gives it: float32 for the
    leaves of ``blocks.float32_leaves`` (an MoE router, a Mamba layer's
    ``dt_bias`` / ``a_log`` / ``d_skip``, an mLSTM's gates, every sLSTM
    leaf but ``w_out``), ``cfg.dtype`` for the rest."""
    model = dtype_of(cfg.dtype)

    def leaf(x, pick, f32: bool):
        a = np.asarray(x) if pick is None else np.asarray(x)[pick]
        return _tensor(a, dev).to(dtype or (torch.float32 if f32 else model))

    def conv(x, pick=None, f32=()):
        """A leaf, or a dict whose leaves named in ``f32`` are float32."""
        if isinstance(x, dict):
            return {k: conv(v, pick, f32) if isinstance(v, dict) else
                    leaf(v, pick, k in f32) for k, v in x.items()}
        return leaf(x, pick, False)

    def layer(sub, spec, pick):
        return {part: conv(v, pick, blocks.float32_leaves(spec, part))
                for part, v in sub.items()}

    def stack(period, c: ModelConfig):
        if len(period) != c.period:
            raise ValueError(f"{c.name}: {len(period)} pattern layers in "
                             f"the tree, the config has {c.period}")
        return [layer(period[i], c.layer_pattern[i], p)
                for p in range(c.num_periods) for i in range(c.period)]

    out = {"embed": conv(tree["embed"]),
           "layers": stack(tree["blocks"], cfg),
           "final_norm": conv(tree["final_norm"])}
    if "head" in tree:
        out["head"] = conv(tree["head"])
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": stack(enc["blocks"],
                                          lm._encoder_cfg(cfg)),
                          "final_norm": conv(enc["final_norm"])}
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: dict,
                         device: DeviceLike = None) -> dict:
    """The reference's LM parameters (``{"embed", "blocks", "final_norm",
    "head"?}``, leaves as numpy arrays) -> the port's (``{"embed",
    "layers", "final_norm", "head"?}``) on ``device`` (default: the CUDA
    card; raises without one), each leaf in the dtype the reference's
    init gives it (``cfg.dtype``, or float32 for the leaves
    ``blocks.FLOAT32_LEAVES`` names).

    ``tree["blocks"]`` holds one dict per layer of the pattern, each leaf
    stacked on a leading ``num_periods`` axis; layer ``p * period + i`` is
    entry ``i`` at index ``p``. An MoE layer's ``ffn`` (``router [D, E]``,
    ``wg``/``wu [E, D, F]``, ``wd [E, F, D]``, ``shared``) comes across
    the same way; so do a Mamba, mLSTM or sLSTM layer's ``mixer``, an
    encoder-decoder's ``encoder`` (its layers stacked the same way) and
    each decoder layer's ``norm_x`` and ``cross``."""
    dev = resolve_device(device)
    return _lm_tree(cfg, tree, dev, None)


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
