"""Dense SwiGLU FFN (port of ``repro.models.ffn``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import TP, P, ninit


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "wg": ninit(generator, (d_model, d_ff), d_model**-0.5, dtype),
        "wu": ninit(generator, (d_model, d_ff), d_model**-0.5, dtype),
        "wd": ninit(generator, (d_ff, d_model), d_ff**-0.5, dtype),
    }


def ffn_specs() -> dict:
    return {"wg": P(None, TP), "wu": P(None, TP), "wd": P(TP, None)}


def ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]
