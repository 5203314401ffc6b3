"""Shared LM building blocks: dtypes, the initializer, RMSNorm (port of
``repro.models.common``; the sharding-spec helpers are not ported)."""
from __future__ import annotations

from typing import Sequence

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def ninit(generator: torch.Generator, shape: Sequence[int], scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on the generator's device, then
    cast (the reference's rule; the numbers differ from ``jax.random``)."""
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * x).to(dtype)


def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, the scale too, then cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)
