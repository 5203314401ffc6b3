"""Layers and the depth loop (port of the dense, full-attention parts of
``repro.models.blocks``).

A layer is pre-norm attention plus a pre-norm SwiGLU FFN, each with a
residual. The reference stacks a period's parameters on a leading axis and
scans over them; the port keeps one parameter dict and one KV cache per
layer and loops over them in Python. Training (:func:`stack_train`) runs
the layers period by period; with ``cfg.remat`` each period's forward is
recomputed in the backward pass (``torch.utils.checkpoint``), the
reference's ``jax.checkpoint(..., policy=nothing_saveable)``, so only the
activations between periods stay alive.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import rmsnorm, rmsnorm_init


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the attention variants the port does not run (``cfg``
    itself refuses other layers and families)."""
    for spec in cfg.layer_pattern:
        attn.check_supported(cfg, spec.attn_kind == "local")


def layer_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    dev = generator.device
    return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "mixer": attn.attn_init(generator, cfg, dtype),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
            "ffn": ffn_mod.ffn_init(generator, cfg.d_model, cfg.d_ff, dtype)}


def _ffn_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + ffn_mod.ffn(p["ffn"], h)


def layer_train(p, x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True) -> Tuple[torch.Tensor, float]:
    """(x, aux): a dense layer's auxiliary loss is 0."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y = attn.attn_train(p["mixer"], h, cfg, causal=causal)
    return _ffn_apply(p, x + y, cfg), 0.0


def stack_train(layers: List[dict], x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer, period by period -> (x, the float32 sum of the layers'
    auxiliary losses)."""

    def period_fwd(x, period_layers):
        aux_total = 0.0
        for p in period_layers:
            x, aux = layer_train(p, x, cfg, causal=causal)
            aux_total = aux_total + aux
        return x, aux_total

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, cfg.num_layers, cfg.period):
        period_layers = layers[start:start + cfg.period]
        if cfg.remat:
            x, a = checkpoint(period_fwd, x, period_layers,
                              use_reentrant=False)
        else:
            x, a = period_fwd(x, period_layers)
        aux = aux + a
    return x, aux


def layer_prefill(p, x: torch.Tensor, cfg: ModelConfig, cache_len: int
                  ) -> Tuple[torch.Tensor, attn.KVCache]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn.attn_prefill(p["mixer"], h, cfg, cache_len)
    return _ffn_apply(p, x + y, cfg), cache


def layer_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: attn.KVCache,
                 index: int) -> Tuple[torch.Tensor, attn.KVCache]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn.attn_decode(p["mixer"], h, cfg, cache, index)
    return _ffn_apply(p, x + y, cfg), cache


def stack_prefill(layers: List[dict], x: torch.Tensor, cfg: ModelConfig,
                  cache_len: int) -> Tuple[torch.Tensor, List[attn.KVCache]]:
    caches = []
    for p in layers:
        x, c = layer_prefill(p, x, cfg, cache_len)
        caches.append(c)
    return x, caches


def stack_decode(layers: List[dict], x: torch.Tensor, cfg: ModelConfig,
                 caches: List[attn.KVCache], index: int
                 ) -> Tuple[torch.Tensor, List[attn.KVCache]]:
    for p, c in zip(layers, caches):
        x, _ = layer_decode(p, x, cfg, c, index)  # c is updated in place
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device) -> List[attn.KVCache]:
    return [attn.kv_cache_init(cfg, batch, s_max, dtype, device)
            for _ in range(cfg.num_layers)]
