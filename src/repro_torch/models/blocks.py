"""Layers and the depth loop (port of the attention-mixer parts of
``repro.models.blocks``).

A layer is pre-norm attention (full or local, by its ``LayerSpec``) plus a
pre-norm FFN, dense SwiGLU or mixture-of-experts, each with a residual; an
MoE layer also gives its router's auxiliary loss. The reference stacks a
period's parameters on a leading axis and scans over them; the port keeps
one parameter dict and one KV cache per layer (a local layer's cache is
``min(local_window, s_max)`` wide) and loops over them in Python; layer
``i`` has spec ``cfg.layer_pattern[i % cfg.period]``. Training
(:func:`stack_train`) runs
the layers period by period; with ``cfg.remat`` each period's forward is
recomputed in the backward pass (``torch.utils.checkpoint``), the
reference's ``jax.checkpoint(..., policy=nothing_saveable)``, so only the
activations between periods stay alive.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import rmsnorm, rmsnorm_init


def layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    """The spec of layer ``i`` of the stack."""
    return cfg.layer_pattern[i % cfg.period]


def _local(spec: LayerSpec) -> bool:
    return spec.attn_kind == "local"


def layer_init(generator: torch.Generator, cfg: ModelConfig,
               spec: LayerSpec, dtype: torch.dtype) -> dict:
    dev = generator.device
    return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "mixer": attn.attn_init(generator, cfg, dtype),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
            "ffn": (moe_mod.moe_init(generator, cfg, dtype)
                    if spec.ffn == "moe" else
                    ffn_mod.ffn_init(generator, cfg.d_model, cfg.d_ff,
                                     dtype))}


def _ffn_apply(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec
               ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """(x + FFN(norm(x)), aux): a dense FFN's auxiliary loss is 0."""
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = moe_mod.moe(p["ffn"], h, cfg)
        return x + y, aux
    return x + ffn_mod.ffn(p["ffn"], h), 0.0


def layer_train(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, *,
                causal: bool = True
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """(x, aux): the layer and its FFN's auxiliary loss."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y = attn.attn_train(p["mixer"], h, cfg, local=_local(spec),
                        causal=causal)
    return _ffn_apply(p, x + y, cfg, spec)


def stack_train(layers: List[dict], x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer, period by period -> (x, the float32 sum of the layers'
    auxiliary losses)."""

    def period_fwd(x, period_layers):
        aux_total = 0.0
        for p, spec in zip(period_layers, cfg.layer_pattern):
            x, aux = layer_train(p, x, cfg, spec, causal=causal)
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


def layer_prefill(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                  cache_len: int) -> Tuple[torch.Tensor, attn.KVCache]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn.attn_prefill(p["mixer"], h, cfg, cache_len,
                                 local=_local(spec))
    x, _ = _ffn_apply(p, x + y, cfg, spec)
    return x, cache


def layer_decode(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                 cache: attn.KVCache, index: int
                 ) -> Tuple[torch.Tensor, attn.KVCache]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn.attn_decode(p["mixer"], h, cfg, cache, index,
                                local=_local(spec))
    x, _ = _ffn_apply(p, x + y, cfg, spec)
    return x, cache


def stack_prefill(layers: List[dict], x: torch.Tensor, cfg: ModelConfig,
                  cache_len: int) -> Tuple[torch.Tensor, List[attn.KVCache]]:
    caches = []
    for i, p in enumerate(layers):
        x, c = layer_prefill(p, x, cfg, layer_spec(cfg, i), cache_len)
        caches.append(c)
    return x, caches


def stack_decode(layers: List[dict], x: torch.Tensor, cfg: ModelConfig,
                 caches: List[attn.KVCache], index: int
                 ) -> Tuple[torch.Tensor, List[attn.KVCache]]:
    for i, (p, c) in enumerate(zip(layers, caches)):
        # c is updated in place
        x, _ = layer_decode(p, x, cfg, layer_spec(cfg, i), c, index)
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device) -> List[attn.KVCache]:
    return [attn.kv_cache_init(cfg, batch, s_max, dtype, device,
                               local=_local(layer_spec(cfg, i)))
            for i in range(cfg.num_layers)]
