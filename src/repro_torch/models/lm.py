"""Top-level LM serving entry points (port of the serving half of
``repro.models.lm``): parameters, prefill and decode steps, KV caches.

Parameters are a dict ``{"embed" [V, D], "layers": [one dict per layer],
"final_norm", "head" [D, V] (absent when the embeddings are tied)}``.
Training (``chunked_ce``, the train step) is not ported (``ROADMAP.md``
A14).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import dtype_of, ninit, rmsnorm, rmsnorm_init
from repro_torch.utils import DeviceLike, resolve_device


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> dict:
    """Random parameters at the reference's scales (``lm.init_params``):
    embeddings N(0, 0.02), projections N(0, fan_in^-1/2), norms 1, QKV
    biases 0. Drawn from ``generator`` (default: seed 0) on ``device``
    (default: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    blocks.check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dtype = dtype_of(cfg.dtype)
    p = {"embed": ninit(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                        dtype),
         "layers": [blocks.layer_init(generator, cfg, dtype)
                    for _ in range(cfg.num_layers)],
         "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device)}
    if not cfg.tie_embeddings:
        p["head"] = ninit(generator, (cfg.d_model, cfg.vocab_size),
                          cfg.d_model**-0.5, dtype)
    return p


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Last position's logits: in the model's dtype, then float32 (the
    norm is per position, so only the last one is normed)."""
    x = rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return (x @ _head(params, cfg)).float()


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    blocks.check_supported(cfg)

    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, List[attn.KVCache]]:
        """batch["tokens"] [B, S] -> (logits [B, V] float32, caches)."""
        x = _embed(params, batch["tokens"])
        x, caches = blocks.stack_prefill(params["layers"], x, cfg, cache_len)
        return _logits(params, x, cfg), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    blocks.check_supported(cfg)

    def decode_step(params, caches: List[attn.KVCache], token: torch.Tensor,
                    index: int) -> Tuple[torch.Tensor, List[attn.KVCache]]:
        """token [B, 1]; ``index`` the position decoded (a host int). The
        caches are updated in place and returned."""
        x = _embed(params, token)
        x, caches = blocks.stack_decode(params["layers"], x, cfg, caches,
                                        index)
        return _logits(params, x, cfg), caches

    return decode_step


def cache_init(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None) -> List[attn.KVCache]:
    dev = resolve_device(device)
    blocks.check_supported(cfg)
    return blocks.stack_cache_init(cfg, batch, s_max, dtype_of(cfg.dtype),
                                   dev)
