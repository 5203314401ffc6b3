"""Layers and the depth loop (port of ``repro.models.blocks``).

A layer is a pre-norm sequence mixer with a residual, chosen by its
``LayerSpec.mixer``: attention (full or local), Mamba, mLSTM or sLSTM;
in an encoder-decoder's decoder (``cross``) a pre-norm cross-attention
over the encoder's output with a residual; then, unless ``spec.ffn ==
"none"``, a pre-norm FFN with a residual, dense SwiGLU or
mixture-of-experts (which also gives its router's auxiliary loss). The
reference stacks a period's parameters on a leading axis and scans over
them; the port keeps one parameter dict and one cache per layer and loops
over them in Python; layer ``i`` has spec ``cfg.layer_pattern[i %
cfg.period]``. A layer's cache is its mixer's: an attention ``KVCache``
(a local layer's ``min(local_window, s_max)`` wide), a ``MambaState``, an
``MlstmState`` or an ``SlstmState``; a cross layer's is the pair (its
mixer's cache, its cross-attention ``KVCache`` over the encoder's
output), as the reference's. Training (:func:`stack_train`) runs the
layers period by period; with ``cfg.remat`` each period's forward is
recomputed in the backward pass (``torch.utils.checkpoint``), the
reference's ``jax.checkpoint(..., policy=nothing_saveable)``, so only the
activations between periods stay alive. The encoder of a prefill
(:func:`stack_encode`) runs its bidirectional attention through kernel
B6; training's encoder is :func:`stack_train` with ``causal=False``.
Decode (:func:`stack_decode`) updates the caches in place: an attention
layer writes its K/V row, a recurrent layer's new state is copied into
its state tensors, and a cross layer's encoder K/V stay as the prefill
wrote them.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import DP, TP, P, rmsnorm, rmsnorm_init, \
    rmsnorm_specs, shard

# each part's leaves that its init makes in float32 whatever the model's
# dtype, by mixer or FFN kind
FLOAT32_LEAVES = {"mamba": mamba_mod.FLOAT32_LEAVES,
                  "mlstm": xlstm_mod.MLSTM_FLOAT32_LEAVES,
                  "slstm": xlstm_mod.SLSTM_FLOAT32_LEAVES,
                  "moe": moe_mod.FLOAT32_LEAVES}

MixerCache = Union[attn.KVCache, mamba_mod.MambaState,
                   xlstm_mod.MlstmState, xlstm_mod.SlstmState]
# a cross layer's cache: (its mixer's cache, its encoder K/V)
Cache = Union[MixerCache, Tuple[MixerCache, attn.KVCache]]


def layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    """The spec of layer ``i`` of the stack."""
    return cfg.layer_pattern[i % cfg.period]


def _local(spec: LayerSpec) -> bool:
    return spec.attn_kind == "local"


def float32_leaves(spec: LayerSpec, part: str) -> Tuple[str, ...]:
    """The names of the leaves of a layer's ``part`` ("mixer" or "ffn")
    that are float32 whatever the model's dtype."""
    return FLOAT32_LEAVES.get(spec.mixer if part == "mixer" else spec.ffn,
                              ())


def layer_init(generator: torch.Generator, cfg: ModelConfig,
               spec: LayerSpec, dtype: torch.dtype,
               cross: bool = False) -> dict:
    dev = generator.device
    init = {"attn": attn.attn_init, "mamba": mamba_mod.mamba_init,
            "mlstm": xlstm_mod.mlstm_init,
            "slstm": xlstm_mod.slstm_init}[spec.mixer]
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
         "mixer": init(generator, cfg, dtype)}
    if cross:
        p["norm_x"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["cross"] = attn.attn_init(generator, cfg, dtype, cross=True)
    if spec.ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["ffn"] = (moe_mod.moe_init(generator, cfg, dtype)
                    if spec.ffn == "moe" else
                    ffn_mod.ffn_init(generator, cfg.d_model, cfg.d_ff,
                                     dtype))
    return p


def layer_specs(cfg: ModelConfig, spec: LayerSpec, cross: bool = False
                ) -> dict:
    """A layer's spec tree, the structure of :func:`layer_init`'s."""
    specs = {"attn": attn.attn_specs, "mamba": mamba_mod.mamba_specs,
             "mlstm": xlstm_mod.mlstm_specs,
             "slstm": xlstm_mod.slstm_specs}[spec.mixer]
    p = {"norm1": rmsnorm_specs(), "mixer": specs(cfg)}
    if cross:
        p["norm_x"] = rmsnorm_specs()
        p["cross"] = attn.attn_specs(cfg, cross=True)
    if spec.ffn != "none":
        p["norm2"] = rmsnorm_specs()
        p["ffn"] = (moe_mod.moe_specs(cfg) if spec.ffn == "moe"
                    else ffn_mod.ffn_specs())
    return p


def stack_specs(cfg: ModelConfig, cross: bool = False) -> List[dict]:
    """One spec tree per layer. The reference stacks a period's layers on
    a leading ``num_periods`` axis and puts ``None`` first in each spec;
    the port holds one dict per layer, so its specs have no stack entry."""
    return [layer_specs(cfg, layer_spec(cfg, i), cross=cross)
            for i in range(cfg.num_layers)]


def _normed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The pre-norm of a sublayer's input, whole along the sequence (the
    batch over DP): where the Megatron-SP carry is split over the
    sequence, the all-gather before the sublayer's matmuls that GSPMD
    places there (the identity without a mesh; DTensor would otherwise
    have to flatten a batch and a sequence both split)."""
    return shard(rmsnorm(p, x, cfg.norm_eps), P(DP, None, None))


def _ffn_apply(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec
               ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """(x + FFN(norm(x)), aux): a dense FFN's auxiliary loss is 0; no FFN
    leaves x as it is."""
    if spec.ffn == "none":
        return x, 0.0
    h = _normed(p["norm2"], x, cfg)
    if spec.ffn == "moe":
        y, aux = moe_mod.moe(p["ffn"], h, cfg)
        return x + y, aux
    return x + ffn_mod.ffn(p["ffn"], h), 0.0


def _recurrent(p, h: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
               state=None):
    """A recurrent mixer over h: the chunked forms for a sequence
    (``state`` None), the step forms for a decode step."""
    if spec.mixer == "mamba":
        if state is None:
            return mamba_mod.mamba_chunked(p, h, cfg)
        return mamba_mod.mamba_decode(p, h, cfg, state)
    if spec.mixer == "mlstm":
        if state is None:
            return xlstm_mod.mlstm_chunked(p, h, cfg)
        return xlstm_mod.mlstm_scan(p, h, cfg, state)
    return xlstm_mod.slstm_scan(p, h, cfg, state)


def _cross(p, x: torch.Tensor, cfg: ModelConfig, kv: attn.KVCache, *,
           flash: bool) -> torch.Tensor:
    """x + cross-attention of norm_x(x) over the encoder K/V ``kv``."""
    hx = _normed(p["norm_x"], x, cfg)
    return x + attn.cross_attn(p["cross"], hx, kv, cfg, flash=flash)


def layer_train(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, *,
                enc_out=None, causal: bool = True
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """(x, aux): the layer (with its cross-attention over ``enc_out``
    where it has one) and its FFN's auxiliary loss."""
    h = _normed(p["norm1"], x, cfg)
    if spec.mixer == "attn":
        y = attn.attn_train(p["mixer"], h, cfg, local=_local(spec),
                            causal=causal)
    else:
        y, _ = _recurrent(p["mixer"], h, cfg, spec)
    x = x + y
    if "cross" in p and enc_out is not None:
        kv = attn.encode_cross_kv(p["cross"], enc_out, cfg)
        x = _cross(p, x, cfg, kv, flash=False)
    return _ffn_apply(p, x, cfg, spec)


def stack_train(layers: List[dict], x: torch.Tensor, cfg: ModelConfig, *,
                enc_out=None, causal: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer, period by period -> (x, the float32 sum of the layers'
    auxiliary losses)."""

    def period_fwd(x, enc_out, period_layers):
        x = shard(x, P(DP, None, None))  # the carry gathered: see below
        aux_total = 0.0
        for p, spec in zip(period_layers, cfg.layer_pattern):
            x, aux = layer_train(p, x, cfg, spec, enc_out=enc_out,
                                 causal=causal)
            aux_total = aux_total + aux
        # Megatron-SP: the carry between periods (the one activation a
        # period keeps under remat) sequence-sharded over the model axis,
        # and whole along the sequence inside the period, where GSPMD
        # gathers it (DTensor cannot flatten a batch and a sequence both
        # split into a matmul's rows, forward or backward)
        return shard(x, P(DP, TP, None)), aux_total

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, cfg.num_layers, cfg.period):
        period_layers = layers[start:start + cfg.period]
        if cfg.remat:
            x, a = checkpoint(period_fwd, x, enc_out, period_layers,
                              use_reentrant=False)
        else:
            x, a = period_fwd(x, enc_out, period_layers)
        aux = aux + a
    return x, aux


def stack_encode(layers: List[dict], x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """An encoder's layers (bidirectional attention through kernel B6,
    dense FFN) over x [B, T, D], as a prefill runs them."""
    for p in layers:
        h = _normed(p["norm1"], x, cfg)
        x, _ = _ffn_apply(p, x + attn.attn_encode(p["mixer"], h, cfg), cfg,
                          layer_spec(cfg, 0))
    return x


def layer_prefill(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                  cache_len: int, *, enc_out=None
                  ) -> Tuple[torch.Tensor, Cache]:
    """(x, the layer's cache): an attention layer's KV cache of
    ``cache_len`` rows (its window's for a local layer), or a recurrent
    mixer's state after the sequence; a cross layer's paired with its
    encoder K/V, projected here from ``enc_out`` once."""
    h = _normed(p["norm1"], x, cfg)
    if spec.mixer == "attn":
        y, cache = attn.attn_prefill(p["mixer"], h, cfg, cache_len,
                                     local=_local(spec))
    else:
        y, cache = _recurrent(p["mixer"], h, cfg, spec)
    x = x + y
    if "cross" in p and enc_out is not None:
        kv = attn.encode_cross_kv(p["cross"], enc_out, cfg)
        x = _cross(p, x, cfg, kv, flash=True)
        cache = (cache, kv)
    x, _ = _ffn_apply(p, x, cfg, spec)
    return x, cache


def layer_decode(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                 cache: Cache, index: int) -> Tuple[torch.Tensor, Cache]:
    """One-token step -> (x, the new cache). An attention layer writes its
    cache in place and returns it; a recurrent layer returns a new state
    and leaves ``cache`` as it was; a cross layer attends over its encoder
    K/V and returns them as they were, paired with its mixer's new
    cache."""
    cross_kv = None
    if "cross" in p:
        cache, cross_kv = cache
    h = _normed(p["norm1"], x, cfg)
    if spec.mixer == "attn":
        y, cache = attn.attn_decode(p["mixer"], h, cfg, cache, index,
                                    local=_local(spec))
    else:
        y, cache = _recurrent(p["mixer"], h, cfg, spec, cache)
    x = x + y
    if cross_kv is not None:
        x = _cross(p, x, cfg, cross_kv, flash=True)
        cache = (cache, cross_kv)
    x, _ = _ffn_apply(p, x, cfg, spec)
    return x, cache


def stack_prefill(layers: List[dict], x: torch.Tensor, cfg: ModelConfig,
                  cache_len: int, *, enc_out=None
                  ) -> Tuple[torch.Tensor, List[Cache]]:
    caches = []
    for i, p in enumerate(layers):
        if i % cfg.period == 0:  # the carry whole inside a period
            x = shard(x, P(DP, None, None))
        x, c = layer_prefill(p, x, cfg, layer_spec(cfg, i), cache_len,
                             enc_out=enc_out)
        caches.append(c)
        if (i + 1) % cfg.period == 0:  # Megatron-SP carry, as in training
            x = shard(x, P(DP, TP, None))
    return x, caches


def stack_decode(layers: List[dict], x: torch.Tensor, cfg: ModelConfig,
                 caches: List[Cache], index: int
                 ) -> Tuple[torch.Tensor, List[Cache]]:
    """Every layer's decode step; each mixer's cache is updated in place (a
    new recurrent state is copied into the cache's tensors, cast to their
    dtypes, as the reference's ``dynamic_update_index_in_dim`` writes). A
    cross layer's encoder K/V are read, never written."""
    for i, (p, c) in enumerate(zip(layers, caches)):
        x, new = layer_decode(p, x, cfg, layer_spec(cfg, i), c, index)
        if "cross" in p:
            c, new = c[0], new[0]
        for dst, src in zip(c, new):
            if dst is not src:
                dst.copy_(src)
    return x, caches


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     s_max: int, dtype: torch.dtype, device,
                     cross: bool = False) -> Cache:
    """A layer's zero cache; with ``cross`` paired with zero encoder K/V
    of ``enc_seq_len`` rows (1 when the config has none)."""
    if spec.mixer == "attn":
        c = attn.kv_cache_init(cfg, batch, s_max, dtype, device,
                               local=_local(spec))
    elif spec.mixer == "mamba":
        c = mamba_mod.mamba_state_init(cfg, batch, dtype, device)
    elif spec.mixer == "mlstm":
        c = xlstm_mod.mlstm_state_init(cfg, batch, device)
    else:
        c = xlstm_mod.slstm_state_init(cfg, batch, device)
    if cross:
        shape = (batch, cfg.num_kv_heads, cfg.enc_seq_len or 1, cfg.head_dim)
        c = (c, attn.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device)))
    return c


def stack_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device,
                     cross: bool = False) -> List[Cache]:
    return [layer_cache_init(cfg, layer_spec(cfg, i), batch, s_max, dtype,
                             device, cross=cross)
            for i in range(cfg.num_layers)]



def layer_cache_specs(cfg: ModelConfig, spec: LayerSpec, cross: bool = False,
                      shard_seq: bool = False):
    """A layer's cache spec, the structure of :func:`layer_cache_init`'s;
    ``shard_seq`` (long-context decode at batch 1) lays an attention
    cache's sequence over every axis."""
    if spec.mixer == "attn":
        if shard_seq:
            every = ("pod", "data", "model")
            c = attn.KVCache(P(None, None, every, None),
                             P(None, None, every, None))
        else:
            c = attn.kv_cache_specs()
    elif spec.mixer == "mamba":
        c = mamba_mod.mamba_state_specs()
    elif spec.mixer == "mlstm":
        c = xlstm_mod.mlstm_state_specs()
    else:
        c = xlstm_mod.slstm_state_specs()
    if cross:
        c = (c, attn.KVCache(P(DP, TP, None, None), P(DP, TP, None, None)))
    return c


def stack_cache_specs(cfg: ModelConfig, cross: bool = False,
                      shard_seq: bool = False) -> list:
    """One cache spec per layer (no stack entry, as :func:`stack_specs`)."""
    return [layer_cache_specs(cfg, layer_spec(cfg, i), cross=cross,
                              shard_seq=shard_seq)
            for i in range(cfg.num_layers)]
