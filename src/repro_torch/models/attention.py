"""GQA attention with RoPE and a KV cache (port of the full-attention,
self-attention parts of ``repro.models.attention``).

Training runs :func:`attn_train`: the reference's blocked attention in
plain PyTorch under autograd (float32 scores, one ``[blk, S]`` row block
of queries at a time), as the reference trains through plain einsums and
not through its Pallas kernel, which has no gradient.

Prefill and decode both run kernel B6 (:mod:`repro_torch.kernels.
flash_attention`), where the reference computes the same functions with
plain einsums: prefill is causal attention with ``Sq == Sk`` (the
reference's ``_blocked_attn``), decode is attention over the cache with
keys ``<= index`` valid (``attn_decode``'s ``valid = kpos <= index``), i.e.
``causal=False, kv_len=min(index + 1, S_max)``. Softmax in fp32 either way.

Not ported: local (chunked-window) attention, logit soft-capping and
cross-attention (``ROADMAP.md`` A2); the entry points raise for them
(:func:`check_supported`, and ``blocks.check_supported`` for encoder
models).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import ninit

_NOT_PORTED = "not ported (ROADMAP.md A2: local attention and softcap)"
NEG_INF = -1e30


def check_supported(cfg: ModelConfig, local: bool = False) -> None:
    """Raise for the attention variants the port does not run."""
    if local:
        raise NotImplementedError(f"local attention is {_NOT_PORTED}")
    if cfg.logit_softcap > 0:
        raise NotImplementedError(f"logit_softcap > 0 is {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d**-0.5
    p = {
        "wq": ninit(generator, (d, h * hd), s, dtype),
        "wk": ninit(generator, (d, kvh * hd), s, dtype),
        "wv": ninit(generator, (d, kvh * hd), s, dtype),
        "wo": ninit(generator, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=dev)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S]. Half-split (not interleaved)
    rotation in float32, cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, KVH, S_max, D]
    v: torch.Tensor  # [B, KVH, S_max, D]


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
          sm_scale: float) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, KVH, Lk, D], mask [1, 1, Lq, Lk] bool or
    None. GQA by the static head gather ``h -> h // (H // KVH)``; scores,
    softmax and the weighted sum in float32, the output cast back to q's
    dtype."""
    h, kvh = q.shape[1], k.shape[1]
    if kvh != h:
        idx = torch.arange(h, device=q.device) // (h // kvh)
        k = k.index_select(1, idx)
        v = v.index_select(1, idx)
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def _blocked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, *, q_block: int,
                  causal: bool = True) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, KVH, S, D] -> [B, H, S, D], one block of
    ``min(q_block, S)`` queries at a time against every key (never an
    [S, S] score matrix); a block that does not divide S becomes S."""
    s = q.shape[2]
    blk = min(q_block, s)
    if s % blk != 0:  # tiny smoke shapes
        blk = s
    sm = cfg.head_dim**-0.5
    kpos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for start in range(0, s, blk):
        qpos = start + torch.arange(blk, device=q.device)[:, None]
        mask = (qpos >= kpos)[None, None] if causal else None
        outs.append(_sdpa(q[:, :, start:start + blk], k, v, mask, sm))
    return torch.cat(outs, dim=2)


def attn_train(params, x: torch.Tensor, cfg: ModelConfig, *,
               q_block: int = 0, positions=None, causal: bool = True
               ) -> torch.Tensor:
    """Self-attention for training over x [B, S, D] (positions default to
    0..S-1), blocked by ``q_block or cfg.q_block`` queries; causal or
    bidirectional. Differentiable: plain PyTorch, no kernel."""
    check_supported(cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = _blocked_attn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      cfg, q_block=q_block or cfg.q_block, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return o @ params["wo"]


def attn_prefill(params, x: torch.Tensor, cfg: ModelConfig, cache_len: int
                 ) -> Tuple[torch.Tensor, KVCache]:
    """Causal self-attention over x [B, S, D] at positions 0..S-1 (kernel
    B6), and the KV cache zero-padded to ``cache_len``."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _project_qkv(params, x, cfg, positions)
    q = q.transpose(1, 2)  # [B, H, S, D]
    k = k.transpose(1, 2)  # [B, KVH, S, D]
    v = v.transpose(1, 2)
    o = fa.flash_attention(q, k, v, causal=True, sm_scale=cfg.head_dim**-0.5)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    out = o @ params["wo"]
    pad = max(cache_len - s, 0)
    kc = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vc = torch.nn.functional.pad(v, (0, 0, 0, pad))
    return out, KVCache(kc, vc)


def attn_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                index: int) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x [B, 1, D]; ``index`` (a host int) is the
    position every row decodes at (RoPE's position). The new K/V are
    written into ``cache`` in place at row ``min(index, S_max - 1)`` (on
    the current stream), then B6 attends over the cache with keys
    ``<= index`` valid. At ``index >= S_max`` that is the reference's rule:
    ``dynamic_update_slice_in_dim`` clamps the write to the last row, and
    every key counts as valid."""
    b = x.shape[0]
    s_max = cache.k.shape[2]
    if index < 0:
        raise ValueError(f"decode index {index} < 0")
    positions = torch.full((b, 1), index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    row = min(index, s_max - 1)
    cache.k[:, :, row] = k[:, 0].to(cache.k.dtype)
    cache.v[:, :, row] = v[:, 0].to(cache.v.dtype)
    o = fa.flash_attention(q.transpose(1, 2), cache.k, cache.v,
                           causal=False, sm_scale=cfg.head_dim**-0.5,
                           kv_len=min(index + 1, s_max))  # [B, H, 1, D]
    o = o.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return o @ params["wo"], cache


def kv_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                  dtype: torch.dtype, device) -> KVCache:
    shape = (batch, cfg.num_kv_heads, s_max, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
