"""Mixture-of-Experts with two dispatch modes (port of
``repro.models.moe``, its single-device branch).

Dispatch is row-grouped: each batch row is a dispatch group with its own
capacity of ``_row_capacity(cfg, S)`` slots per expert, filled in the
(token, k) pair order; a pair past its expert's capacity is dropped (it
lands on a dump row that is cut off, and the combine zeroes it).

``einsum`` (baseline): the queue position is the cumsum of a one-hot over
the pair order. ``streaming`` (the Cicero tie-in, the MoE analogue of
memory-centric rendering): the pairs are sorted by expert id per row (a
stable sort, the RIT), each expert's block starts where ``searchsorted``
finds it, and a pair's position is its rank inside the block. The same
capacity rule gives the same slots, so both modes give the same output.

The expert products are ``torch.einsum`` over ``[B, E, cap, D]``, as the
reference computes them outside any kernel. The reference's mesh branch
(``shard_map`` over the model axis) is ROADMAP.md A3b.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import ninit

# the leaves ``moe_init`` makes in float32 whatever the model's dtype
FLOAT32_LEAVES = ("router",)


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """The router in float32 whatever ``dtype``; experts ``wg``/``wu``
    ``[E, D, F]`` and ``wd [E, F, D]``; the shared expert's SwiGLU."""
    d, e = cfg.d_model, cfg.moe_num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    p = {"router": ninit(generator, (d, e), d**-0.5, torch.float32),
         "wg": ninit(generator, (e, d, f), d**-0.5, dtype),
         "wu": ninit(generator, (e, d, f), d**-0.5, dtype),
         "wd": ninit(generator, (e, f, d), f**-0.5, dtype)}
    if cfg.moe_shared_expert:
        p["shared"] = ffn_mod.ffn_init(generator, d, f, dtype)
    return p


def _router(params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing in float32. x [B, S, D] -> (idx [B, S, k] int64,
    gate [B, S, k] in x's dtype, aux): the top-k softmax gates normalized
    to sum 1, and the load-balancing loss ``E * sum(density *
    mean_gate)``."""
    e = cfg.moe_num_experts
    gates = torch.softmax(x.float() @ params["router"], dim=-1)  # [B, S, E]
    gate, idx = torch.topk(gates, cfg.moe_top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat = idx.reshape(-1)
    density = torch.zeros((e,), dtype=torch.float32, device=x.device) \
        .index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32)) \
        / flat.numel()
    aux = e * torch.sum(density * gates.mean((0, 1)))
    return idx, gate.to(x.dtype), aux


def _row_capacity(cfg: ModelConfig, s: int) -> int:
    cap = int(cfg.capacity_factor * s * cfg.moe_top_k / cfg.moe_num_experts)
    return max(8, -(-cap // 8) * 8)


def _expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """xe [B, E, cap, D] -> same, through each expert's SwiGLU."""
    h = torch.nn.functional.silu(torch.einsum("becd,edf->becf", xe,
                                              params["wg"]))
    h = h * torch.einsum("becd,edf->becf", xe, params["wu"])
    return torch.einsum("becf,efd->becd", h, params["wd"])


def _dispatch_combine(params, x: torch.Tensor, gate: torch.Tensor,
                      cfg: ModelConfig, slot_of_pair: torch.Tensor,
                      keep: torch.Tensor) -> torch.Tensor:
    """Scatter the kept pairs' tokens into ``[B, E, cap, D]``, run the
    experts, gather each pair's row back and sum over k weighted by its
    gate in float32; plus the shared expert.

    slot_of_pair [B, S*k]: the flat ``e * cap + position`` slot of each
    (token, k) pair; keep [B, S*k]: False for a pair past capacity."""
    b, s, d = x.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    src_token = torch.arange(s * k, device=x.device) // k  # [S*k]
    slots = torch.where(keep, slot_of_pair, e * cap)  # the dump row: E*cap
    rows = torch.arange(b, device=x.device)[:, None]
    xe = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe[rows, slots] = x[:, src_token]
    ye = _expert_ffn(params, xe[:, :-1].reshape(b, e, cap, d))
    contrib = ye.reshape(b, e * cap, d)[rows, torch.clamp(slots,
                                                          max=e * cap - 1)]
    contrib = torch.where(keep[..., None], contrib, 0.0)
    out = contrib.float() * gate.reshape(b, s * k)[..., None].float()
    out = out.reshape(b, s, k, d).sum(2).to(x.dtype)
    if cfg.moe_shared_expert:
        out = out + ffn_mod.ffn(params["shared"], x)
    return out


def moe_einsum(params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: queue position = cumsum of a one-hot along the row."""
    b, s, _ = x.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    idx, gate, aux = _router(params, x, cfg)
    flat_e = idx.reshape(b, s * k)  # pair order = (token, k)
    onehot = torch.nn.functional.one_hot(flat_e, e)  # [B, S*k, E]
    pos = torch.cumsum(onehot, dim=1) - 1  # queue position per expert
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slots = flat_e * cap + torch.clamp(pos, max=cap - 1)
    return _dispatch_combine(params, x, gate, cfg, slots, keep), aux


def moe_streaming(params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RIT-style: a stable per-row sort by expert id gives each expert a
    contiguous block; a pair's queue position is its rank in the block
    (no [B, S*k, E] one-hot). Output equal to :func:`moe_einsum`."""
    b, s, _ = x.shape
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    cap = _row_capacity(cfg, s)
    idx, gate, aux = _router(params, x, cfg)
    flat_e = idx.reshape(b, s * k)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)  # the RIT
    experts = torch.arange(e, device=x.device).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)  # [B, E]
    rank = torch.arange(s * k, device=x.device)[None] \
        - torch.gather(starts, 1, sorted_e)
    keep_sorted = rank < cap
    slot_sorted = sorted_e * cap + torch.clamp(rank, max=cap - 1)
    # un-sort the slot assignment back to (token, k) pair order
    slots = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    return _dispatch_combine(params, x, gate, cfg, slots, keep), aux


def moe(params, x: torch.Tensor, cfg: ModelConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux float32 scalar)."""
    if cfg.moe_dispatch == "streaming":
        return moe_streaming(params, x, cfg)
    return moe_einsum(params, x, cfg)
