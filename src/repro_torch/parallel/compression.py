"""Gradient compression for cross-pod data parallelism (port of
``repro.parallel.compression``).

The gradient all-reduce over the slowest axis is compressed to bfloat16,
or to int8 with one shared scale per leaf, with error feedback: each step's
quantization residual is carried into the next step. ``quantize`` rounds
half to even, as ``jnp.round`` does, so payloads and residuals are bit for
bit the reference's.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_flatten
from repro_torch.parallel.dist import all_reduce

Tree = Any
_WIRE_BYTES = {"bfloat16": 2, "int8": 1}


def quantize(g: torch.Tensor, mode: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload, scale); the payload's dtype is the wire format."""
    if mode == "bfloat16":
        return g.to(torch.bfloat16), torch.ones((), device=g.device)
    if mode == "int8":
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q, scale
    raise ValueError(mode)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_ef_state(grads: Tree) -> Tree:
    """Zero float32 residuals shaped as ``grads``."""
    leaves, unflatten = tree_flatten(grads)
    return unflatten([torch.zeros(g.shape, device=g.device) for g in leaves])


def compress_with_feedback(grads: Tree, ef: Tree, mode: str = "int8"
                           ) -> Tuple[Tree, Tree, Tree]:
    """(payloads, scales, new residuals): each leaf's ``g + ef`` quantized,
    and what the quantization lost, ``(g + ef) - dequantize(...)``."""
    leaves, unflatten = tree_flatten(grads)
    efs, _ = tree_flatten(ef)
    out = []
    for g, e in zip(leaves, efs):
        corrected = g.float() + e
        q, s = quantize(corrected, mode)
        out.append((q, s, corrected - dequantize(q, s)))
    return tuple(unflatten([o[i] for o in out]) for i in range(3))


def compressed_psum(grads: Tree, group: dist.ProcessGroup, ef: Tree,
                    mode: str = "int8") -> Tuple[Tree, Tree]:
    """Quantize with error feedback, all-reduce (SUM) the dequantized
    payloads over ``group`` and divide by its size: (the mean gradient in
    float32, the new residuals). Every rank returns the same mean."""
    qs, ss, new_ef = compress_with_feedback(grads, ef, mode)
    q_leaves, unflatten = tree_flatten(qs)
    s_leaves, _ = tree_flatten(ss)
    n = float(dist.get_world_size(group))
    return unflatten([all_reduce(dequantize(q, s), "sum", group) / n
                      for q, s in zip(q_leaves, s_leaves)]), new_ef


def wire_bytes(grads: Tree, mode: str) -> int:
    """Bytes one rank puts on the wire for ``grads`` in ``mode``."""
    leaves, _ = tree_flatten(grads)
    return sum(g.numel() * _WIRE_BYTES[mode] for g in leaves)
