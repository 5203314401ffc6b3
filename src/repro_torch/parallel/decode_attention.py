"""Sequence-sharded decode attention (port of
``repro.parallel.decode_attention``).

Each rank of a mesh dimension holds one contiguous slice of the KV cache
along the sequence, computes its partial softmax statistics (max, sum and
weighted values) over that slice, and the partials merge by log-sum-exp:
one all-reduce MAX and two all-reduce SUMs of ``O(B * H * D)`` values,
instead of moving the cache. The partials are plain float32 tensor code,
as the reference computes them: no kernel reaches them there either.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.parallel.dist import all_reduce, axis


def _partial_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B, KV, G, D]; k, v [B, KV, L, D] (the local slice); valid [1, L]
    bool -> the float32 partials (m [B, KV, G, 1], l [B, KV, G, 1],
    o [B, KV, G, D])."""
    s = torch.einsum("bkgd,bkld->bkgl", q.float(), k.float()) * sm_scale
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgl,bkld->bkgd", p, v.float())
    return m, l, o


def sharded_decode_attention(q: torch.Tensor, k_local: torch.Tensor,
                             v_local: torch.Tensor,
                             index: Union[int, torch.Tensor], *, mesh,
                             seq_axis: str = "model",
                             sm_scale: float = 1.0) -> torch.Tensor:
    """One decode step's attention over a cache sharded along the sequence
    over ``mesh``'s dimension ``seq_axis``.

    q [B, H, 1, D]; ``k_local``/``v_local`` [B, KV, L, D]: rank ``i`` of
    the dimension holds cache rows ``[i * L, (i + 1) * L)``; keys at
    positions ``<= index`` are valid. Given each rank's partials
    (m_i, l_i, o_i): M = max_i m_i, L = sum_i l_i e^(m_i - M),
    O = sum_i o_i e^(m_i - M) / L. Returns [B, 1, H * D] in q's dtype on
    every rank of the dimension.
    """
    b, h, _, d = q.shape
    kv = k_local.shape[1]
    qg = q.reshape(b, kv, h // kv, d)
    ax = axis(mesh, seq_axis)
    shard_len = k_local.shape[2]
    kpos = ax.rank * shard_len + torch.arange(shard_len,
                                              device=q.device)[None, :]
    m, l, o = _partial_attn(qg, k_local, v_local, kpos <= index, sm_scale)
    w = torch.exp(m - all_reduce(m, "max", ax.group))
    lsum = all_reduce(l * w, "sum", ax.group)
    osum = all_reduce(o * w, "sum", ax.group)
    out = (osum / torch.clamp(lsum, min=1e-30)).to(q.dtype)
    return out.reshape(b, 1, h * d)
