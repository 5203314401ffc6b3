"""Mamba-2-style selective SSM (S6/SSD), jamba's sequence mixer (port of
``repro.models.mamba``).

Training and prefill run the chunkwise-parallel SSD form
(:func:`mamba_chunked`: intra-chunk matmuls, the inter-chunk state
``[B, H, dh, N]`` carried chunk to chunk); decode is the O(1) recurrent
update (:func:`mamba_decode`). Per head h, with a scalar decay:

    s_t = exp(A_h * dt_t) * s_{t-1} + dt_t * (B_t x_t^T)     s in R^{dh x N}
    y_t = s_t . C_t + D_h * x_t

The reference lets JAX promote its bfloat16 ``xh`` to float32 where it
meets the float32 ``dt``, ``B``, ``C`` and state in an ``einsum``; torch
refuses mixed dtypes there, so the port casts ``xh`` to float32 (exactly)
at those points. Every product is written pairwise, in an order that
never builds a 5-D tensor: ``dt`` is folded into ``x`` and the
intra-chunk sum is one batched product over ``s`` per head (the
reference's four-operand ``einsum``, contracted left to right, would
build ``[B, L, S, H, P]``). Under autograd each chunk is recomputed in
the backward pass (``torch.utils.checkpoint``), the reference's
``jax.checkpoint(chunk_step)``: it changes memory only.

No kernel: the reference computes all of this with plain einsums.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DP, TP, P, is_dtensor, ninit

# the leaves ``mamba_init`` makes in float32 whatever the model's dtype
FLOAT32_LEAVES = ("dt_bias", "a_log", "d_skip")


class MambaState(NamedTuple):
    ssm: torch.Tensor  # [B, H, dh, N] float32
    conv: torch.Tensor  # [B, d_conv - 1, d_inner], the model's dtype


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.mamba_expand * cfg.d_model
    heads = cfg.num_heads
    dh = d_inner // heads
    return d_inner, heads, dh, cfg.mamba_d_state


def mamba_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d = cfg.d_model
    d_inner, h, dh, n = _dims(cfg)
    dev = generator.device
    return {
        "in_proj": ninit(generator, (d, 2 * d_inner), d**-0.5, dtype),
        "conv_w": ninit(generator, (cfg.mamba_d_conv, d_inner), 0.5, dtype),
        "x_proj": ninit(generator, (d_inner, 2 * n + h), d_inner**-0.5,
                        dtype),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "out_proj": ninit(generator, (d_inner, d), d_inner**-0.5, dtype),
    }


def mamba_specs(cfg: ModelConfig) -> dict:
    return {"in_proj": P(None, TP), "conv_w": P(None, TP),
            "x_proj": P(TP, None), "dt_bias": P(None), "a_log": P(None),
            "d_skip": P(None), "out_proj": P(TP, None)}


def _conv1d(x: torch.Tensor, w: torch.Tensor, prev: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B, S, Di]; w [K, Di]; prev [B, K-1, Di]
    (zeros if None). Returns (out, the last K-1 rows of prev ++ x)."""
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_prev = xp[:, -(k - 1):] if k > 1 else prev
    return out, new_prev


def _gates(params, x: torch.Tensor, cfg: ModelConfig,
           conv_prev: Optional[torch.Tensor]):
    """Shared projection head. Returns (xh [B,S,H,dh] in x's dtype, z,
    dt [B,S,H], B_ssm [B,S,N], C_ssm [B,S,N], decay [B,S,H], conv state),
    all float32 but xh, z and the conv state."""
    d_inner, h, dh, n = _dims(cfg)
    proj = x @ params["in_proj"]
    xin, z = proj[..., :d_inner], proj[..., d_inner:]
    xin, conv_state = _conv1d(xin, params["conv_w"], conv_prev)
    xin = F.silu(xin)
    bcd = xin @ params["x_proj"]  # [B, S, 2N + H]
    b_ssm = bcd[..., :n].float()
    c_ssm = bcd[..., n:2 * n].float()
    dt = F.softplus(bcd[..., 2 * n:].float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])  # [H]
    decay = torch.exp(dt * a)  # [B, S, H] in (0, 1)
    xh = xin.reshape(*xin.shape[:-1], h, dh)
    return xh, z, dt, b_ssm, c_ssm, decay, conv_state


def _chunk_step(st: torch.Tensor, xc: torch.Tensor, bc: torch.Tensor,
                cc: torch.Tensor, dtc: torch.Tensor, dc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: st [B,H,dh,N]; xc [B,L,H,dh] float32; bc, cc [B,L,N];
    dtc, dc [B,L,H]. Returns (the state after the chunk, y [B,L,H,dh])."""
    l = xc.shape[1]
    logd = torch.log(torch.clamp(dc, min=1e-30))  # [B, L, H]
    cum = torch.cumsum(logd, dim=1)  # decay from chunk start to t (incl.)
    # intra-chunk: G[l, s] = (C_l . B_s) * exp(cum_l - cum_s) for s <= l
    g = torch.einsum("bln,bsn->bls", cc, bc)  # [B, L, L]
    rel = cum[:, :, None, :] - cum[:, None, :, :]  # [B, L, S, H]
    mask = torch.ones((l, l), dtype=torch.bool, device=xc.device).tril()
    # mask BEFORE exp: exp(+big) on masked entries would poison backward
    w = torch.exp(torch.where(mask[None, :, :, None], rel,
                              torch.full_like(rel, -1e30)))
    xdt = xc * dtc[..., None]  # dt folded into x: [B, S, H, dh]
    y_intra = torch.einsum("blsh,bshp->blhp", g[..., None] * w, xdt)
    # incoming-state contribution: y_l += (C_l . st) * exp(cum_l)
    y_state = torch.einsum("bln,bhpn->blhp", cc, st) * torch.exp(cum)[
        ..., None]
    y = y_intra + y_state
    # st' = st * exp(cum_L) + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
    tot = cum[:, -1:, :]  # [B, 1, H]
    wk = torch.exp(tot - cum)  # [B, L, H]
    st_new = (st * torch.exp(tot)[:, 0, :, None, None]
              + torch.einsum("bshp,bsn->bhpn", (wk * dtc)[..., None] * xc,
                             bc))
    return st_new, y


def _chunk_step_by_block(st, xc, bc, cc, dtc, dc):
    """:func:`_chunk_step` of DTensors, each rank on its own block: xc's
    batch and head splits, every input laid out to match (B and C, which
    every head reads, whole over the head split, their gradient partial
    there), the state and y split as xc. Batches and heads are
    independent, so this is the step the reference's GSPMD partitions;
    DTensor's own plan flattens a batch and a head split, which torch 2.11
    refuses."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xc.device_mesh
    rows = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in xc.placements]

    def lay(head_dim, shared=Replicate()):
        return [Shard(0) if p == Shard(0) else
                (Shard(head_dim) if head_dim is not None else shared)
                if p == Shard(2) else Replicate() for p in rows]

    def local(t, placements, grad=None):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad or placements)

    st_new, y = _chunk_step(
        local(st, lay(1)), local(xc, rows),
        *(local(t, lay(None), lay(None, Partial())) for t in (bc, cc)),
        *(local(t, lay(2)) for t in (dtc, dc)))
    meta = lambda shape: torch.empty(shape, device="meta").stride()
    return (DTensor.from_local(st_new.contiguous(), mesh, lay(1),
                               run_check=False, shape=st.shape,
                               stride=meta(st.shape)),
            DTensor.from_local(y.contiguous(), mesh, rows, run_check=False,
                               shape=xc.shape, stride=meta(xc.shape)))


def mamba_chunked(params, x: torch.Tensor, cfg: ModelConfig, *,
                  chunk: int = 256, state: Optional[MambaState] = None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Chunkwise-parallel SSD. x [B, S, D] -> (y [B, S, D], final state).
    Chunks of ``min(chunk, S)`` positions; the whole sequence as one chunk
    when that does not divide S (the reference's rule)."""
    b, s, _ = x.shape
    d_inner, h, dh, n = _dims(cfg)
    conv_prev = state.conv if state is not None else None
    xh, z, dt, b_ssm, c_ssm, decay, conv_state = _gates(params, x, cfg,
                                                        conv_prev)
    l = min(chunk, s)
    if s % l != 0:
        l = s
    st = (state.ssm if state is not None else
          torch.zeros((b, h, dh, n), dtype=torch.float32, device=x.device))
    xf = xh.float()
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params.values()))
    ys = []
    for start in range(0, s, l):
        sl = slice(start, start + l)
        inp = (xf[:, sl], b_ssm[:, sl], c_ssm[:, sl], dt[:, sl],
               decay[:, sl])
        step = _chunk_step_by_block if is_dtensor(xf) else _chunk_step
        if remat:
            st, y = checkpoint(step, st, *inp, use_reentrant=False)
        else:
            st, y = step(st, *inp)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]  # [B, S, H, dh]
    y = y + params["d_skip"][None, None, :, None] * xf
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["out_proj"], MambaState(st, conv_state)


def mamba_decode(params, x: torch.Tensor, cfg: ModelConfig,
                 state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrent update. x [B, 1, D]."""
    b = x.shape[0]
    d_inner, h, dh, n = _dims(cfg)
    xh, z, dt, b_ssm, c_ssm, decay, conv_state = _gates(params, x, cfg,
                                                        state.conv)
    xf = xh[:, 0].float()  # [B, H, dh]
    # s_t = decay * s + dt * (x B^T)
    st = (state.ssm * decay[:, 0, :, None, None]
          + (dt[:, 0, :, None] * xf)[..., None] * b_ssm[:, 0, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", c_ssm[:, 0], st)
    y = y + params["d_skip"][None, :, None] * xf
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], MambaState(st, conv_state)


def mamba_state_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> MambaState:
    d_inner, h, dh, n = _dims(cfg)
    return MambaState(
        ssm=torch.zeros((batch, h, dh, n), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, cfg.mamba_d_conv - 1, d_inner), dtype=dtype,
                         device=device))


def mamba_state_specs() -> MambaState:
    return MambaState(ssm=P(DP, TP, None, None), conv=P(DP, None, TP))
