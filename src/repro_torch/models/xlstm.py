"""xLSTM blocks (arXiv:2405.04517; port of ``repro.models.xlstm``): mLSTM
(matrix memory, parallelizable) and sLSTM (scalar memory, sequential).

mLSTM uses exponential gating with a stabilizer state m_t:

    C_t = f~_t C_{t-1} + i~_t v_t k_t^T ,  n_t = f~_t n_{t-1} + i~_t k_t
    h_t = o_t * (C_t q_t) / max(|n_t^T q_t|, exp(-m_t))

with i~ = exp(i - m_t), f~ = exp(log sigmoid(f) + m_{t-1} - m_t). The
step recurrence (:func:`mlstm_scan`) is the decode path; the
chunkwise-parallel form (:func:`mlstm_chunked`) serves prefill and
training. A chunk's state is carried stabilized at ``m_carry``, so a
chunked prefill hands :func:`mlstm_scan` the state it expects. The
reference's ``associative_scan(maximum)`` is ``torch.cummax``. Products
are written pairwise (the gate weights folded into one operand first), so
no intermediate is larger than a chunk's ``[B, L, S, H]`` weights; under
autograd each chunk is recomputed in the backward pass, as the
reference's ``jax.checkpoint(chunk_step)`` does.

sLSTM (:func:`slstm_scan`) precomputes its input projections for every
position and runs the recurrence as a Python loop over time, the
reference's ``lax.scan``, one product a step over the four gates'
concatenated recurrent weights. Every sLSTM leaf but ``w_out`` is float32
whatever the model's dtype, as are the mLSTM's gate projections.

No kernel: the reference computes all of this with plain einsums.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import DP, TP, P, blockwise, ninit, \
    whole_heads

NEG_INF = -1e30
# the leaves each init makes in float32 whatever the model's dtype
MLSTM_FLOAT32_LEAVES = ("wi", "wf", "bf", "bi")
SLSTM_FLOAT32_LEAVES = ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro",
                        "bz", "bi", "bf", "bo")


class MlstmState(NamedTuple):
    c: torch.Tensor  # [B, H, dh, dh]
    n: torch.Tensor  # [B, H, dh]
    m: torch.Tensor  # [B, H]


class SlstmState(NamedTuple):
    c: torch.Tensor  # [B, D]
    n: torch.Tensor  # [B, D]
    m: torch.Tensor  # [B, D]
    h: torch.Tensor  # [B, D]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d, h = cfg.d_model, cfg.xlstm_heads
    dev = generator.device
    s = d**-0.5
    return {
        "wq": ninit(generator, (d, d), s, dtype),
        "wk": ninit(generator, (d, d), s, dtype),
        "wv": ninit(generator, (d, d), s, dtype),
        "wi": ninit(generator, (d, h), s, torch.float32),
        "wf": ninit(generator, (d, h), s, torch.float32),
        "bf": torch.full((h,), 3.0, dtype=torch.float32, device=dev),
        "bi": torch.zeros((h,), dtype=torch.float32, device=dev),
        "wo_gate": ninit(generator, (d, d), s, dtype),
        "w_out": ninit(generator, (d, d), s, dtype),
    }


def mlstm_specs(cfg: ModelConfig) -> dict:
    return {"wq": P(None, TP), "wk": P(None, TP), "wv": P(None, TP),
            "wi": P(None, None), "wf": P(None, None), "bf": P(None),
            "bi": P(None), "wo_gate": P(None, TP), "w_out": P(TP, None)}


def _mlstm_proj(params, x: torch.Tensor, cfg: ModelConfig):
    """(q, k, v [B,S,H,dh] float32, i_pre, log f [B,S,H] float32, the
    output gate in x's dtype)."""
    b, s, d = x.shape
    h = cfg.xlstm_heads
    dh = d // h
    to_heads = lambda t: whole_heads(t, h).reshape(b, s, h, dh).float()
    q = to_heads(x @ params["wq"]) / math.sqrt(dh)
    k = to_heads(x @ params["wk"]) / math.sqrt(dh)
    v = to_heads(x @ params["wv"])
    x32 = x.float()
    i_pre = x32 @ params["wi"] + params["bi"]  # [B, S, H]
    f_pre = x32 @ params["wf"] + params["bf"]
    logf = blockwise(F.logsigmoid, f_pre)
    ogate = torch.sigmoid(x @ params["wo_gate"])
    return q, k, v, i_pre, logf, ogate


def _mlstm_out(params, hseq: torch.Tensor, ogate: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """hseq [B, S, H, dh] float32 -> (o * h) @ w_out in x's dtype."""
    b, s, d = x.shape
    return (ogate * hseq.reshape(b, s, d).to(x.dtype)) @ params["w_out"]


def mlstm_scan(params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[MlstmState] = None
               ) -> Tuple[torch.Tensor, MlstmState]:
    """Step recurrence (the decode path). x [B, S, D]."""
    b, s, _ = x.shape
    q, k, v, i_pre, logf, ogate = _mlstm_proj(params, x, cfg)
    st = state if state is not None else mlstm_state_init(cfg, b, x.device)
    hs = []
    for t in range(s):
        qt, kt, vt, it, lft = q[:, t], k[:, t], v[:, t], i_pre[:, t], \
            logf[:, t]
        lf_m = lft + st.m
        m_new = torch.maximum(lf_m, it)
        fg = torch.exp(lf_m - m_new)[..., None]
        ig = torch.exp(it - m_new)[..., None]
        c = st.c * fg[..., None] + ig[..., None] * (
            vt[..., :, None] * kt[..., None, :])  # [B, H, dh, dh]
        n = st.n * fg + ig * kt
        num = torch.einsum("bhij,bhj->bhi", c, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n, qt)),
                            torch.exp(-m_new))[..., None]
        st = MlstmState(c, n, m_new)
        hs.append(num / den)
    return _mlstm_out(params, torch.stack(hs, dim=1), ogate, x), st


def _mlstm_chunk_step(c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                      qc: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                      ic: torch.Tensor, lfc: torch.Tensor):
    """One chunk: the state (c0, n0, m0); q, k, v [B,L,H,dh]; i, log f
    [B,L,H]. Returns (c, n, m_carry, h [B,L,H,dh])."""
    l = qc.shape[1]
    cumf = torch.cumsum(lfc, dim=1)  # [B, L, H] log decay from chunk start
    # stabilizer within the chunk: the log weight of source s at target l
    # is (cumf_l - cumf_s) + i_s (s <= l); the incoming state's is
    # m_prev + cumf_l
    src = ic - cumf
    run_max = torch.cummax(src, dim=1).values
    m_new = torch.maximum(cumf + run_max, cumf + m0[:, None, :])  # [B,L,H]
    # intra-chunk weights, masked before exp (NaN-safe backward)
    logw = (cumf[:, :, None, :] - cumf[:, None, :, :]
            + ic[:, None, :, :] - m_new[:, :, None, :])  # [B, L, S, H]
    mask = torch.ones((l, l), dtype=torch.bool, device=qc.device).tril()
    wgt = torch.exp(torch.where(mask[None, :, :, None], logw,
                                torch.full_like(logw, NEG_INF)))
    g = torch.einsum("blhe,bshe->blsh", qc, kc)  # [B, L, S, H]
    gw = g * wgt
    num_intra = torch.einsum("blsh,bshe->blhe", gw, vc)
    den_intra = gw.sum(dim=2)  # [B, L, H]
    # incoming state contribution
    sc_in = torch.exp(cumf + m0[:, None, :] - m_new)  # [B, L, H]
    num_in = torch.einsum("bhef,blhf->blhe", c0, qc) * sc_in[..., None]
    den_in = torch.einsum("bhe,blhe->blh", n0, qc) * sc_in
    num = num_intra + num_in
    den = torch.maximum(torch.abs(den_intra + den_in), torch.exp(-m_new))
    hc = num / den[..., None]
    # carry the state to the next chunk, stabilized at m_carry
    tot = cumf[:, -1, :]  # [B, H]
    m_carry = torch.maximum(tot + m0, torch.amax(
        ic + tot[:, None, :] - cumf, dim=1))
    w_in = torch.exp(tot + m0 - m_carry)  # [B, H]
    w_src = torch.exp(ic + tot[:, None, :] - cumf - m_carry[:, None, :])
    c_new = (c0 * w_in[..., None, None]
             + torch.einsum("blhe,blhf->bhef", w_src[..., None] * vc, kc))
    n_new = n0 * w_in[..., None] + (w_src[..., None] * kc).sum(dim=1)
    return c_new, n_new, m_carry, hc


def mlstm_chunked(params, x: torch.Tensor, cfg: ModelConfig, *,
                  chunk: int = 128, state: Optional[MlstmState] = None
                  ) -> Tuple[torch.Tensor, MlstmState]:
    """Chunkwise-parallel mLSTM (prefill and training); equals
    :func:`mlstm_scan`. Chunks of ``min(chunk, S)`` positions; the whole
    sequence as one chunk when that does not divide S."""
    b, s, _ = x.shape
    q, k, v, i_pre, logf, ogate = _mlstm_proj(params, x, cfg)
    st = state if state is not None else mlstm_state_init(cfg, b, x.device)
    l = min(chunk, s)
    if s % l != 0:
        l = s
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params.values()))
    c, n, m = st
    hs = []
    for start in range(0, s, l):
        sl = slice(start, start + l)
        inp = (q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], logf[:, sl])
        if remat:
            c, n, m, hc = checkpoint(_mlstm_chunk_step, c, n, m, *inp,
                                     use_reentrant=False)
        else:
            c, n, m, hc = _mlstm_chunk_step(c, n, m, *inp)
        hs.append(hc)
    hseq = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    return _mlstm_out(params, hseq, ogate, x), MlstmState(c, n, m)


def mlstm_state_init(cfg: ModelConfig, batch: int, device) -> MlstmState:
    h = cfg.xlstm_heads
    dh = cfg.d_model // h
    return MlstmState(
        c=torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                      device=device),
        n=torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, h), NEG_INF, dtype=torch.float32,
                     device=device))


def mlstm_state_specs() -> MlstmState:
    return MlstmState(c=P(DP, None, None, None), n=P(DP, None, None),
                      m=P(DP, None))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d = cfg.d_model
    dev = generator.device
    f32 = torch.float32
    w = lambda: ninit(generator, (d, d), d**-0.5, f32)
    r = lambda: ninit(generator, (d, d), (4 * d) ** -0.5, f32)
    p = {"wz": w(), "wi": w(), "wf": w(), "wo": w(),
         "rz": r(), "ri": r(), "rf": r(), "ro": r()}
    p.update({
        "bz": torch.zeros((d,), dtype=f32, device=dev),
        "bi": torch.zeros((d,), dtype=f32, device=dev),
        "bf": torch.full((d,), 3.0, dtype=f32, device=dev),
        "bo": torch.zeros((d,), dtype=f32, device=dev),
        "w_out": ninit(generator, (d, d), d**-0.5, dtype)})
    return p


def slstm_specs(cfg: ModelConfig) -> dict:
    p = {k: P(None, None) for k in
         ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro")}
    p.update({k: P(None) for k in ("bz", "bi", "bf", "bo")})
    p["w_out"] = P(None, TP)
    return p


def slstm_scan(params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[SlstmState] = None
               ) -> Tuple[torch.Tensor, SlstmState]:
    """Sequential sLSTM. x [B, S, D]. The four gates' projections are
    taken as one product over their concatenated weights (``[D, 4 D]``):
    each gate's columns hold the same sums as its own product, and a step
    launches one ``addmm`` where four products and four additions would
    be."""
    b, s, d = x.shape
    st = state if state is not None else slstm_state_init(cfg, b, x.device)
    gates = ("z", "i", "f", "o")
    w = torch.cat([params[f"w{g}"] for g in gates], dim=1)
    r = torch.cat([params[f"r{g}"] for g in gates], dim=1)
    bias = torch.cat([params[f"b{g}"] for g in gates])
    # input contributions for every position at once; the recurrence loops
    gx = x.float() @ w + bias  # [B, S, 4 D]
    hs = []
    for t in range(s):
        z_pre, i_pre, f_pre, o_pre = torch.addmm(gx[:, t], st.h, r).split(
            d, dim=-1)
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        logf_m = blockwise(F.logsigmoid, f_pre) + st.m
        m_new = torch.maximum(logf_m, i_pre)
        fg = torch.exp(logf_m - m_new)
        ig = torch.exp(i_pre - m_new)
        c = fg * st.c + ig * z
        n = fg * st.n + ig
        h = o * c / torch.clamp(n, min=1.0)
        st = SlstmState(c, n, m_new, h)
        hs.append(h)
    out = torch.stack(hs, dim=1).to(x.dtype) @ params["w_out"]
    return out, st


def slstm_state_init(cfg: ModelConfig, batch: int, device) -> SlstmState:
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SlstmState(c=z(), n=z(), m=torch.full(
        (batch, d), NEG_INF, dtype=torch.float32, device=device), h=z())


def slstm_state_specs() -> SlstmState:
    return SlstmState(c=P(DP, None), n=P(DP, None), m=P(DP, None),
                      h=P(DP, None))
