"""GQA attention with RoPE, local (chunked-window) attention, logit
soft-capping and a KV cache (port of the self-attention parts of
``repro.models.attention``).

Training runs :func:`attn_train`: the reference's blocked attention in
plain PyTorch under autograd (float32 scores, one ``[blk, S]`` row block
of queries at a time; a local layer's block reads only its ``[blk,
window + blk]`` key band once ``window + blk < S``), as the reference
trains through plain einsums and not through its Pallas kernel, which has
no gradient.

Prefill and decode both run kernel B6 (:mod:`repro_torch.kernels.
flash_attention`), where the reference computes the same functions with
plain einsums: prefill is causal attention with ``Sq == Sk`` (the
reference's ``_blocked_attn``; a local layer passes its window), decode is
attention over the cache with keys ``<= index`` valid (``attn_decode``'s
``valid = kpos <= index``), i.e. ``causal=False, kv_len=min(index + 1,
S_max)``. Softmax in fp32 either way; ``cfg.logit_softcap > 0`` caps the
scaled scores before the mask everywhere.

A local layer's cache is ``min(local_window, cache_len)`` wide: its
prefill keeps the last ``local_window`` keys. Its decode writes row
``min(index, width - 1)`` as every layer's does: past the window that is
the last row, every row counts as valid, and the reference's ring branch
(``slot = index % width``) is never taken, because it needs a cache wider
than the window (ROADMAP.md, reference caveat 4). The port computes what
the reference runs and refuses a local cache wider than the window.

The encoder-decoder's attention (the audio family): the encoder's
self-attention is bidirectional at positions ``0..T-1``; training runs
:func:`attn_train` with ``causal=False``, a prefill :func:`attn_encode`
(kernel B6, ``causal=False``). Cross-attention (:func:`cross_attn`) has no
RoPE and no mask; its K/V (:func:`encode_cross_kv`) are projected from the
encoder's output once per prefill and reused by every decode step. A
prefill and a decode step run it through B6 (``causal=False``), training
through the reference's plain ``_sdpa``: the caller says which
(``flash``). Where the encoder runs in a wider dtype than the decoder (the
reference's float32 stub frames against bfloat16 weights), its products
promote as the reference's do: a projection of the encoder's output runs
in the wider dtype, the cross K/V stay in it, and B6 gets the queries in
it too; the output comes back in the queries' dtype, as ``_sdpa``'s does.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import DP, TP, P, is_dtensor, ninit, shard, \
    whole_heads

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype, cross: bool = False) -> dict:
    """wq, wk, wv, wo (and the QKV biases where the config has them; a
    cross-attention layer has none)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d**-0.5
    p = {
        "wq": ninit(generator, (d, h * hd), s, dtype),
        "wk": ninit(generator, (d, kvh * hd), s, dtype),
        "wv": ninit(generator, (d, kvh * hd), s, dtype),
        "wo": ninit(generator, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = generator.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=dev)
    return p


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """The head (output-feature) axis over TP: Megatron's column-parallel
    QKV and row-parallel output projection."""
    p = {"wq": P(None, TP), "wk": P(None, TP), "wv": P(None, TP),
         "wo": P(TP, None)}
    if cfg.qkv_bias and not cross:
        p.update({"bq": P(TP), "bk": P(TP), "bv": P(TP)})
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
    q = whole_heads(q, h).reshape(b, s, h, hd)
    k = whole_heads(k, kvh).reshape(b, s, kvh, hd)
    v = whole_heads(v, kvh).reshape(b, s, kvh, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _heads_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """[B, S, H, D] -> [B, H, S, D] each, q and k constrained to the batch
    over DP and the heads over TP (the reference's two constraints; the
    identity without a mesh)."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    return (shard(q, P(DP, TP, None, None)), shard(k, P(DP, TP, None, None)),
            v)


def _repeat_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """[B, KVH, L, D] -> [B, KVH * g, L, D], each KV head copied to its
    ``g`` query heads in order (an expand and a view, which a DTensor
    split over the heads keeps split)."""
    b, kvh, n, d = t.shape
    return t[:, :, None].expand(b, kvh, g, n, d).reshape(b, kvh * g, n, d)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
          sm_scale: float, softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, KVH, Lk, D], mask [1, 1, Lq, Lk] bool or
    None. GQA by the static head copy ``h -> h // (H // KVH)``; scores
    (soft-capped when ``softcap > 0``), softmax and the weighted sum in
    float32, the output cast back to q's dtype. DTensors run
    :func:`_sdpa_by_block`."""
    if is_dtensor(q):
        return _sdpa_by_block(q, k, v, mask, sm_scale, softcap)
    h, kvh = q.shape[1], k.shape[1]
    if kvh != h:  # query head i reads KV head i // (H // KVH)
        k, v = (_repeat_heads(t, h // kvh) for t in (k, v))
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


def _merged_heads(o: torch.Tensor, b: int, s: int, width: int
                  ) -> torch.Tensor:
    """o [B, H, S, D] -> [B, S, H * D], the output projection's input. A
    DTensor whose heads are whole keeps its gradient whole along the
    features too (an identity redistribute, whose backward lays the
    gradient out as ``o``): the row-split projection would hand back a
    gradient split in blocks that need not hold whole heads, which the
    view's backward cannot split per head (torch 2.11 refuses)."""
    o = o.transpose(1, 2).reshape(b, s, width)
    if is_dtensor(o) and not any(p.is_shard(2) for p in o.placements):
        o = o.redistribute(o.device_mesh, o.placements)
    return o


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """t [B, KVH, S, D] zero-padded to ``S + pad`` rows. A DTensor that is
    not split over its rows pads each rank's block (DTensor's own ``pad``
    plan fails on torch 2.11)."""
    if not (is_dtensor(t) and not any(p.is_shard(2) for p in t.placements)):
        return torch.nn.functional.pad(t, (0, 0, 0, pad))
    from torch.distributed.tensor import DTensor

    shape = (*t.shape[:2], t.shape[2] + pad, t.shape[3])
    return DTensor.from_local(
        torch.nn.functional.pad(t.to_local(), (0, 0, 0, pad)),
        t.device_mesh, t.placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _sdpa_by_block(q, k, v, mask, sm_scale: float, softcap: float):
    """:func:`_sdpa` of DTensors, each rank on its own block: q keeps its
    batch and head splits and is gathered along its other dims; k and v
    take q's batch split, and its head split where that split divides both
    head counts (each rank's query heads then read only its own KV heads),
    else are whole over that mesh dim. Each rank runs the plain
    :func:`_sdpa` on its query heads and their KV heads; the output is
    split as q. (A matmul of DTensors split over both the batch and the
    heads flattens the two, which DTensor refuses.) The KV gradient of a
    rank that reads only some of the whole KV heads is partial."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = q.device_mesh
    h, kvh = q.shape[1], k.shape[1]
    qp = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in q.placements]
    kp, kgrad = [], []
    for m, p in enumerate(qp):
        n = mesh.size(m)
        aligned = p != Shard(1) or (h % n == 0 and kvh % n == 0)
        kp.append(p if aligned else Replicate())
        kgrad.append(kp[-1] if aligned else Partial())
    q_l = q.redistribute(mesh, qp).to_local()
    k_l, v_l = (t.redistribute(mesh, kp).to_local(grad_placements=kgrad)
                for t in (k, v))
    _, q_off = compute_local_shape_and_global_offset(q.shape, mesh, qp)
    _, k_off = compute_local_shape_and_global_offset(k.shape, mesh, kp)
    heads = q_off[1] + torch.arange(q_l.shape[1], device=q_l.device)
    idx = heads // (h // kvh) - k_off[1]
    if not (k_l.shape[1] == q_l.shape[1] and q_off[1] == k_off[1]):
        k_l, v_l = k_l.index_select(1, idx), v_l.index_select(1, idx)
    out = _sdpa(q_l, k_l, v_l, mask, sm_scale, softcap).contiguous()
    return DTensor.from_local(out, mesh, qp, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def _blocked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, *, local: bool, q_block: int,
                  causal: bool = True) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, KVH, S, D] -> [B, H, S, D], one block of
    ``min(q_block, S)`` queries at a time (never an [S, S] score matrix);
    a block that does not divide S becomes S. A full layer's block reads
    every key; a local layer masks keys ``window`` or more before the
    query and, once ``window + blk < S``, reads only the band of
    ``window + blk`` keys that ends with the block."""
    s = q.shape[2]
    blk = min(q_block, s)
    if s % blk != 0:  # tiny smoke shapes
        blk = s
    sm = cfg.head_dim**-0.5
    window = cfg.local_window if local else s
    banded = local and window + blk < s
    outs = []
    for start in range(0, s, blk):
        k_blk, v_blk, kv_start = k, v, 0
        if banded:
            kv_len = window + blk
            kv_start = min(max(start + blk - kv_len, 0), s - kv_len)
            k_blk = k[:, :, kv_start:kv_start + kv_len]
            v_blk = v[:, :, kv_start:kv_start + kv_len]
        kpos = kv_start + torch.arange(k_blk.shape[2], device=q.device)[None]
        qpos = start + torch.arange(blk, device=q.device)[:, None]
        mask = (qpos >= kpos) if causal else None
        if local:
            near = (qpos - kpos) < window
            mask = near if mask is None else mask & near
        outs.append(_sdpa(q[:, :, start:start + blk], k_blk, v_blk,
                          None if mask is None else mask[None, None], sm,
                          cfg.logit_softcap))
    return torch.cat(outs, dim=2)


def attn_train(params, x: torch.Tensor, cfg: ModelConfig, *,
               local: bool = False, q_block: int = 0, positions=None,
               causal: bool = True) -> torch.Tensor:
    """Self-attention for training over x [B, S, D] (positions default to
    0..S-1), blocked by ``q_block or cfg.q_block`` queries; causal or
    bidirectional, windowed when ``local``. Differentiable: plain
    PyTorch, no kernel."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _heads_major(*_project_qkv(params, x, cfg, positions))
    o = _blocked_attn(q, k, v, cfg, local=local,
                      q_block=q_block or cfg.q_block, causal=causal)
    o = _merged_heads(o, b, s, cfg.num_heads * cfg.head_dim)
    return o @ params["wo"]


def attn_prefill(params, x: torch.Tensor, cfg: ModelConfig, cache_len: int,
                 *, local: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Causal self-attention over x [B, S, D] at positions 0..S-1 (kernel
    B6, with the layer's window when ``local``), and the KV cache: a local
    layer whose window is shorter than ``cache_len`` keeps its last
    ``local_window`` keys, zero-padded to that width; any other layer keeps
    every key, zero-padded to ``cache_len``."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _heads_major(*_project_qkv(params, x, cfg, positions))
    o = fa.flash_attention(q, k, v, causal=True, sm_scale=cfg.head_dim**-0.5,
                           window=cfg.local_window if local else 0,
                           softcap=cfg.logit_softcap)
    o = _merged_heads(o, b, s, cfg.num_heads * cfg.head_dim)
    out = o @ params["wo"]
    if local and cfg.local_window < cache_len:
        width = cfg.local_window
        k, v = k[:, :, -width:], v[:, :, -width:]
    else:
        width = cache_len
    pad = max(width - k.shape[2], 0)
    kc, vc = _pad_rows(k, pad), _pad_rows(v, pad)
    return out, KVCache(kc, vc)


def attn_encode(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's bidirectional self-attention over x [B, T, D] at
    positions 0..T-1 (kernel B6, ``causal=False``): what :func:`attn_train`
    computes with ``causal=False``, without a cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _heads_major(*_project_qkv(params, x, cfg, positions))
    o = fa.flash_attention(q, k, v, causal=False,
                           sm_scale=cfg.head_dim**-0.5,
                           softcap=cfg.logit_softcap)
    o = _merged_heads(o, b, s, cfg.num_heads * cfg.head_dim)
    return o @ params["wo"]


def _write_row(cache: torch.Tensor, row: int, val: torch.Tensor) -> None:
    """``cache[:, :, row] = val`` in place (cache [B, KVH, S, D], val [B,
    KVH, D]). A DTensor cache writes its own block: the rank holding
    ``row`` of a sequence-split cache writes it (DTensor would write a
    redistributed copy of such a row and leave the cache as it was)."""
    if not is_dtensor(cache):
        cache[:, :, row] = val
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    # val's dims are the cache's 0, 1 and 3; the cache's sequence split
    # is replicated for it
    lay = [Shard({0: 0, 1: 1, 3: 2}[p.dim]) if p.is_shard() and p.dim != 2
           else Replicate() for p in cache.placements]
    block = val.redistribute(mesh, lay).to_local()  # on every rank
    local = cache.to_local()
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                   cache.placements)
    if off[2] <= row < off[2] + local.shape[2]:
        local[:, :, row - off[2]] = block


def attn_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                index: int, *, local: bool = False
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x [B, 1, D]; ``index`` (a host int) is the
    position every row decodes at (RoPE's position). The new K/V are
    written into ``cache`` in place at row ``min(index, S_max - 1)`` (on
    the current stream), then B6 attends over the cache with keys
    ``<= index`` valid. At ``index >= S_max`` that is the reference's rule:
    ``dynamic_update_slice_in_dim`` clamps the write to the last row, and
    every key counts as valid. A local layer's cache is at most
    ``local_window`` wide (see the module docstring); a wider one
    raises."""
    b = x.shape[0]
    s_max = cache.k.shape[2]
    if index < 0:
        raise ValueError(f"decode index {index} < 0")
    if local and cfg.local_window < s_max:
        raise ValueError(f"local decode over a cache of {s_max} rows, wider "
                         f"than the window {cfg.local_window}: the "
                         "reference's ring branch, which its own caches "
                         "never reach, is not ported")
    positions = torch.full((b, 1), index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    row = min(index, s_max - 1)
    _write_row(cache.k, row, k[:, 0].to(cache.k.dtype))
    _write_row(cache.v, row, v[:, 0].to(cache.v.dtype))
    o = fa.flash_attention(q.transpose(1, 2), cache.k, cache.v,
                           causal=False, sm_scale=cfg.head_dim**-0.5,
                           kv_len=min(index + 1, s_max),
                           softcap=cfg.logit_softcap)  # [B, H, 1, D]
    o = o.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return o @ params["wo"], cache


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the wider of the two dtypes (jnp's promotion)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def cross_attn(params, x: torch.Tensor, enc_kv: KVCache, cfg: ModelConfig,
               *, flash: bool = True) -> torch.Tensor:
    """Encoder-decoder cross-attention (no mask, no RoPE). x [B, S, D]
    against ``enc_kv`` [B, KVH, T, D]: kernel B6 with ``causal=False``
    (``flash``: a prefill or a decode step) or the plain ``_sdpa``
    (training, under autograd)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = whole_heads(x @ params["wq"], h).reshape(b, s, h, hd).transpose(1,
                                                                      2)
    if flash:
        dt = torch.promote_types(q.dtype, enc_kv.k.dtype)
        o = fa.flash_attention(q.to(dt), enc_kv.k.to(dt), enc_kv.v.to(dt),
                               causal=False, sm_scale=hd**-0.5).to(q.dtype)
    else:
        o = _sdpa(q, enc_kv.k, enc_kv.v, None, hd**-0.5)
    o = _merged_heads(o, b, s, h * hd)
    return o @ params["wo"]


def encode_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> KVCache:
    """A layer's cross-attention K/V [B, KVH, T, D] from the encoder's
    states [B, T, D] (computed once at prefill, reused every decode step),
    in the wider of their dtype and the weights'."""
    b, s, _ = enc_out.shape
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    k = whole_heads(_promoted_matmul(enc_out, params["wk"]), kvh) \
        .reshape(b, s, kvh, hd)
    v = whole_heads(_promoted_matmul(enc_out, params["wv"]), kvh) \
        .reshape(b, s, kvh, hd)
    return KVCache(k.transpose(1, 2), v.transpose(1, 2))


def kv_cache_init(cfg: ModelConfig, batch: int, s_max: int,
                  dtype: torch.dtype, device, local: bool = False) -> KVCache:
    """Zeros ``[batch, KVH, width, D]``: width ``s_max``, or
    ``min(local_window, s_max)`` for a local layer."""
    width = min(cfg.local_window, s_max) if local else s_max
    shape = (batch, cfg.num_kv_heads, width, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def kv_cache_specs() -> KVCache:
    """The batch over DP and the *sequence* over the model axis (the
    flash-decode layout): KV-head counts rarely divide a 16-way model axis,
    the cache's sequence always does."""
    return KVCache(P(DP, None, TP, None), P(DP, None, TP, None))
