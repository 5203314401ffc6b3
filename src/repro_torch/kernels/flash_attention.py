"""Flash attention (B6): GQA attention with an fp32 online softmax, the
LM layers' prefill and decode attention.

Port of ``repro.kernels.flash_attention.flash_attention`` (a Pallas TPU
kernel) as hand-written CUDA kernels, ``csrc/flash_attention.cu``; see the
note there for their bounds and designs.

``q [B, H, Sq, D]``, ``k``/``v [B, KVH, Sk, D]`` with ``H % KVH == 0``
(query head ``h`` reads KV head ``h // (H // KVH)``) -> ``[B, H, Sq, D]``
in ``q``'s dtype. Scores ``(q . k) * sm_scale`` in fp32, soft-capped to
``softcap * tanh(s / softcap)`` when ``softcap > 0``; keys at or past
``kv_len`` are masked, with ``causal`` so are keys after the query, and
with a ``window > 0`` so are keys ``window`` or more before it (query i
sees key j only if ``i - j < window``), positions counted from 0 for both
(top-left alignment, as the Pallas kernel; the reference's oracle
``attention_ref`` aligns bottom-right, and the two differ when ``Sq !=
Sk``). Masked scores are ``NEG_INF = -1e30``, finite, so a fully masked
tile gives no NaN. The window and the softcap are the reference LM's local
attention and ``logit_softcap`` (``repro.models.attention._blocked_attn``,
``_sdpa``), which it computes in plain einsums; the Pallas kernel has
neither. A window must leave every query a key (``Sq - kv_len <
window``). For ``Sq == 1`` a top-left window masks nothing.

On the card the wrapper routes by shape and dtype:

============================  ==========================================
``Sq == 1``, either dtype     split-KV decode: partials over the key
                              ranges of :func:`decode_split_plan`, then
                              their log-sum-exp merge (two kernels)
``Sq > 1``, bfloat16          the ``mma.sync`` tensor-core kernel
``Sq > 1``, float32           the CUDA-core tile kernel
============================  ==========================================
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import CudaKernel
from repro_torch.utils import cdiv

KERNEL = CudaKernel("flash_attention", {
    "flash_prefill_f32": "ppppiiiiiiiiiffp",
    "flash_prefill_bf16": "ppppiiiiiiiiiffp",
    "flash_decode_split_f32": "ppppppiiiiiiiiffp",
    "flash_decode_split_bf16": "ppppppiiiiiiiiffp",
    "flash_decode_combine_f32": "ppppiiiip",
    "flash_decode_combine_bf16": "ppppiiiip"})
# the kernels of csrc/flash_attention.cu and the entries that launch each
KERNELS = {"decode_split": ("flash_decode_split_f32",
                            "flash_decode_split_bf16"),
           "decode_combine": ("flash_decode_combine_f32",
                              "flash_decode_combine_bf16"),
           "prefill_mma": ("flash_prefill_bf16",),
           "prefill_tile": ("flash_prefill_f32",)}
HEAD_DIMS = (64, 128)
_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
NEG_INF = -1e30
DECODE_TILE = 64  # the split plan's granule: a decode CTA's key tile
H100_SMS = 132


def check_head_dim(d: int) -> None:
    """Raise for a head dim the kernels do not take (the plain version
    takes any)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")


def launches_by_kernel() -> Dict[str, int]:
    """Launches of each kernel of ``KERNELS`` since the last reset."""
    return {name: sum(KERNEL.entry_launches[e] for e in entries)
            for name, entries in KERNELS.items()}


def decode_split_plan(sk: int, bkvh: int, target_ctas: int = 2 * H100_SMS
                      ) -> Tuple[int, int]:
    """``(splits, split_len)``: the key ranges ``[s * split_len, (s + 1) *
    split_len)`` (the last cut at ``sk``) that each of the decode's ``bkvh
    = B * KVH`` CTA rows splits the cache into. ``split_len`` is the
    longest multiple of ``DECODE_TILE`` that still gives ``splits * bkvh >=
    target_ctas``, and ``DECODE_TILE`` where the cache is too short for
    that. It depends on the cache length ``sk`` only, not on ``kv_len``,
    so the grid is the same on every decode tick; range 0 starts at key
    0."""
    want = max(1, cdiv(target_ctas, max(bkvh, 1)))
    split_len = max(DECODE_TILE, sk // want // DECODE_TILE * DECODE_TILE)
    return cdiv(sk, split_len), split_len


@functools.lru_cache(maxsize=None)
def _decode_target_ctas(device_index: int) -> int:
    """Two CTAs per SM of the card."""
    return 2 * torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def _shapes(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "[B, H, Sq, D] and two [B, KVH, Sk, D]")
    b, h, sq, d = q.shape
    _, kvh, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not pair (GQA needs H % KVH "
                         "== 0)")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"flash_attention: kv_len {kv_len} not in [1, {sk}]")
    return b, h, kvh, sq, sk, d, kv_len


def _check_window(sq: int, kv_len: int, window: int, softcap: float) -> None:
    """A window that leaves some query no key (``Sq - kv_len >= window``)
    is refused: the kernels and the plain version would average different
    masked keys there."""
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be >= 0")
    if window > 0 and sq - kv_len >= window:
        raise ValueError(f"flash_attention: window {window} leaves queries "
                         f"past {kv_len + window - 1} no key (Sq {sq}, "
                         f"kv_len {kv_len})")


def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(s / softcap) if softcap > 0 else s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          kv_len: Optional[int] = None, window: int = 0,
                          softcap: float = 0.0,
                          q_block: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the same function (one fp32 softmax over
    the whole key axis; the query heads of a group share their KV head
    without a repeat). ``q_block`` computes the same rows ``q_block``
    queries at a time, so that the fp32 scores of a long prefill need not
    be held at once."""
    b, h, kvh, sq, sk, d, kv_len = _shapes(q, k, v, kv_len)
    _check_window(sq, kv_len, window, softcap)
    if sm_scale is None:
        sm_scale = d**-0.5
    g = h // kvh
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    step = sq if q_block is None else q_block
    for q0 in range(0, sq, step):
        n = min(step, sq - q0)
        qg = q[:, :, q0:q0 + n].float().reshape(b, kvh, g * n, d)
        s = _softcap((qg @ kf.transpose(-1, -2)) * sm_scale, softcap)
        s = s.reshape(b, kvh, g, n, sk)
        qpos = q0 + torch.arange(n, device=q.device)[:, None]
        valid = kpos < kv_len
        if causal:
            valid = valid & (qpos >= kpos)
        if window > 0:
            valid = valid & (qpos - kpos < window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).reshape(b, kvh, g * n, sk)
        outs.append((p @ vf).reshape(b, h, n, d))
    return torch.cat(outs, dim=2).to(q.dtype)


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, kv_len: int, splits: int,
                          split_len: int, sm_scale: Optional[float] = None,
                          softcap: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version of the split-KV decode kernel: for q ``[B, H, 1, D]``,
    each key range's fp32 partials ``m, l [B, H, splits]`` (the range's max
    score and softmax denominator at that max) and ``o [B, H, splits, D]``
    (its unnormalized P.V); a range wholly past ``kv_len`` gives
    ``(NEG_INF, 0, 0)``."""
    b, h, kvh, sq, sk, d, kv_len = _shapes(q, k, v, kv_len)
    if sq != 1:
        raise ValueError(f"decode_partials_plain: Sq {sq}, expected 1")
    if sm_scale is None:
        sm_scale = d**-0.5
    g = h // kvh
    m = torch.full((b, h, splits), NEG_INF, device=q.device)
    l = torch.zeros((b, h, splits), device=q.device)
    o = torch.zeros((b, h, splits, d), device=q.device)
    qg = q.float().reshape(b, kvh, g, d)
    for s in range(splits):
        lo, hi = s * split_len, min((s + 1) * split_len, kv_len)
        if lo >= hi:
            continue
        sc = _softcap((qg @ k[:, :, lo:hi].float().transpose(-1, -2))
                      * sm_scale, softcap)
        ms = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - ms)
        m[:, :, s] = ms.reshape(b, h)
        l[:, :, s] = p.sum(-1).reshape(b, h)
        o[:, :, s] = (p @ v[:, :, lo:hi].float()).reshape(b, h, d)
    return m, l, o


def decode_combine_plain(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the combine kernel: the log-sum-exp merge of the
    partials (``src/repro/parallel/decode_attention.py``'s cross-shard
    merge) -> ``[B, H, 1, D]`` in ``dtype``."""
    big_m = m.amax(-1, keepdim=True)
    w = torch.exp(m - big_m)
    big_l = (l * w).sum(-1)
    out = (o * w[..., None]).sum(-2) / torch.clamp(big_l, min=1e-30)[..., None]
    return out[:, :, None].to(dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernels
    (anything else raises). ``sm_scale`` defaults to ``D ** -0.5``,
    ``kv_len`` to ``Sk``; ``window`` 0 is no window, ``softcap`` 0 no
    cap. A DTensor or a fake tensor goes through the operator :data:`OP`
    instead, whose DTensor rule and fake implementation serve the dry-run
    (:mod:`repro_torch.launch.dryrun`: a DTensor of meta blocks, whose
    blocks the operator's fake implementation serves)."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.models.common import is_dtensor

    if not (is_dtensor(q) or isinstance(q, FakeTensor)):
        return _route(q, k, v, causal=causal, sm_scale=sm_scale,
                      kv_len=kv_len, window=window, softcap=softcap)
    d, sk = q.shape[-1], k.shape[2]
    return OP(q, k, v, causal, float(d**-0.5 if sm_scale is None
                                     else sm_scale),
              int(sk if kv_len is None else kv_len), int(window),
              float(softcap))


def _route(q, k, v, **kw) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch_kernel(q, k, v, **kw)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def OP(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
       sm_scale: float, kv_len: int, window: int,
       softcap: float) -> torch.Tensor:
    """B6 as an operator: :func:`flash_attention` with every argument
    given, routed as it routes a plain tensor."""
    return _route(q, k, v, causal=causal, sm_scale=sm_scale, kv_len=kv_len,
                  window=window, softcap=softcap)


@OP.register_fake
def _(q, k, v, causal, sm_scale, kv_len, window, softcap):
    """The output's shape and dtype, contiguous as both routes return it,
    the arguments checked as a launch checks them; no memory is
    touched."""
    _, _, _, sq, _, _, kv_len = _shapes(q, k, v, kv_len)
    _check_window(sq, kv_len, window, softcap)
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """The two products of attention: ``2 B H Sq Sk D`` each (q.k over D,
    then p.v over Sk), the masked scores included, as ``sdpa``'s formula
    counts them."""
    b, h, sq, d = q_shape
    return 4 * b * h * sq * k_shape[2] * d


def _register_sharding() -> None:
    """B6's DTensor rule, one mesh dim at a time: all replicated; the
    batch split (q, k, v and the output on dim 0); or the heads split (dim
    1), where every mesh dim of more than one rank divides both the query
    and the KV heads, so that each rank's query heads read its own KV
    heads. Keys split over the sequence (the long-context caches) match
    neither and are gathered whole before the call."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, causal, sm_scale, kv_len, window, softcap):
        rest = [None] * 5
        out = [([Replicate()], [Replicate()] * 3 + rest),
               ([Shard(0)], [Shard(0)] * 3 + rest)]
        h, kvh = q.shape[1], k.shape[1]
        if all(h % n == 0 and kvh % n == 0 for n in q.mesh.shape if n > 1):
            out.append(([Shard(1)], [Shard(1)] * 3 + rest))
        return out


_register_sharding()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernels read 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _checked(q, k, v, kv_len):
    """What every launch checks before it builds anything."""
    b, h, kvh, sq, sk, d, kv_len = _shapes(q, k, v, kv_len)
    check_head_dim(d)
    if q.dtype not in _TAG:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{tuple(_TAG)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention: {name} must be {q.dtype} on "
                            f"{q.device}")
    return b, h, kvh, sq, sk, d, kv_len


def _launch_kernel(q, k, v, *, causal, sm_scale, kv_len, window: int = 0,
                   softcap: float = 0.0) -> torch.Tensor:
    b, h, kvh, sq, sk, d, kv_len = _checked(q, k, v, kv_len)
    _check_window(sq, kv_len, window, softcap)
    if sm_scale is None:
        sm_scale = d**-0.5
    if sq == 1:  # the window masks nothing for query 0
        if causal:  # top-left: the one query (position 0) sees key 0 only
            kv_len = 1
        splits, split_len = decode_split_plan(
            sk, b * kvh, _decode_target_ctas(q.device.index or 0))
        parts = decode_partials(q, k, v, kv_len=kv_len, splits=splits,
                                split_len=split_len, sm_scale=sm_scale,
                                softcap=softcap)
        return decode_combine(*parts, q.dtype)
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if b == 0 or h == 0:
        return out
    with torch.cuda.device(q.device):
        KERNEL.call(f"flash_prefill_{_TAG[q.dtype]}", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kvh,
                    sq, sk, d, kv_len, int(causal), int(window),
                    float(sm_scale), float(softcap),
                    torch.cuda.current_stream().cuda_stream)
    return out


def decode_partials(q, k, v, *, kv_len: int, splits: int, split_len: int,
                    sm_scale: Optional[float] = None, softcap: float = 0.0):
    """The split-KV decode kernel on CUDA tensors alone: the partials of
    :func:`decode_partials_plain`, in fp32 scratch from ``torch.empty``."""
    b, h, kvh, sq, sk, d, kv_len = _checked(q, k, v, kv_len)
    if sq != 1:
        raise ValueError(f"decode_partials: Sq {sq}, expected 1")
    if sm_scale is None:
        sm_scale = d**-0.5
    q, k, v = (_aligned(t) for t in (q, k, v))
    m = torch.empty((b, h, splits), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((b, h, splits, d), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0:
        return m, l, o
    with torch.cuda.device(q.device):
        KERNEL.call(f"flash_decode_split_{_TAG[q.dtype]}", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
                    o.data_ptr(), b, h, kvh, sk, d, kv_len, splits,
                    split_len, float(sm_scale), float(softcap),
                    torch.cuda.current_stream().cuda_stream)
    return m, l, o


def decode_combine(m, l, o, dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel on CUDA tensors alone: the partials' log-sum-exp
    merge, ``[B, H, 1, D]`` in ``dtype``."""
    b, h, splits, d = o.shape
    check_head_dim(d)
    out = torch.empty((b, h, 1, d), dtype=dtype, device=o.device)
    if b == 0 or h == 0:
        return out
    m, l, o = (_aligned(t) for t in (m, l, o))
    with torch.cuda.device(o.device):
        KERNEL.call(f"flash_decode_combine_{_TAG[dtype]}", m.data_ptr(),
                    l.data_ptr(), o.data_ptr(), out.data_ptr(), b, h, d,
                    splits, torch.cuda.current_stream().cuda_stream)
    return out
