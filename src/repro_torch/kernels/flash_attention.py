"""Flash attention (B6): GQA attention with an fp32 online softmax, the
LM layers' prefill and decode attention.

Port of ``repro.kernels.flash_attention.flash_attention`` (a Pallas TPU
kernel) as a hand-written CUDA kernel, ``csrc/flash_attention.cu``; see the
note there for its bound and design.

``q [B, H, Sq, D]``, ``k``/``v [B, KVH, Sk, D]`` with ``H % KVH == 0``
(query head ``h`` reads KV head ``h // (H // KVH)``) -> ``[B, H, Sq, D]``
in ``q``'s dtype. Scores ``(q . k) * sm_scale`` in fp32; keys at or past
``kv_len`` are masked, and with ``causal`` so are keys after the query,
counted from 0 for both (top-left alignment, as the Pallas kernel; the
reference's oracle ``attention_ref`` aligns bottom-right, and the two
differ when ``Sq != Sk``). Masked scores are ``NEG_INF = -1e30``, finite,
so a fully masked tile gives no NaN.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel("flash_attention",
                    {"flash_attention_f32": "ppppiiiiiiiifp",
                     "flash_attention_bf16": "ppppiiiiiiiifp"})
HEAD_DIMS = (64, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
NEG_INF = -1e30


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the same function (one fp32 softmax over
    the whole key axis; the query heads of a group share their KV head
    without a repeat)."""
    b, h, kvh, sq, sk, d, kv_len = _shapes(q, k, v, kv_len)
    if sm_scale is None:
        sm_scale = d**-0.5
    g = h // kvh
    qg = q.float().reshape(b, kvh, g * sq, d)
    s = (qg @ k.float().transpose(-1, -2)) * sm_scale
    s = s.reshape(b, kvh, g, sq, sk)
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = kpos < kv_len
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        valid = valid & (qpos >= kpos)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).reshape(b, kvh, g * sq, sk)
    return (p @ v.float()).reshape(b, h, sq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (anything else raises). ``sm_scale`` defaults to ``D ** -0.5`` and
    ``kv_len`` to ``Sk``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch_kernel(q, k, v, causal=causal, sm_scale=sm_scale,
                          kv_len=kv_len)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, 16-byte aligned (the kernel reads 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_kernel(q, k, v, *, causal, sm_scale, kv_len) -> torch.Tensor:
    b, h, kvh, sq, sk, d, kv_len = _shapes(q, k, v, kv_len)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{tuple(_ENTRY)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention: {name} must be {q.dtype} on "
                            f"{q.device}")
    if sm_scale is None:
        sm_scale = d**-0.5
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if b == 0 or h == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        KERNEL.call(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), b, h, kvh, sq, sk, d,
                    kv_len, int(causal), float(sm_scale),
                    torch.cuda.current_stream().cuda_stream)
    return out
