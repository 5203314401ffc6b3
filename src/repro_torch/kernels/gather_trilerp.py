"""The Gathering Unit (B1): per-MVoxel gather + trilinear interpolation.

Port of ``repro.kernels.gather_trilerp.gather_trilerp_mvoxels_segmented``
(a Pallas TPU kernel) as a hand-written CUDA kernel,
``csrc/gather_trilerp.cu``; see the note there for its bound and design.

Shapes: ``mv_table [num_mv, P, C]`` (float32 or bfloat16),
``ids [num_seg * num_mv, cap, 8]`` int32 local row ids (pad: 0),
``weights`` the same shape in float32 (pad: 0) ->
``out [num_seg * num_mv, cap, C]`` in the table's dtype, segment-major.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel("gather_trilerp", {"gather_trilerp_f32": "ppppiiiiip",
                                       "gather_trilerp_bf16": "ppppiiiiip"})
_ENTRY = {torch.float32: "gather_trilerp_f32",
          torch.bfloat16: "gather_trilerp_bf16"}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def gather_trilerp_plain(mv_table: torch.Tensor, ids: torch.Tensor,
                         weights: torch.Tensor, num_seg: int) -> torch.Tensor:
    """Plain PyTorch version: the same arithmetic, corner by corner in v
    order with fp32 accumulation."""
    num_mv, _, c = mv_table.shape
    cap = ids.shape[1]
    tbl = mv_table.float()
    ids4 = ids.reshape(num_seg, num_mv, cap, 8).long()
    w4 = weights.reshape(num_seg, num_mv, cap, 8).float()
    mv = torch.arange(num_mv, device=mv_table.device)[None, :, None]
    acc = torch.zeros((num_seg, num_mv, cap, c), device=mv_table.device)
    for v in range(8):
        acc = acc + w4[..., v:v + 1] * tbl[mv, ids4[..., v]]
    return acc.to(mv_table.dtype).reshape(num_seg * num_mv, cap, c)


def gather_trilerp_mvoxels_segmented(mv_table: torch.Tensor,
                                     ids: torch.Tensor, weights: torch.Tensor,
                                     *, num_seg: int) -> torch.Tensor:
    """Segment-aware GU: CPU tensors take the plain version; CUDA tensors
    launch the kernel (anything else raises)."""
    if mv_table.device.type == "cpu":
        return gather_trilerp_plain(mv_table, ids, weights, num_seg)
    if mv_table.device.type != "cuda":
        raise ValueError(f"gather_trilerp: no kernel for device "
                         f"{mv_table.device}")
    num_mv, p, c = mv_table.shape
    rows = num_seg * num_mv
    cap = ids.shape[1]
    if mv_table.dtype not in _ENTRY:
        raise TypeError(f"gather_trilerp: table dtype {mv_table.dtype}")
    if ids.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError("gather_trilerp: ids must be int32 and weights "
                        f"float32, got {ids.dtype} / {weights.dtype}")
    if ids.shape != (rows, cap, 8) or weights.shape != ids.shape:
        raise ValueError(f"gather_trilerp: ids {tuple(ids.shape)} / weights "
                         f"{tuple(weights.shape)} do not match "
                         f"({rows}, cap, 8)")
    for t in (ids, weights):
        if t.device != mv_table.device:
            raise ValueError("gather_trilerp: inputs on different devices")
    if p * c * 4 > _SMEM_LIMIT:
        raise ValueError(f"gather_trilerp: halo block [{p}, {c}] exceeds "
                         "shared memory")
    mv_table, ids, weights = (t.contiguous() for t in (mv_table, ids,
                                                       weights))
    out = torch.empty((rows, cap, c), dtype=mv_table.dtype,
                      device=mv_table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(mv_table.device):
        KERNEL.call(_ENTRY[mv_table.dtype], mv_table.data_ptr(),
                    ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
                    num_mv, num_seg, p, c, cap,
                    torch.cuda.current_stream().cuda_stream)
    return out


def gather_trilerp_mvoxels(mv_table: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The ``num_seg = 1`` case: [num_mv, cap, C]."""
    return gather_trilerp_mvoxels_segmented(mv_table, ids, weights,
                                            num_seg=1)
