"""The Gathering Unit: per-MVoxel gather + trilinear interpolation.

Ports of two Pallas TPU kernels of ``repro.kernels.gather_trilerp`` as
hand-written CUDA kernels (see the note in each source for its bound and
design):

* B1, ``gather_trilerp_mvoxels_segmented`` -> ``csrc/gather_trilerp.cu``;
* B4, ``gather_trilerp_mvoxels_per_seg`` (mixed-scene: each segment reads
  its own scene's tables) -> ``csrc/gather_trilerp_per_seg.cu``.

Shapes: ``mv_table [num_mv, P, C]`` (float32 or bfloat16) or, for B4, the
resident pages ``[K, num_mv, P, C]`` with the segment->page map
``scene_of_seg [num_seg]`` (int32, on the tables' device);
``ids [num_seg * num_mv, cap, 8]`` int32 local row ids (pad: 0),
``weights`` the same shape in float32 (pad: 0) ->
``out [num_seg * num_mv, cap, C]`` in the table's dtype, segment-major.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel("gather_trilerp", {"gather_trilerp_f32": "ppppiiiiiiiip",
                                       "gather_trilerp_bf16": "ppppiiiiiiiip"})
_ENTRY = {torch.float32: "gather_trilerp_f32",
          torch.bfloat16: "gather_trilerp_bf16"}
KERNEL_PER_SEG = CudaKernel(
    "gather_trilerp_per_seg", {"gather_trilerp_per_seg_f32": "pppppiiiiiiip",
                               "gather_trilerp_per_seg_bf16": "pppppiiiiiiip"})
_ENTRY_PER_SEG = {torch.float32: "gather_trilerp_per_seg_f32",
                  torch.bfloat16: "gather_trilerp_per_seg_bf16"}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
MAX_GRID_Y = 65535  # CTA rows of a grid: one per MVoxel
CTA_ROWS = 256  # RIT rows a CTA of B1 or B5 owns at the main path's caps


class LaunchPlan(NamedTuple):
    """A gather kernel's grid: ``grid`` = (CTA columns, num_mv), CTAs of
    ``threads`` threads, one RIT row each; ``columns[x]`` = (set, first
    row) of CTA column x (set 0: the only set of B1, B5's hole rows; set
    1: B5's reference rows). Every CTA walks all the segments."""
    grid: Tuple[int, int]
    threads: int
    columns: Tuple[Tuple[int, int], ...]


def cta_rows(cap: int) -> int:
    """Rows a CTA owns: ``CTA_ROWS`` from a cap of ``CTA_ROWS`` up, else
    the cap rounded up to a warp (32), so a small cap leaves few threads
    idle."""
    return min(CTA_ROWS, max(32, -(-cap // 32) * 32))


def gather_grid(num_mv: int, cap: int) -> LaunchPlan:
    """B1's grid: ``ceil(cap / R)`` CTAs of R = :func:`cta_rows` threads per
    MVoxel, column x owning rows ``[R x, R x + R)``."""
    r = cta_rows(cap)
    tiles = -(-cap // r)
    return LaunchPlan((tiles, num_mv), r,
                      tuple((0, x * r) for x in range(tiles)))


def gather_smem_bytes(p: int, c: int, elem_bytes: int) -> int:
    """B1's shared memory: one halo block ``[P, C]`` in the table's dtype,
    or 0 where that exceeds one H100 block's shared memory, and the
    kernel reads the block in place (through L1 and L2) instead."""
    nbytes = p * c * elem_bytes
    return nbytes if nbytes <= _SMEM_LIMIT else 0


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned address (a copy when it is
    not): the gather kernels read each RIT row's ids and weights as two
    16-byte vectors."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def per_seg_smem_bytes(p: int, c: int, elem_bytes: int) -> int:
    """B4's shared memory: two halo blocks ``[P, C]`` in the pages' dtype
    (the staged page and the prefetched next one), each rounded up to 16
    bytes."""
    return 2 * (-(-p * c * elem_bytes // 16) * 16)


def per_seg_staging(p: int, c: int, elem_bytes: int) -> int:
    """What B4's and B5's wrappers hand their kernels: the two buffers'
    bytes (:func:`per_seg_smem_bytes`) where they fit in one H100 block's
    shared memory, else 0, and the kernel reads each segment's page
    block in place (through L1 and L2) instead; the twin of
    :func:`gather_smem_bytes`."""
    nbytes = per_seg_smem_bytes(p, c, elem_bytes)
    return nbytes if nbytes <= _SMEM_LIMIT else 0


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
    if num_mv > MAX_GRID_Y:
        raise ValueError(f"gather_trilerp: {num_mv} MVoxels, the grid takes "
                         f"at most {MAX_GRID_Y}")
    mv_table = mv_table.contiguous()
    ids, weights = aligned16(ids), aligned16(weights)
    out = torch.empty((rows, cap, c), dtype=mv_table.dtype,
                      device=mv_table.device)
    if out.numel() == 0:
        return out
    plan = gather_grid(num_mv, cap)
    with torch.cuda.device(mv_table.device):
        KERNEL.call(_ENTRY[mv_table.dtype], mv_table.data_ptr(),
                    ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
                    num_mv, num_seg, p, c, cap, plan.grid[0], plan.threads,
                    gather_smem_bytes(p, c, mv_table.element_size()),
                    torch.cuda.current_stream().cuda_stream)
    return out


def gather_trilerp_mvoxels(mv_table: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The ``num_seg = 1`` case: [num_mv, cap, C]."""
    return gather_trilerp_mvoxels_segmented(mv_table, ids, weights,
                                            num_seg=1)


def gather_trilerp_per_seg_plain(pages: torch.Tensor,
                                 scene_of_seg: torch.Tensor,
                                 ids: torch.Tensor, weights: torch.Tensor,
                                 num_seg: int) -> torch.Tensor:
    """Plain PyTorch version of B4: segment ``s`` gathers from page
    ``scene_of_seg[s]`` with :func:`gather_trilerp_plain`'s arithmetic, so
    it is bit-equal to that function on the page. A page outside ``[0,
    K)`` gives NaN rows, as the kernel does."""
    k, num_mv, _, c = pages.shape
    cap = ids.shape[1]
    tbl = pages.float()
    scn = scene_of_seg.long()
    valid = (scn >= 0) & (scn < k)
    page = torch.where(valid, scn, 0)[:, None, None]
    ids4 = ids.reshape(num_seg, num_mv, cap, 8).long()
    w4 = weights.reshape(num_seg, num_mv, cap, 8).float()
    mv = torch.arange(num_mv, device=pages.device)[None, :, None]
    acc = torch.zeros((num_seg, num_mv, cap, c), device=pages.device)
    for v in range(8):
        acc = acc + w4[..., v:v + 1] * tbl[page, mv, ids4[..., v]]
    acc = torch.where(valid[:, None, None, None], acc, float("nan"))
    return acc.to(pages.dtype).reshape(num_seg * num_mv, cap, c)


def gather_trilerp_mvoxels_per_seg(pages: torch.Tensor,
                                   scene_of_seg: torch.Tensor,
                                   ids: torch.Tensor, weights: torch.Tensor,
                                   *, num_seg: int) -> torch.Tensor:
    """Mixed-scene GU (B4): segment ``s`` gathers from the halo tables of
    page ``scene_of_seg[s]`` of the resident set ``pages [K, num_mv, P,
    C]``. CPU tensors take the plain version; CUDA tensors launch the
    kernel (anything else raises). The map stays on the device: the
    kernel walks it, prefetching the next page's block into a second
    shared buffer, or reads each page's block in place where two blocks
    do not fit in shared memory (:func:`per_seg_staging`)."""
    if pages.device.type == "cpu":
        return gather_trilerp_per_seg_plain(pages, scene_of_seg, ids,
                                            weights, num_seg)
    if pages.device.type != "cuda":
        raise ValueError(f"gather_trilerp_per_seg: no kernel for device "
                         f"{pages.device}")
    k, num_mv, p, c = pages.shape
    rows = num_seg * num_mv
    cap = ids.shape[1]
    if pages.dtype not in _ENTRY_PER_SEG:
        raise TypeError(f"gather_trilerp_per_seg: table dtype {pages.dtype}")
    if ids.dtype != torch.int32 or weights.dtype != torch.float32 \
            or scene_of_seg.dtype != torch.int32:
        raise TypeError("gather_trilerp_per_seg: ids and scene_of_seg must "
                        "be int32 and weights float32, got "
                        f"{ids.dtype} / {scene_of_seg.dtype} / "
                        f"{weights.dtype}")
    if ids.shape != (rows, cap, 8) or weights.shape != ids.shape \
            or scene_of_seg.shape != (num_seg,):
        raise ValueError(f"gather_trilerp_per_seg: ids {tuple(ids.shape)} / "
                         f"weights {tuple(weights.shape)} / scene_of_seg "
                         f"{tuple(scene_of_seg.shape)} do not match "
                         f"({rows}, cap, 8) / ({num_seg},)")
    for t in (ids, weights, scene_of_seg):
        if t.device != pages.device:
            raise ValueError("gather_trilerp_per_seg: inputs on different "
                             "devices")
    pages, scene_of_seg = pages.contiguous(), scene_of_seg.contiguous()
    ids, weights = aligned16(ids), aligned16(weights)
    out = torch.empty((rows, cap, c), dtype=pages.dtype, device=pages.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(pages.device):
        KERNEL_PER_SEG.call(
            _ENTRY_PER_SEG[pages.dtype], pages.data_ptr(),
            scene_of_seg.data_ptr(), ids.data_ptr(), weights.data_ptr(),
            out.data_ptr(), k, num_mv, num_seg, p, c, cap,
            per_seg_staging(p, c, pages.element_size()),
            torch.cuda.current_stream().cuda_stream)
    return out
