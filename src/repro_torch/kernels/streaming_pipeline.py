"""The fused streaming tick's gather stage (port of
``repro.kernels.streaming_pipeline``).

The staged tick renders the reference and the pooled hole fill as separate
chunked stages, each chunk re-streaming the whole MVoxel halo table. The
fused tick buckets the tick's pooled hole samples and the NEXT tick's
reference samples into two RITs over the same (segment, MVoxel) order, and
one kernel (B3, ``csrc/fused_gather_dual.cu``; see the note there for its
bound and design) gathers both sets from each halo block while it is
resident: one table sweep per tick.

Mixed-scene ticks (multi-scene serving) take the K resident scene pages
``[K, num_mv, P, C]`` and a segment->page map ``scene_of_seg`` on the
device: kernel B5 (``csrc/fused_gather_dual_per_seg.cu``) steers each
segment to its own scene's page, and the overflow fallback reads each
sample's own scene's dense table (:func:`gather_features_tick_scenes`).

``tick_traffic`` and ``serving_sweeps_per_tick`` are the analytic
bytes-moved accounting of this pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import streaming
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.gather_trilerp import MAX_GRID_Y, LaunchPlan, \
    aligned16, cta_rows, gather_smem_bytes, gather_trilerp_per_seg_plain, \
    gather_trilerp_plain, per_seg_smem_bytes, per_seg_staging
from repro_torch.nerf import grids

KERNEL = CudaKernel("fused_gather_dual",
                    {"fused_gather_dual_f32": "pppppppiiiiiiiiiip",
                     "fused_gather_dual_bf16": "pppppppiiiiiiiiiip"})
_ENTRY = {torch.float32: "fused_gather_dual_f32",
          torch.bfloat16: "fused_gather_dual_bf16"}
KERNEL_PER_SEG = CudaKernel(
    "fused_gather_dual_per_seg",
    {"fused_gather_dual_per_seg_f32": "ppppppppiiiiiiiiiiip",
     "fused_gather_dual_per_seg_bf16": "ppppppppiiiiiiiiiiip"})
_ENTRY_PER_SEG = {torch.float32: "fused_gather_dual_per_seg_f32",
                  torch.bfloat16: "fused_gather_dual_per_seg_bf16"}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def dual_grid(num_mv: int, cap_h: int, cap_r: int) -> LaunchPlan:
    """B3's and B5's grid: ``tiles_h + tiles_r`` CTA columns per MVoxel,
    ``tiles_x = ceil(cap_x / R)`` with R = ``cta_rows(max(cap_h, cap_r))``
    (256 at the main path's caps); columns below ``tiles_h`` own hole rows
    (set 0), the others reference rows (set 1), so no CTA mixes the
    sets."""
    r = cta_rows(max(cap_h, cap_r))
    tiles_h, tiles_r = -(-cap_h // r), -(-cap_r // r)
    columns = tuple((0, x * r) for x in range(tiles_h)) \
        + tuple((1, x * r) for x in range(tiles_r))
    return LaunchPlan((tiles_h + tiles_r, num_mv), r, columns)


def fused_gather_dual_plain(mv_table: torch.Tensor, ids_h: torch.Tensor,
                            w_h: torch.Tensor, ids_r: torch.Tensor,
                            w_r: torch.Tensor, num_seg: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the Gathering Unit's plain version on each
    set (the same arithmetic, corner by corner in v order)."""
    return (gather_trilerp_plain(mv_table, ids_h, w_h, num_seg),
            gather_trilerp_plain(mv_table, ids_r, w_r, num_seg))


def fused_gather_dual(mv_table: torch.Tensor, ids_h: torch.Tensor,
                      w_h: torch.Tensor, ids_r: torch.Tensor,
                      w_r: torch.Tensor, *, num_seg: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MVoxel-table sweep serving both tick stages.

    ``mv_table [num_mv, P, C]`` (float32 or bfloat16); ``ids_h``/``w_h``
    the hole RIT blocks ``[num_seg * num_mv, cap_h, 8]`` and
    ``ids_r``/``w_r`` the next-reference blocks ``[num_seg * num_mv,
    cap_r, 8]``, segment-major (int32 ids, float32 weights; pad rows id 0,
    weight 0) -> ``([.., cap_h, C], [.., cap_r, C])`` in the table's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (anything else raises).
    """
    if mv_table.device.type == "cpu":
        return fused_gather_dual_plain(mv_table, ids_h, w_h, ids_r, w_r,
                                       num_seg)
    if mv_table.device.type != "cuda":
        raise ValueError(f"fused_gather_dual: no kernel for device "
                         f"{mv_table.device}")
    num_mv, p, c = mv_table.shape
    rows = num_seg * num_mv
    cap_h, cap_r = ids_h.shape[1], ids_r.shape[1]
    if mv_table.dtype not in _ENTRY:
        raise TypeError(f"fused_gather_dual: table dtype {mv_table.dtype}")
    for ids, w, cap in ((ids_h, w_h, cap_h), (ids_r, w_r, cap_r)):
        if ids.dtype != torch.int32 or w.dtype != torch.float32:
            raise TypeError("fused_gather_dual: ids must be int32 and "
                            f"weights float32, got {ids.dtype} / {w.dtype}")
        if ids.shape != (rows, cap, 8) or w.shape != ids.shape:
            raise ValueError(f"fused_gather_dual: ids {tuple(ids.shape)} / "
                             f"weights {tuple(w.shape)} do not match "
                             f"({rows}, cap, 8)")
        if ids.device != mv_table.device or w.device != mv_table.device:
            raise ValueError("fused_gather_dual: inputs on different "
                             "devices")
    if num_mv > MAX_GRID_Y:
        raise ValueError(f"fused_gather_dual: {num_mv} MVoxels, the grid "
                         f"takes at most {MAX_GRID_Y}")
    mv_table = mv_table.contiguous()
    ids_h, w_h, ids_r, w_r = (aligned16(t) for t in (ids_h, w_h, ids_r, w_r))
    out_h = torch.empty((rows, cap_h, c), dtype=mv_table.dtype,
                        device=mv_table.device)
    out_r = torch.empty((rows, cap_r, c), dtype=mv_table.dtype,
                        device=mv_table.device)
    if rows == 0 or (cap_h == 0 and cap_r == 0):
        return out_h, out_r
    plan = dual_grid(num_mv, cap_h, cap_r)
    tiles_h = sum(1 for kind, _ in plan.columns if kind == 0)
    with torch.cuda.device(mv_table.device):
        KERNEL.call(_ENTRY[mv_table.dtype], mv_table.data_ptr(),
                    ids_h.data_ptr(), w_h.data_ptr(), ids_r.data_ptr(),
                    w_r.data_ptr(), out_h.data_ptr(), out_r.data_ptr(),
                    num_mv, num_seg, p, c, cap_h, cap_r, plan.grid[0],
                    tiles_h, plan.threads,
                    gather_smem_bytes(p, c, mv_table.element_size()),
                    torch.cuda.current_stream().cuda_stream)
    return out_h, out_r


def fused_gather_dual_per_seg_plain(pages: torch.Tensor,
                                    scene_of_seg: torch.Tensor,
                                    ids_h: torch.Tensor, w_h: torch.Tensor,
                                    ids_r: torch.Tensor, w_r: torch.Tensor,
                                    num_seg: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B5: B4's plain version on each set, so
    segment ``s`` is bit-equal to :func:`fused_gather_dual_plain` on page
    ``scene_of_seg[s]``."""
    return (gather_trilerp_per_seg_plain(pages, scene_of_seg, ids_h, w_h,
                                         num_seg),
            gather_trilerp_per_seg_plain(pages, scene_of_seg, ids_r, w_r,
                                         num_seg))


def fused_gather_dual_per_seg(pages: torch.Tensor, scene_of_seg: torch.Tensor,
                              ids_h: torch.Tensor, w_h: torch.Tensor,
                              ids_r: torch.Tensor, w_r: torch.Tensor, *,
                              num_seg: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-scene :func:`fused_gather_dual` (B5): segment ``s`` gathers
    both sets from page ``scene_of_seg[s]`` of the resident set ``pages
    [K, num_mv, P, C]`` (``scene_of_seg [num_seg]`` int32, on the pages'
    device). CPU tensors take the plain version; CUDA tensors launch the
    kernel (anything else raises)."""
    if pages.device.type == "cpu":
        return fused_gather_dual_per_seg_plain(pages, scene_of_seg, ids_h,
                                               w_h, ids_r, w_r, num_seg)
    if pages.device.type != "cuda":
        raise ValueError(f"fused_gather_dual_per_seg: no kernel for device "
                         f"{pages.device}")
    k, num_mv, p, c = pages.shape
    rows = num_seg * num_mv
    cap_h, cap_r = ids_h.shape[1], ids_r.shape[1]
    if pages.dtype not in _ENTRY_PER_SEG:
        raise TypeError(f"fused_gather_dual_per_seg: table dtype "
                        f"{pages.dtype}")
    if scene_of_seg.dtype != torch.int32 \
            or scene_of_seg.shape != (num_seg,) \
            or scene_of_seg.device != pages.device:
        raise ValueError("fused_gather_dual_per_seg: scene_of_seg must be "
                         f"int32 [{num_seg}] on {pages.device}, got "
                         f"{scene_of_seg.dtype} {tuple(scene_of_seg.shape)} "
                         f"on {scene_of_seg.device}")
    for ids, w, cap in ((ids_h, w_h, cap_h), (ids_r, w_r, cap_r)):
        if ids.dtype != torch.int32 or w.dtype != torch.float32:
            raise TypeError("fused_gather_dual_per_seg: ids must be int32 "
                            f"and weights float32, got {ids.dtype} / "
                            f"{w.dtype}")
        if ids.shape != (rows, cap, 8) or w.shape != ids.shape:
            raise ValueError(f"fused_gather_dual_per_seg: ids "
                             f"{tuple(ids.shape)} / weights "
                             f"{tuple(w.shape)} do not match "
                             f"({rows}, cap, 8)")
        if ids.device != pages.device or w.device != pages.device:
            raise ValueError("fused_gather_dual_per_seg: inputs on "
                             "different devices")
    if num_mv > MAX_GRID_Y:
        raise ValueError(f"fused_gather_dual_per_seg: {num_mv} MVoxels, the "
                         f"grid takes at most {MAX_GRID_Y}")
    pages, scene_of_seg = pages.contiguous(), scene_of_seg.contiguous()
    ids_h, w_h, ids_r, w_r = (aligned16(t) for t in (ids_h, w_h, ids_r, w_r))
    out_h = torch.empty((rows, cap_h, c), dtype=pages.dtype,
                        device=pages.device)
    out_r = torch.empty((rows, cap_r, c), dtype=pages.dtype,
                        device=pages.device)
    if rows == 0 or (cap_h == 0 and cap_r == 0):
        return out_h, out_r
    plan = dual_grid(num_mv, cap_h, cap_r)
    tiles_h = sum(1 for kind, _ in plan.columns if kind == 0)
    with torch.cuda.device(pages.device):
        KERNEL_PER_SEG.call(
            _ENTRY_PER_SEG[pages.dtype], pages.data_ptr(),
            scene_of_seg.data_ptr(), ids_h.data_ptr(), w_h.data_ptr(),
            ids_r.data_ptr(), w_r.data_ptr(), out_h.data_ptr(),
            out_r.data_ptr(), k, num_mv, num_seg, p, c, cap_h, cap_r,
            plan.grid[0], tiles_h, plan.threads,
            per_seg_staging(p, c, pages.element_size()),
            torch.cuda.current_stream().cuda_stream)
    return out_h, out_r


class _RitBlocks(NamedTuple):
    ids_mv: torch.Tensor  # [num_slots, cap, 8] int32 layout-remapped ids
    w_mv: torch.Tensor  # [num_slots, cap, 8] float32
    samples: torch.Tensor  # [num_slots, cap] sample ids (-1 pad)
    overflow: torch.Tensor  # [T] bool


def _rit_blocks(points: torch.Tensor, seg: torch.Tensor, num_seg: int,
                cfg: streaming.StreamingCfg) -> _RitBlocks:
    """Bucket one sample set per (segment, MVoxel) and lay its corner
    ids/weights out in RIT order (``cfg.capacity`` rows per bucket).

    Unlike ``ops.rit_blocks`` this ALWAYS buckets by (segment, MVoxel)
    with the dump bucket ``num_seg * num_mv``, also at ``num_seg = 1``: a
    sample with ``seg >= num_seg`` drops out and takes no capacity. That
    is the reference's rule for the fused tick, kept so the overflow sets
    match."""
    num_mv = cfg.num_mvoxels
    mv = streaming.mvoxel_ids(points, cfg)
    bucket = torch.where(seg < num_seg, seg * num_mv + mv, num_seg * num_mv)
    rit = streaming.build_rit(bucket, cfg, num_slots=num_seg * num_mv)
    local_ids, w = streaming.local_corner_ids(points, cfg)
    local_ids = streaming.remap_local_ids(local_ids, cfg)
    slot = torch.clamp(rit.samples, min=0)
    valid = (rit.samples >= 0)[..., None]
    ids_mv = torch.where(valid, local_ids[slot], 0).to(torch.int32)
    w_mv = torch.where(valid, w[slot], 0.0)
    return _RitBlocks(ids_mv, w_mv, rit.samples, rit.overflow)


def _scatter_with_fallback(out_mv: torch.Tensor, blocks: _RitBlocks,
                           table: torch.Tensor, points: torch.Tensor,
                           cfg: streaming.StreamingCfg,
                           scene: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """RIT-order kernel output back to sample order; RIT-overflow samples
    take the reference (pixel-centric) gather on the original table. With
    ``scene`` [T] (the mixed-scene tick) ``table`` is the stacked dense
    pages ``[K, res^3, C]`` and each sample's fallback reads its own
    scene's page."""
    t = points.shape[0]
    c = out_mv.shape[-1]
    samples = blocks.samples
    dst = torch.where(samples >= 0, samples, t).reshape(-1)
    feats = table.new_zeros((t + 1, c))
    feats[dst] = out_mv.reshape(-1, c)
    gids, gw = grids.corner_ids_weights(points, cfg.grid_res)
    fallback = (grids.gather_trilerp_ref(table, gids, gw) if scene is None
                else gather_trilerp_ref_scened(table, scene, gids, gw))
    return torch.where(blocks.overflow[:, None], fallback, feats[:t])


def gather_trilerp_ref_scened(tables: torch.Tensor, scene: torch.Tensor,
                              ids: torch.Tensor, weights: torch.Tensor
                              ) -> torch.Tensor:
    """Per-sample-scene reference gather over stacked dense tables ``[K,
    res^3, C]``: ``grids.gather_trilerp_ref``'s rows and einsum on each
    sample's own scene's table (``scene`` [S])."""
    feats = tables[scene[:, None], ids].float()  # [S, 8, C]
    return torch.einsum("svc,sv->sc", feats, weights)


def gather_features_tick_scenes(tables: torch.Tensor, mv_tables: torch.Tensor,
                                scene_of_seg: torch.Tensor,
                                cfg: streaming.StreamingCfg,
                                pts_hole: torch.Tensor,
                                seg_hole: torch.Tensor,
                                pts_ref: torch.Tensor, seg_ref: torch.Tensor,
                                *, num_seg: int, ref_cap_factor: int = 2
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-scene :func:`gather_features_tick`: one fused sweep (B5) over
    the resident scene pages.

    ``tables [K, res^3, C]`` / ``mv_tables [K, num_mv, P, C]`` are the K
    resident pages and ``scene_of_seg [num_seg]`` (int32, on their device)
    the segment->page map. RIT bucketing stays per (segment, MVoxel); each
    segment's gather and overflow fallback read only its own scene's
    rows."""
    cfg_ref = dataclasses.replace(cfg,
                                  capacity=cfg.capacity * ref_cap_factor)
    bh = _rit_blocks(pts_hole, seg_hole, num_seg, cfg)
    br = _rit_blocks(pts_ref, seg_ref, num_seg, cfg_ref)
    out_h, out_r = fused_gather_dual_per_seg(
        mv_tables, scene_of_seg, bh.ids_mv, bh.w_mv, br.ids_mv, br.w_mv,
        num_seg=num_seg)
    scn_h = scene_of_seg[torch.clamp(seg_hole, 0, num_seg - 1)]
    scn_r = scene_of_seg[torch.clamp(seg_ref, 0, num_seg - 1)]
    return (_scatter_with_fallback(out_h, bh, tables, pts_hole, cfg, scn_h),
            _scatter_with_fallback(out_r, br, tables, pts_ref, cfg, scn_r))


def gather_features_tick(table: torch.Tensor, mv_table: torch.Tensor,
                         cfg: streaming.StreamingCfg,
                         pts_hole: torch.Tensor, seg_hole: torch.Tensor,
                         pts_ref: torch.Tensor, seg_ref: torch.Tensor, *,
                         num_seg: int, ref_cap_factor: int = 2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tick's one feature-gather pass: hole-fill and next-reference
    samples through a single fused MVoxel-table sweep.

    ``pts_hole``/``seg_hole`` are this tick's pooled hole samples (seg id
    ``num_seg`` = dropped padding), ``pts_ref``/``seg_ref`` the next
    tick's reference samples, whose RIT capacity is ``ref_cap_factor``
    times ``cfg.capacity``. Returns (hole features ``[Th, C]``, reference
    features ``[Tr, C]``) in sample order.
    """
    cfg_ref = dataclasses.replace(cfg,
                                  capacity=cfg.capacity * ref_cap_factor)
    bh = _rit_blocks(pts_hole, seg_hole, num_seg, cfg)
    br = _rit_blocks(pts_ref, seg_ref, num_seg, cfg_ref)
    out_h, out_r = fused_gather_dual(mv_table, bh.ids_mv, bh.w_mv,
                                     br.ids_mv, br.w_mv, num_seg=num_seg)
    return (_scatter_with_fallback(out_h, bh, table, pts_hole, cfg),
            _scatter_with_fallback(out_r, br, table, pts_ref, cfg))


# ---------------------------------------------------------------------------
# analytic bytes-moved accounting
# ---------------------------------------------------------------------------


def halo_block_bytes(cfg: streaming.StreamingCfg, channels: int,
                     bytes_per_el: int = 4) -> int:
    """Device-memory bytes of ONE staged MVoxel halo block under
    ``cfg.layout``."""
    return cfg.halo_rows * channels * bytes_per_el


def tick_traffic(cfg: streaming.StreamingCfg, channels: int, num_seg: int,
                 cap_hole: int, cap_ref: int, bytes_per_el: int = 4
                 ) -> Dict[str, float]:
    """Analytic per-tick traffic of the fused pipeline: every halo block
    once (``mvoxel_table_bytes``), and per (segment, MVoxel) block the ids
    and weights in and the features out for both sets (``rit_bytes``)."""
    num_mv = cfg.num_mvoxels
    table_bytes = num_mv * halo_block_bytes(cfg, channels, bytes_per_el)
    per_slot = (cap_hole + cap_ref) * 8 * (4 + 4)  # ids int32 + weights f32
    out_bytes = (cap_hole + cap_ref) * channels * bytes_per_el
    rit_bytes = num_seg * num_mv * (per_slot + out_bytes)
    return {
        "mvoxel_table_sweeps": 1.0,
        "mvoxel_table_bytes": float(table_bytes),
        "rit_bytes": float(rit_bytes),
        "total_bytes": float(table_bytes + rit_bytes),
    }


def serving_sweeps_per_tick(total_ticks: int, admission_ticks: int,
                            prime_sweeps: float) -> float:
    """Amortized MVoxel-table sweeps per fused serving tick: one per tick,
    plus the staged priming render's ``prime_sweeps`` on every tick that
    admits sessions, spread over the run."""
    return 1.0 + admission_ticks * prime_sweeps / max(total_ticks, 1)
