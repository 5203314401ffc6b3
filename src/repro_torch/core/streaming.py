"""Fully-streaming (memory-centric) NeRF rendering (port of
``repro.core.streaming``).

Memory-centric rendering walks *MVoxels* (blocks of voxel vertices, paper:
8x8x8 points) in DRAM order and serves whichever ray samples live in the
resident MVoxel. Samples are known up front, so the reorder is one global
sort per call (:func:`build_rit`); samples past an MVoxel's capacity fall
back to the non-streaming gather.

The device parts (MVoxel ids, the halo table and its on-chip layout, the
RIT, :func:`streaming_gather`) are tensor code; the statistics behind the
paper's figures 4-6 and the cost model (the bank-conflict factor, the
pixel-centric access stream through an LRU cache, the streaming traffic)
are numpy and host Python, as in the reference.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.nerf import grids


@dataclass(frozen=True)
class StreamingCfg:
    grid_res: int = 64  # vertices per scene edge
    mvoxel_edge: int = 8  # vertices per MVoxel edge (paper: 8^3 points)
    capacity: int = 512  # RIT entry capacity (samples per MVoxel)
    # row order of the staged halo block: "identity" keeps halo points
    # x-major; "bank_interleaved" places them so the 8 corners of every
    # voxel fall in 8 distinct banks. A pure row permutation (plus zero pad
    # rows), so gathered features are identical across layouts.
    layout: str = "identity"
    num_banks: int = 8

    @property
    def mv_per_edge(self) -> int:
        return (self.grid_res + self.mvoxel_edge - 1) // self.mvoxel_edge

    @property
    def num_mvoxels(self) -> int:
        return self.mv_per_edge**3

    @property
    def halo_points(self) -> int:
        return (self.mvoxel_edge + 1) ** 3

    @property
    def halo_rows(self) -> int:
        """Rows of the staged halo block under this layout."""
        if self.layout == "identity":
            return self.halo_points
        return layout_row_map(self)[1]


def _base_and_frac(points: torch.Tensor, res: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    g = grids.to_grid_coords(points, res)
    base = torch.floor(g)
    return base.long(), g - base


def sample_base_coords(points: torch.Tensor, res: int) -> torch.Tensor:
    """Integer base-corner coordinates of each sample's voxel. [S, 3]
    int64."""
    return _base_and_frac(points, res)[0]


def mvoxel_ids(points: torch.Tensor, cfg: StreamingCfg) -> torch.Tensor:
    """MVoxel id per sample (x-major over the MVoxel grid). [S] int64."""
    base = sample_base_coords(points, cfg.grid_res)
    mv = base // cfg.mvoxel_edge
    m = cfg.mv_per_edge
    return (mv[:, 0] * m + mv[:, 1]) * m + mv[:, 2]


def local_corner_ids(points: torch.Tensor, cfg: StreamingCfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner indices inside the sample's MVoxel halo block + weights:
    (local_ids [S,8] in [0, (edge+1)^3), weights [S,8])."""
    e = cfg.mvoxel_edge
    base, frac = _base_and_frac(points, cfg.grid_res)
    c = (base % e)[:, None, :] + grids.corners(points.device)[None]
    p = e + 1
    ids = (c[..., 0] * p + c[..., 1]) * p + c[..., 2]
    return ids, grids.trilerp_weights(frac)


def halo_point_banks(cfg: StreamingCfg) -> np.ndarray:
    """Target SRAM bank per halo point, [(edge+1)^3] int: ``(4x + 2y + z)
    mod num_banks``. With 8 banks the 8 corners of any voxel (offsets
    ``4a + 2b + c``, a, b, c in {0, 1}) take all 8 residues, so every
    trilerp's concurrent corner reads hit 8 distinct banks."""
    p = cfg.mvoxel_edge + 1
    x, y, z = np.meshgrid(np.arange(p), np.arange(p), np.arange(p),
                          indexing="ij")
    return ((4 * x + 2 * y + z) % cfg.num_banks).reshape(-1)


@functools.lru_cache(maxsize=None)
def layout_row_map(cfg: StreamingCfg) -> Tuple[np.ndarray, int]:
    """(row_of_point [(edge+1)^3], padded row count) for the bank-interleaved
    layout: point ``p`` is stored at row ``rank_within_bank(p) * num_banks +
    bank(p)`` (:func:`halo_point_banks`), so a voxel's 8 corners occupy 8
    distinct banks. Pad rows are zero and never selected."""
    banks = halo_point_banks(cfg)
    b = cfg.num_banks
    rank = np.zeros_like(banks)
    for bank in range(b):
        sel = banks == bank
        rank[sel] = np.arange(int(sel.sum()))
    rows = (rank * b + banks).astype(np.int64)
    padded = b * int(np.bincount(banks, minlength=b).max())
    return rows, padded


@functools.lru_cache(maxsize=None)
def _rows_on(cfg: StreamingCfg, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(layout_row_map(cfg)[0], device=device)


def apply_layout(mv_table: torch.Tensor, cfg: StreamingCfg) -> torch.Tensor:
    """Re-lay the halo blocks ``[num_mv, P, C]`` for ``cfg.layout``
    (identity: unchanged; bank_interleaved: rows scattered to their
    interleaved positions, zero pad rows)."""
    if cfg.layout == "identity":
        return mv_table
    num_mv, _, c = mv_table.shape
    out = mv_table.new_zeros((num_mv, layout_row_map(cfg)[1], c))
    out[:, _rows_on(cfg, mv_table.device)] = mv_table
    return out


def remap_local_ids(local_ids: torch.Tensor, cfg: StreamingCfg
                    ) -> torch.Tensor:
    """Map x-major local corner ids to the layout's physical rows."""
    if cfg.layout == "identity":
        return local_ids
    return _rows_on(cfg, local_ids.device)[local_ids]


def bank_conflict_factor(cfg: StreamingCfg) -> float:
    """Mean SRAM-bank serialization of one trilerp's 8 concurrent corner
    reads (1.0 = conflict-free; k = the worst bank serves k corners), over
    every voxel base of the halo block, with bank = row mod ``num_banks``.
    The identity (x-major) layout collides, since the corner offsets
    ``{1, edge+1, (edge+1)^2, ...}`` share residues mod 8; the interleaved
    layout is 1.0 by construction."""
    e, p, b = cfg.mvoxel_edge, cfg.mvoxel_edge + 1, cfg.num_banks
    if cfg.layout == "identity":
        row_of = np.arange(p**3, dtype=np.int64)
    else:
        row_of = layout_row_map(cfg)[0].astype(np.int64)
    base = np.stack(np.meshgrid(np.arange(e), np.arange(e), np.arange(e),
                                indexing="ij"), -1).reshape(-1, 3)
    corners = base[:, None, :] + np.asarray(grids._CORNER_LIST)[None, :, :]
    ids = (corners[..., 0] * p + corners[..., 1]) * p + corners[..., 2]
    bank = row_of[ids] % b  # [voxels, 8]
    worst = np.array([np.bincount(row, minlength=b).max() for row in bank])
    return float(worst.mean())


def build_mvoxel_table(table: torch.Tensor, cfg: StreamingCfg
                       ) -> torch.Tensor:
    """Global vertex table [res^3, C] -> per-MVoxel halo blocks
    [num_mv, halo_rows, C], MVoxels x-major; the grid is edge-padded so
    every halo block is full at the boundary."""
    res, e, m = cfg.grid_res, cfg.mvoxel_edge, cfg.mv_per_edge
    p = e + 1
    grid = table.reshape(res, res, res, -1)
    edge = torch.clamp(torch.arange(m * e + 1, device=table.device),
                       max=res - 1)  # edge padding by index clamping
    grid = grid[edge][:, edge][:, :, edge]
    blocks = grid.unfold(0, p, e).unfold(1, p, e).unfold(2, p, e)
    # [m, m, m, C, p, p, p] -> [num_mv, p^3, C]
    blocks = blocks.permute(0, 1, 2, 4, 5, 6, 3).reshape(
        cfg.num_mvoxels, p**3, -1)
    return apply_layout(blocks.contiguous(), cfg)


class RIT(NamedTuple):
    samples: torch.Tensor  # [num_slots, capacity] sample ids (-1 pad)
    counts: torch.Tensor  # [num_slots] samples held (clipped at capacity)
    overflow: torch.Tensor  # [S] bool — not held: fallback path


def build_rit(mv: torch.Tensor, cfg: StreamingCfg,
              num_slots: Optional[int] = None) -> RIT:
    """Ray Index Table over ``num_slots`` buckets (default one per MVoxel).

    Samples are ranked within their bucket in sample order (a stable sort,
    as the reference's); the first ``capacity`` of each bucket are held,
    the rest overflow. Ids ``>= num_slots`` (chunk padding routed to the
    dump segment) are dropped entirely: no capacity, no overflow.
    """
    n_slots = cfg.num_mvoxels if num_slots is None else num_slots
    cap = cfg.capacity
    s = mv.shape[0]
    dev = mv.device
    mv_sorted, order = torch.sort(mv, stable=True)
    # each bucket's first position in the sorted ids, and the end of the
    # last; their differences are the counts (``torch.bincount`` would
    # read the ids' range back to the host)
    starts = torch.searchsorted(mv_sorted,
                                torch.arange(n_slots + 1, device=dev,
                                             dtype=mv.dtype))
    rank = torch.arange(s, device=dev) \
        - starts[torch.clamp(mv_sorted, max=n_slots - 1)]
    in_range = mv_sorted < n_slots
    keep = (rank < cap) & in_range
    slot = mv_sorted * cap + torch.clamp(rank, max=cap - 1)
    dump = n_slots * cap  # one extra row takes every dropped write
    flat = torch.full((dump + 1,), -1, dtype=torch.int64, device=dev)
    flat[torch.where(keep, slot, dump)] = order
    counts = starts[1:] - starts[:-1]
    overflow = torch.zeros(s, dtype=torch.bool, device=dev)
    overflow[order] = ~keep & in_range
    return RIT(flat[:dump].reshape(n_slots, cap),
               torch.clamp(counts, max=cap), overflow)


def streaming_gather(table: torch.Tensor, points: torch.Tensor,
                     cfg: StreamingCfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-centric feature gather: samples processed in MVoxel-sorted
    order (a stable sort), then put back. Returns (features [S, C], order
    [S]). Equal to the pixel-centric gather; the order is what changes the
    DRAM trace. Plain tensor code, as in the reference (no kernel)."""
    order = torch.argsort(mvoxel_ids(points, cfg), stable=True)
    ids, w = grids.corner_ids_weights(points[order], cfg.grid_res)
    feats_sorted = grids.gather_trilerp_ref(table, ids, w)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return feats_sorted[inv], order


# ---------------------------------------------------------------------------
# DRAM and cache statistics (the cost model's and figs. 4-5's inputs)
# ---------------------------------------------------------------------------


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def vertex_access_stream(points, res: int) -> np.ndarray:
    """Vertex ids in pixel-centric access order, 8 a sample: [S*8]."""
    ids, _ = grids.corner_ids_weights(
        torch.as_tensor(_numpy(points), dtype=torch.float32), res)
    return ids.numpy().reshape(-1)


def lru_cache_stats(addresses: np.ndarray, cache_lines: int,
                    line_addrs: int = 8) -> Dict[str, float]:
    """LRU cache simulation at line granularity (host Python, as the
    reference's).

    ``addresses``: vertex ids in access order; a line holds ``line_addrs``
    consecutive vertices. Returns the miss rate and the streaming fraction
    (the share of DRAM fetches whose line follows the previous fetch's).
    """
    lines = _numpy(addresses) // line_addrs
    lru: OrderedDict[int, None] = OrderedDict()
    misses = 0
    seq = 0
    last_fetch = -(10**9)
    for ln in lines.tolist():
        if ln in lru:
            lru.move_to_end(ln)
            continue
        misses += 1
        if ln == last_fetch + 1:
            seq += 1
        last_fetch = ln
        lru[ln] = None
        if len(lru) > cache_lines:
            lru.popitem(last=False)
    total = len(lines)
    return {
        "accesses": float(total),
        "miss_rate": misses / max(total, 1),
        "dram_fetches": float(misses),
        "streaming_fraction": seq / max(misses, 1),
        "non_streaming_fraction": 1.0 - seq / max(misses, 1),
    }


def streaming_traffic(mv, cfg: StreamingCfg, channels: int,
                      bytes_per_el: int = 4) -> Dict[str, float]:
    """DRAM traffic of the fully-streaming walk: each *touched* MVoxel
    halo block is fetched once, sequentially. ``mv``: MVoxel ids (an
    array or a tensor on any device)."""
    touched = np.unique(_numpy(mv))
    block_bytes = cfg.halo_points * channels * bytes_per_el
    return {
        "mvoxels_touched": float(len(touched)),
        "bytes": float(len(touched) * block_bytes),
        "streaming_fraction": 1.0,
        "non_streaming_fraction": 0.0,
    }


def pixel_centric_traffic(points, res: int, channels: int,
                          cache_bytes: int = 2 * 2**20,
                          bytes_per_el: int = 4) -> Dict[str, float]:
    """Pixel-centric DRAM traffic through a small on-chip cache (paper:
    2 MB)."""
    stream = vertex_access_stream(points, res)
    line_addrs = 8
    line_bytes = line_addrs * channels * bytes_per_el
    stats = lru_cache_stats(stream,
                            cache_lines=max(cache_bytes // line_bytes, 1),
                            line_addrs=line_addrs)
    stats["bytes"] = stats["dram_fetches"] * line_bytes
    return stats
