"""Fully-streaming (memory-centric) NeRF rendering, device parts (port of
``repro.core.streaming``; the numpy cache/traffic statistics are not
ported yet).

Memory-centric rendering walks *MVoxels* (blocks of voxel vertices, paper:
8x8x8 points) in DRAM order and serves whichever ray samples live in the
resident MVoxel. Samples are known up front, so the reorder is one global
sort per call (:func:`build_rit`); samples past an MVoxel's capacity fall
back to the non-streaming gather.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

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


def mvoxel_ids(points: torch.Tensor, cfg: StreamingCfg) -> torch.Tensor:
    """MVoxel id per sample (x-major over the MVoxel grid). [S] int64."""
    base, _ = _base_and_frac(points, cfg.grid_res)
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


@functools.lru_cache(maxsize=None)
def layout_row_map(cfg: StreamingCfg) -> Tuple[np.ndarray, int]:
    """(row_of_point [(edge+1)^3], padded row count) for the bank-interleaved
    layout: point ``p`` is stored at row ``rank_within_bank(p) * num_banks +
    bank(p)``, with bank ``(4x + 2y + z) mod num_banks``, so a voxel's 8
    corners occupy 8 distinct banks. Pad rows are zero and never selected."""
    p = cfg.mvoxel_edge + 1
    x, y, z = np.meshgrid(np.arange(p), np.arange(p), np.arange(p),
                          indexing="ij")
    banks = ((4 * x + 2 * y + z) % cfg.num_banks).reshape(-1)
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
