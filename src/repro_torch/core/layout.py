"""On-chip data layout and the SRAM bank-conflict model (paper section
IV-B, figs. 6 and 13); a numpy copy of ``repro.core.layout``.

Feature-major layout: all channels of vertex ``v`` live in bank ``v % B``.
With P concurrent PEs each gathering a *different ray sample's* vertex, two
PEs hitting the same bank stall: the conflict rate depends on the run
(on the camera pose), ~52% on average in the paper.

Channel-major layout: channel ``c`` of *every* vertex lives in bank ``c``;
each PE owns one channel and bank, so concurrent accesses are conflict-free
by construction (0%): the PE-to-bank map is static.

``bank_conflict_stats`` simulates the feature-major case (fig. 6 and the
cost model's gather-stall term); ``channel_major_view`` is the layout
transform, channels on the leading axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class SramCfg:
    num_banks: int = 16
    concurrent_rays: int = 16  # concurrent queries (PEs) per cycle
    ports_per_bank: int = 1


def feature_major_banks(vertex_ids: np.ndarray, cfg: SramCfg) -> np.ndarray:
    """Bank of each request under feature-major layout (Fig. 13a)."""
    return vertex_ids % cfg.num_banks


def bank_conflict_stats(vertex_ids: np.ndarray, cfg: SramCfg) -> Dict[str, float]:
    """Simulate concurrent vertex fetches under the feature-major layout.

    ``vertex_ids``: [S, 8] — per ray sample, its 8 corner vertices. Each cycle
    the engine requests corner ``k`` for ``concurrent_rays`` consecutive samples
    (the paper's Fig. 13 scenario). A cycle with ``r`` requests to the same
    bank costs ``ceil(r / ports)`` bank-cycles; conflict rate = fraction of
    requests beyond the first per bank-cycle group.
    """
    s = (vertex_ids.shape[0] // cfg.concurrent_rays) * cfg.concurrent_rays
    ids = vertex_ids[:s].reshape(-1, cfg.concurrent_rays, 8)  # [G, R, 8]
    banks = ids % cfg.num_banks
    total_requests = banks.size
    conflicts = 0
    stall_cycles = 0
    ideal_cycles = ids.shape[0] * 8
    # vectorized per (group, corner): count multiplicity per bank
    for k in range(8):
        b = banks[:, :, k]  # [G, R]
        counts = np.zeros((b.shape[0], cfg.num_banks), np.int32)
        np.add.at(counts, (np.arange(b.shape[0])[:, None], b), 1)
        served_per_cycle = cfg.ports_per_bank
        cycles = np.ceil(counts / served_per_cycle).max(axis=1)  # bottleneck bank
        stall_cycles += int((cycles - 1).clip(min=0).sum())
        conflicts += int((counts - served_per_cycle).clip(min=0).sum())
    return {
        "layout": "feature_major",
        "requests": float(total_requests),
        "conflict_rate": conflicts / max(total_requests, 1),
        "stall_cycles": float(stall_cycles),
        "ideal_cycles": float(ideal_cycles),
        "actual_cycles": float(ideal_cycles + stall_cycles),
        "slowdown": (ideal_cycles + stall_cycles) / max(ideal_cycles, 1),
    }


def channel_major_stats(vertex_ids: np.ndarray, cfg: SramCfg) -> Dict[str, float]:
    """Channel-major layout (Fig. 13b): PE ``c`` reads bank ``c`` only —
    statically conflict-free regardless of the run-time vertex ids."""
    ideal_cycles = (vertex_ids.shape[0] // cfg.concurrent_rays) * 8
    return {
        "layout": "channel_major",
        "requests": float(vertex_ids.size),
        "conflict_rate": 0.0,
        "stall_cycles": 0.0,
        "ideal_cycles": float(ideal_cycles),
        "actual_cycles": float(ideal_cycles),
        "slowdown": 1.0,
    }


def channel_major_view(table: np.ndarray) -> np.ndarray:
    """Layout transform [P, C] -> [C, P]: channel on the leading axis, one
    bank per channel."""
    return np.ascontiguousarray(table.T)
