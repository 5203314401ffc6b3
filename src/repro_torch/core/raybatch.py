"""Flat ray batches (port of the staged parts of ``repro.core.raybatch``).

A tick's work becomes flat, session-major ray batches: every session's
reference rays ``[S * HW, 3]`` and the compacted hole rays, each row tagged
with its session (segment) so the streaming gather keeps per-session RIT
capacity; results segment-scatter back to frames.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.nerf import rays


class FlatRays(NamedTuple):
    """A flat, session-major ray batch. ``seg`` maps each ray to its
    session in ``[0, num_seg)``; chunk padding uses ``num_seg`` (the dump
    segment)."""

    origins: torch.Tensor  # [F, 3]
    dirs: torch.Tensor  # [F, 3]
    seg: torch.Tensor  # [F] int64


def _seg_ids(s: int, per: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).repeat_interleave(per)


def pack_reference_rays(cam: rays.Camera, ref_poses: torch.Tensor
                        ) -> FlatRays:
    """All S sessions' reference-frame rays as one flat batch [S*HW, 3]."""
    s = ref_poses.shape[0]
    o, d = rays.generate_rays_batch(cam, ref_poses)  # [S, HW, 3]
    return FlatRays(o.reshape(-1, 3), d.reshape(-1, 3),
                    _seg_ids(s, o.shape[1], ref_poses.device))


def pack_hole_rays(cam: rays.Camera, tgt_poses: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[FlatRays, torch.Tensor]:
    """Per-frame compacted hole rays as one flat batch.

    ``tgt_poses`` [S, N, 4, 4], ``idx`` [S, N, cap] hole pixel ids ->
    (rays [S*N*cap], flat pixel addresses ``(s*N + n) * HW + pixel``)."""
    s, n, cap = idx.shape
    hw = cam.height * cam.width
    o_all, d_all = rays.generate_rays_batch(cam, tgt_poses.reshape(-1, 4, 4))
    seg_off = (torch.arange(s * n, device=idx.device) * hw).reshape(s, n, 1)
    addr = (seg_off + idx).reshape(-1)
    return (FlatRays(o_all.reshape(-1, 3)[addr], d_all.reshape(-1, 3)[addr],
                     _seg_ids(s, n * cap, idx.device)), addr)


def pack_hole_rays_pooled(cam: rays.Camera, tgt_poses: torch.Tensor,
                          addr: torch.Tensor
                          ) -> Tuple[FlatRays, torch.Tensor]:
    """Pooled hole rays as one ``[S * bucket]`` flat batch.

    ``addr`` [S, bucket] frame-local addresses ``n*HW + pixel`` ->
    (rays, global addresses ``s*N*HW + local``); session ``s`` owns rows
    ``[s*bucket, (s+1)*bucket)``."""
    s, bucket = addr.shape
    n = tgt_poses.shape[1]
    hw = cam.height * cam.width
    o_all, d_all = rays.generate_rays_batch(cam, tgt_poses.reshape(-1, 4, 4))
    flat = (torch.arange(s, device=addr.device)[:, None] * (n * hw)
            + addr).reshape(-1)
    return (FlatRays(o_all.reshape(-1, 3)[flat], d_all.reshape(-1, 3)[flat],
                     _seg_ids(s, bucket, addr.device)), flat)


def scatter_segments(values: torch.Tensor, addr: torch.Tensor,
                     valid: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter flat results ``values`` [F, C] to pixel ``addr`` [F] of a
    ``[size, C]`` zero buffer; rows with ``valid`` False land in one dump
    row past the end and are dropped."""
    out = values.new_zeros((size + 1, values.shape[-1]))
    out[torch.where(valid, addr, size)] = values
    return out[:size]
