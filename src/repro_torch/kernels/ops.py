"""Kernel entry points: arrange host-visible shapes into kernel geometry
(port of ``repro.kernels.ops``; the mixed-scene ``scene_of_seg`` path and
attention are not ported yet)."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import streaming
from repro_torch.kernels import fused_nerf_mlp as _mlp
from repro_torch.kernels import gather_trilerp as _gt
from repro_torch.nerf import grids


class RitBlocks(NamedTuple):
    """What the GU kernel consumes, plus what the scatter back needs."""

    rit: streaming.RIT
    ids: torch.Tensor  # [num_slots, cap, 8] int32 local row ids (pad: 0)
    weights: torch.Tensor  # [num_slots, cap, 8] float32 (pad: 0)
    num_seg: int  # segments of the kernel grid (1 unless seg-bucketed)


def rit_blocks(points: torch.Tensor, cfg: streaming.StreamingCfg, *,
               seg: Optional[torch.Tensor] = None,
               num_seg: int = 1) -> RitBlocks:
    """Build the RIT and the per-bucket id/weight blocks for ``points``.

    With ``seg`` and ``num_seg > 1`` buckets are combined ``(segment,
    MVoxel)`` ids, segment-major, and samples with ``seg >= num_seg``
    (chunk padding) drop out of the table. With ``num_seg == 1`` the
    buckets are plain MVoxel ids, so padding samples DO take capacity —
    the reference's rule, kept so overflow sets match.
    """
    mv = streaming.mvoxel_ids(points, cfg)
    num_mv = cfg.num_mvoxels
    if seg is not None and num_seg > 1:
        bucket = torch.where(seg < num_seg, seg * num_mv + mv,
                             num_seg * num_mv)
        num_slots, kernel_seg = num_seg * num_mv, num_seg
    else:
        bucket, num_slots, kernel_seg = mv, num_mv, 1
    rit = streaming.build_rit(bucket, cfg, num_slots=num_slots)
    local_ids, w = streaming.local_corner_ids(points, cfg)
    local_ids = streaming.remap_local_ids(local_ids, cfg)
    slot = torch.clamp(rit.samples, min=0)
    valid = (rit.samples >= 0)[..., None]
    ids = torch.where(valid, local_ids[slot], 0).to(torch.int32)
    weights = torch.where(valid, w[slot], 0.0)
    return RitBlocks(rit, ids, weights, kernel_seg)


def gather_features_streaming(table: torch.Tensor, points: torch.Tensor,
                              cfg: streaming.StreamingCfg, *,
                              mv_table: Optional[torch.Tensor] = None,
                              seg: Optional[torch.Tensor] = None,
                              num_seg: int = 1) -> torch.Tensor:
    """Memory-centric feature gather of ``points`` from a dense vertex
    table: build the RIT, run the GU kernel per MVoxel, scatter back to
    sample order; samples past RIT capacity take the reference gather (the
    paper's fallback). Matches ``grids.gather_trilerp_ref`` on ``table``.

    ``mv_table`` is the prebuilt halo re-layout of ``table``
    (``NerfModel.prepare_streaming`` caches it); built here when omitted.
    ``seg``/``num_seg`` bucket the RIT per (segment, MVoxel) — see
    :func:`rit_blocks`.
    """
    s = points.shape[0]
    c = table.shape[-1]
    if mv_table is None:
        mv_table = streaming.build_mvoxel_table(table, cfg)
    blocks = rit_blocks(points, cfg, seg=seg, num_seg=num_seg)
    out_mv = _gt.gather_trilerp_mvoxels_segmented(
        mv_table, blocks.ids, blocks.weights, num_seg=blocks.num_seg)
    # scatter back to sample order; pad rows land in the dump row s
    samples = blocks.rit.samples
    dst = torch.where(samples >= 0, samples, s).reshape(-1)
    feats = table.new_zeros((s + 1, c))
    feats[dst] = out_mv.reshape(-1, c)
    # overflow fallback: the pixel-centric gather for the spilled samples
    gids, gw = grids.corner_ids_weights(points, cfg.grid_res)
    fallback = grids.gather_trilerp_ref(table, gids, gw)
    return torch.where(blocks.rit.overflow[:, None], fallback, feats[:s])


def nerf_mlp(feats: torch.Tensor, direnc: torch.Tensor, params: dict
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused decoder over the ``mlp`` decoder params: (sigma [S], rgb [S,3])."""
    out = _mlp.fused_nerf_mlp(
        feats, direnc, params["w1"], params["b1"], params["w2"],
        params["b2"], params["w_sigma"], params["w_rgb"], params["b_rgb"])
    return out[:, 0], out[:, 1:4]
