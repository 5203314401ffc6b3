"""Kernel entry points: arrange host-visible shapes into kernel geometry
(port of ``repro.kernels.ops``, with its mixed-scene ``scene_of_seg`` path
and the flash-attention wrapper ``mha``)."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import streaming
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_nerf_mlp as _mlp
from repro_torch.kernels import gather_trilerp as _gt
from repro_torch.kernels import streaming_pipeline as _sp
from repro_torch.nerf import grids
from repro_torch.utils import round_up


class RitBlocks(NamedTuple):
    """What the GU kernel consumes, plus what the scatter back needs."""

    rit: streaming.RIT
    ids: torch.Tensor  # [num_slots, cap, 8] int32 local row ids (pad: 0)
    weights: torch.Tensor  # [num_slots, cap, 8] float32 (pad: 0)
    num_seg: int  # segments of the kernel grid (1 unless seg-bucketed)


def rit_blocks(points: torch.Tensor, cfg: streaming.StreamingCfg, *,
               seg: Optional[torch.Tensor] = None, num_seg: int = 1,
               scened: bool = False) -> RitBlocks:
    """Build the RIT and the per-bucket id/weight blocks for ``points``.

    With ``seg`` and ``num_seg > 1`` (or ``scened``, the mixed-scene path,
    at any ``num_seg``) buckets are combined ``(segment, MVoxel)`` ids,
    segment-major, and samples with ``seg >= num_seg`` (chunk padding)
    drop out of the table. Otherwise the buckets are plain MVoxel ids, so
    at ``num_seg == 1`` padding samples DO take capacity — the reference's
    rule, kept so overflow sets match.
    """
    mv = streaming.mvoxel_ids(points, cfg)
    num_mv = cfg.num_mvoxels
    if seg is not None and (num_seg > 1 or scened):
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
                              num_seg: int = 1,
                              scene_of_seg: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Memory-centric feature gather of ``points`` from a dense vertex
    table: build the RIT, run the GU kernel per MVoxel, scatter back to
    sample order; samples past RIT capacity take the reference gather (the
    paper's fallback). Matches ``grids.gather_trilerp_ref`` on ``table``.

    ``mv_table`` is the prebuilt halo re-layout of ``table``
    (``NerfModel.prepare_streaming`` caches it); built here when omitted.
    ``seg``/``num_seg`` bucket the RIT per (segment, MVoxel) — see
    :func:`rit_blocks`.

    ``scene_of_seg`` ([num_seg] int32, needs ``seg``) selects the
    mixed-scene path: ``table`` is the stacked resident set ``[K, res^3,
    C]``, ``mv_table`` the stacked halo tables ``[K, num_mv, P, C]`` (both
    required), and each segment gathers from its own scene's page (kernel
    B4); the overflow fallback reads each sample's own scene's table.
    """
    scened = scene_of_seg is not None
    if scened and seg is None:
        raise ValueError("scene_of_seg requires the seg array (the segment"
                         "->scene map is indexed by segment id)")
    s = points.shape[0]
    c = table.shape[-1]
    if mv_table is None:
        if scened:
            raise ValueError("mixed-scene gather needs the prebuilt stacked "
                             "mv_table [K, num_mv, P, C]")
        mv_table = streaming.build_mvoxel_table(table, cfg)
    blocks = rit_blocks(points, cfg, seg=seg, num_seg=num_seg, scened=scened)
    if scened:
        out_mv = _gt.gather_trilerp_mvoxels_per_seg(
            mv_table, scene_of_seg, blocks.ids, blocks.weights,
            num_seg=num_seg)
    else:
        out_mv = _gt.gather_trilerp_mvoxels_segmented(
            mv_table, blocks.ids, blocks.weights, num_seg=blocks.num_seg)
    # scatter back to sample order; pad rows land in the dump row s
    samples = blocks.rit.samples
    dst = torch.where(samples >= 0, samples, s).reshape(-1)
    feats = table.new_zeros((s + 1, c))
    feats[dst] = out_mv.reshape(-1, c)
    # overflow fallback: the pixel-centric gather for the spilled samples
    gids, gw = grids.corner_ids_weights(points, cfg.grid_res)
    if scened:
        scn = scene_of_seg[torch.clamp(seg, 0, num_seg - 1)]
        fallback = _sp.gather_trilerp_ref_scened(table, scn, gids, gw)
    else:
        fallback = grids.gather_trilerp_ref(table, gids, gw)
    return torch.where(blocks.rit.overflow[:, None], fallback, feats[:s])


def nerf_mlp(feats: torch.Tensor, direnc: torch.Tensor, params: dict
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused decoder over the ``mlp`` decoder params: (sigma [S], rgb [S,3])."""
    out = _mlp.fused_nerf_mlp(
        feats, direnc, params["w1"], params["b1"], params["w2"],
        params["b2"], params["w_sigma"], params["w_rgb"], params["b_rgb"])
    return out[:, 0], out[:, 1:4]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, block_q: int = 128, block_k: int = 128
        ) -> torch.Tensor:
    """Flash attention (kernel B6) with the reference wrapper's padding
    rule. q [B,H,Sq,D], k/v [B,KVH,Sk,D]: the sequences are zero-padded to
    multiples of ``min(block, max(S, 8))`` and, when K/V was padded,
    ``kv_len`` masks the padded rows; the result is cut back to Sq.

    The padding serves the TPU kernel's block shape; the CUDA kernel takes
    any Sq, Sk and kv_len, so here it only costs copies. The port's LM
    layers call ``flash_attention`` directly, not this wrapper."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    bq = min(block_q, max(sq, 8))
    bk = min(block_k, max(sk, 8))
    sqp, skp = round_up(sq, bq), round_up(sk, bk)
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n))
    out = _fa.flash_attention(pad(q, sqp - sq), pad(k, skp - sk),
                              pad(v, skp - sk), causal=causal,
                              sm_scale=d**-0.5,
                              kv_len=sk if skp > sk else None)
    return out[:, :, :sq]
