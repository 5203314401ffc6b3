"""Flat ray batches, the unified streaming tick and session sharding (port
of ``repro.core.raybatch``).

A tick's work becomes flat, session-major ray batches: every session's
reference rays ``[S * HW, 3]`` and the compacted hole rays, each row tagged
with its session (segment) so the streaming gather keeps per-session RIT
capacity; results segment-scatter back to frames. Session sharding lays
the session axis over the ranks of a process group (:func:`make_mesh`):
each rank renders its contiguous block of sessions, and the results are
gathered back to every rank.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import sparw
from repro_torch.core.config import ShardConfig
from repro_torch.kernels import streaming_pipeline
from repro_torch.nerf import rays, volrend
from repro_torch.optim.adamw import tree_flatten
from repro_torch.parallel import dist as pdist


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


# ---------------------------------------------------------------------------
# unified streaming tick (fused reference -> warp -> hole fill)
# ---------------------------------------------------------------------------


class DeferredFrames:
    """Frames whose dense overflow fallback is decided at their first host
    read. The reference decides it inside its tick program (``lax.cond``);
    the port's tick program reads nothing back, so it hands this decision
    to whoever reads the frames.

    ``sparse_frames`` [S, N, H, W, 3] hold the warped colours with the
    sparse fill in the holes ``holes`` [S, N, H, W]. Where session ``s``
    overflowed (``overflowed`` [S] bool), :attr:`frames` takes
    ``dense_fill()`` ([S, N, H*W, 3], the dense re-render of every target,
    run once for all S sessions) in its holes instead: bit for bit the
    in-tick rule ``where(holes, where(overflowed, dense, sparse),
    warped)``. The first read of :attr:`frames` syncs the host when a
    fallback is possible; ``dense_fill`` None means no fallback.
    """

    def __init__(self, sparse_frames: torch.Tensor, holes: torch.Tensor,
                 overflowed: torch.Tensor,
                 dense_fill: Optional[Callable[[], torch.Tensor]]):
        self.sparse_frames = sparse_frames
        self.holes = holes
        self.overflowed = overflowed
        self._dense_fill = dense_fill
        self._frames: Optional[torch.Tensor] = None

    @property
    def frames(self) -> torch.Tensor:
        if self._frames is None:
            frames = self.sparse_frames
            if self._dense_fill is not None and bool(self.overflowed.any()):
                s, n, h, w = self.holes.shape
                dense = self._dense_fill().reshape(s, n, h, w, 3)
                pick = (self.overflowed[:, None, None, None, None]
                        & self.holes[..., None])
                frames = torch.where(pick, dense, frames)
            self._frames, self._dense_fill = frames, None
        return self._frames


class StreamingTickResult(DeferredFrames):
    """One fused tick's outputs plus the reference it hands to the next
    tick (tick ``t`` warps the reference tick ``t-1``'s sweep rendered and
    renders tick ``t+1``'s in its own sweep): ``hole_counts`` [S, N] true
    (uncapped) hole counts, ``fine_counts`` the same (the fused tick has
    no adaptive split), ``next_rgb_ref`` [S, H, W, 3] and ``next_dep_ref``
    [S, H, W]; the frames as in :class:`DeferredFrames`."""

    def __init__(self, sparse_frames: torch.Tensor, holes: torch.Tensor,
                 hole_counts: torch.Tensor, overflowed: torch.Tensor,
                 next_rgb_ref: torch.Tensor, next_dep_ref: torch.Tensor,
                 dense_fill: Optional[Callable[[], torch.Tensor]] = None):
        super().__init__(sparse_frames, holes, overflowed, dense_fill)
        self.hole_counts = hole_counts
        self.fine_counts = hole_counts
        self.next_rgb_ref = next_rgb_ref
        self.next_dep_ref = next_dep_ref


def render_tick_streaming(model, params: dict, cam: rays.Camera, *,
                          phi_deg: Optional[float],
                          rgb_ref: torch.Tensor, dep_ref: torch.Tensor,
                          ref_poses: torch.Tensor, tgt_poses: torch.Tensor,
                          next_ref_poses: torch.Tensor,
                          win_lens: torch.Tensor, caps: torch.Tensor,
                          pool_caps: torch.Tensor, bucket: int,
                          ref_cap_factor: int = 2
                          ) -> StreamingTickResult:
    """The unified streaming tick: warp -> pooled compaction -> ONE fused
    gather (kernel B3; B5 when ``params`` carry a ``scene_of_seg`` map
    over stacked scene pages) serving both this tick's hole fill and the
    next tick's reference render -> decode -> composite -> segment scatter.

    ``rgb_ref``/``dep_ref`` (posed at ``ref_poses``) were rendered by the
    previous tick or by ``DeviceSparwEngine.prime_reference``. ``bucket``
    is the pooled hole capacity; ``win_lens``/``caps``/``pool_caps`` [S]
    mean what they mean on the staged path. Nothing is read back: the
    result carries ``overflowed`` and the hole masks, and no dense
    fallback (``DeviceSparwEngine`` attaches one).
    """
    s, n = tgt_poses.shape[:2]
    h, w = cam.height, cam.width
    hw = h * w
    c = model.cfg
    ns = c.num_samples
    dev = tgt_poses.device
    # warp LAST tick's reference into this tick's targets + pool holes
    warped = sparw.warp_frames_flat(rgb_ref, dep_ref, ref_poses, tgt_poses,
                                    cam, phi_deg=phi_deg)
    holes = warped.holes.reshape(s, n, hw)
    live = torch.arange(n, device=dev)[None, :] < win_lens[:, None]
    counts = torch.sum(holes & live[:, :, None], dim=2)
    frame_over = torch.amax(torch.where(live, counts, 0), dim=1) > caps
    addr, totals = sparw.compact_holes_pooled(holes, bucket, live)
    hole_batch, flat_addr = pack_hole_rays_pooled(cam, tgt_poses, addr)
    ref_batch = pack_reference_rays(cam, next_ref_poses)
    # both ray sets sampled, gathered through ONE table sweep
    pts_h, t_h = rays.sample_along_rays(hole_batch.origins, hole_batch.dirs,
                                        c.near, c.far, ns)
    pts_r, t_r = rays.sample_along_rays(ref_batch.origins, ref_batch.dirs,
                                        c.near, c.far, ns)
    scene_of_seg = params.get("scene_of_seg")
    sample_sets = (pts_h.reshape(-1, 3), hole_batch.seg.repeat_interleave(ns),
                   pts_r.reshape(-1, 3), ref_batch.seg.repeat_interleave(ns))
    if scene_of_seg is not None:
        # mixed-scene slot batch: each segment gathers from its own
        # scene's page of the stacked resident set (kernel B5)
        feats_h, feats_r = streaming_pipeline.gather_features_tick_scenes(
            params["table"], params["mv_table"], scene_of_seg,
            model.streaming_cfg, *sample_sets, num_seg=s,
            ref_cap_factor=ref_cap_factor)
    else:
        feats_h, feats_r = streaming_pipeline.gather_features_tick(
            params["table"], params["mv_table"], model.streaming_cfg,
            *sample_sets, num_seg=s, ref_cap_factor=ref_cap_factor)
    sig_h, rgb_h = model.decode_features(
        params, feats_h, hole_batch.dirs.repeat_interleave(ns, dim=0))
    sig_r, rgb_r = model.decode_features(
        params, feats_r, ref_batch.dirs.repeat_interleave(ns, dim=0))
    fill_col, _, _ = volrend.composite(sig_h.reshape(-1, ns),
                                       rgb_h.reshape(-1, ns, 3), t_h,
                                       c.far, c.white_bkgd)
    ref_col, ref_dep, _ = volrend.composite(sig_r.reshape(-1, ns),
                                            rgb_r.reshape(-1, ns, 3), t_r,
                                            c.far, c.white_bkgd)
    valid = (torch.arange(bucket, device=dev)[None, :]
             < totals[:, None]).reshape(-1)
    fill = scatter_segments(fill_col, flat_addr, valid,
                            s * n * hw).reshape(s, n, hw, 3)
    frames = torch.where(holes[..., None], fill,
                         warped.rgb.reshape(s, n, hw, 3))
    return StreamingTickResult(frames.reshape(s, n, h, w, 3), warped.holes,
                               counts, frame_over | (totals > pool_caps),
                               ref_col.reshape(s, h, w, 3),
                               ref_dep.reshape(s, h, w))


def substitute_reference_rows(mask: torch.Tensor, rgb_new: torch.Tensor,
                              dep_new: torch.Tensor, rgb_ref: torch.Tensor,
                              dep_ref: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows with ``mask`` [S] True take the freshly primed reference; every
    other row keeps the running cross-tick reference bitwise (an
    elementwise select). ``rgb`` [S, H, W, 3], ``dep`` [S, H, W]."""
    m = mask[:, None, None]
    return (torch.where(m[..., None], rgb_new, rgb_ref),
            torch.where(m, dep_new, dep_ref))


# ---------------------------------------------------------------------------
# session sharding (ShardConfig -> torch.distributed ranks)
# ---------------------------------------------------------------------------


def make_mesh(shard: Optional[ShardConfig], device_type: str = "cuda"
              ) -> Optional[DeviceMesh]:
    """The 1-D session mesh for ``shard`` over the process group's first
    ``shard.num_devices`` ranks, or None when sharding is off.

    Raises ``ValueError`` when no process group is initialized or it has
    fewer ranks, and on a rank outside the mesh: silently falling back
    would hide a misconfigured fleet.
    """
    if shard is None or not shard.enabled:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < shard.num_devices:
        raise ValueError(
            f"ShardConfig requests {shard.num_devices} devices but the "
            f"process group has {world} ranks (torch.distributed."
            f"init_process_group: one rank per device)")
    mesh = DeviceMesh(device_type, list(range(shard.num_devices)),
                      mesh_dim_names=(shard.axis_name,))
    if dist.get_rank() >= shard.num_devices:
        raise ValueError(f"rank {dist.get_rank()} is outside the session "
                         f"mesh of the first {shard.num_devices} ranks")
    return mesh


def session_sharding(mesh: DeviceMesh
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """This rank's contiguous block of a tensor's leading (session) axis,
    ``S / D`` sessions (a view); trailing axes are whole."""
    ax = pdist.axis(mesh, 0)

    def block(t: torch.Tensor) -> torch.Tensor:
        per = t.shape[0] // ax.size
        return t[ax.rank * per:(ax.rank + 1) * per]
    return block


def replicated_sharding(mesh: DeviceMesh) -> Callable[[Any], Any]:
    """One logical copy on every rank: each tensor of a tree (model
    params, the MVoxel table) broadcast from the mesh's first rank."""
    group = pdist.axis(mesh, 0).group

    def replicate(tree):
        leaves, unflatten = tree_flatten(tree)
        return unflatten([pdist.broadcast(t, group)
                          if isinstance(t, torch.Tensor) else t
                          for t in leaves])
    return replicate


def shard_session_inputs(mesh: DeviceMesh, *arrays: Optional[torch.Tensor]
                         ) -> Tuple[Optional[torch.Tensor], ...]:
    """Each array's block under :func:`session_sharding` (None stays
    None)."""
    block = session_sharding(mesh)
    return tuple(None if a is None else block(a) for a in arrays)


def gather_sessions(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`session_sharding`: every rank's block,
    concatenated along the session axis, on every rank."""
    return pdist.all_gather0(t, pdist.axis(mesh, 0).group)
