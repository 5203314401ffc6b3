"""SpaRW render engine, staged path (port of the staged parts of
``repro.core.engine.DeviceSparwEngine``).

One warp window per call: (1) render the reference frame through the flat
ray batch, (2) warp it into every target of the window in one scatter pass
(:func:`sparw.warp_frames_flat`), (3) compact the window's holes into one
pooled ``[bucket]`` batch (:func:`sparw.compact_holes_pooled`), (4) render
that batch and segment-scatter it back, with a dense re-render of the
window when it overflows its capacity. The NeRF calls chunk exactly as the
reference's ``lax.map`` does, so every chunk's RIT — and its overflow set —
is the one the reference builds.

Not ported yet: the fused streaming tick, adaptive sampling, session
sharding and the serving-engine entry points.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import raybatch, schedule, sparw
from repro_torch.core.config import HoleCapController, RenderConfig, \
    RenderStats
from repro_torch.nerf import rays
from repro_torch.utils import round_up


class WindowResult(NamedTuple):
    frames: torch.Tensor  # [N, H, W, 3]
    hole_counts: torch.Tensor  # [N] true (uncapped) hole counts
    overflowed: torch.Tensor  # [] bool — capacity exceeded, dense fill ran


class BatchedWindowResult(NamedTuple):
    frames: torch.Tensor  # [S, N, H, W, 3]
    hole_counts: torch.Tensor  # [S, N]
    overflowed: torch.Tensor  # [S] bool — per-session dense-fallback flag


class DeviceSparwEngine:
    """Renders SpaRW warp windows for one (model, params, config).
    ``params`` are tensors on the device the engine runs on."""

    def __init__(self, model, params: dict, *, config: RenderConfig):
        config = config.resolved()
        self.config = config
        self.model = model
        self.cam = config.camera
        self.window = config.window
        self.phi_deg = config.phi_deg
        hw = self.cam.height * self.cam.width
        self.hole_cap = (int(config.hole_cap) if config.hole_cap is not None
                         else round_up(max(hw // 4, 128), 128))
        self.ray_chunk = int(config.ray_chunk)
        self.params = model.prepare_streaming(params)
        self.device = self.params["table"].device
        self._seg_aware = model.cfg.backend == "streaming"
        self.pool_holes = bool(config.pool_holes)
        self.pool_min_bucket = int(config.pool_min_bucket)
        self.pool_ctl = HoleCapController(
            worst=self.window * self.hole_cap, min_bucket=self.pool_min_bucket,
            safety=config.pool_safety, alpha=config.pool_ewma_alpha,
            fixed=config.pool_bucket)
        self.num_window_calls = 0

    def _render_rays_flat(self, params: dict, o: torch.Tensor,
                          d: torch.Tensor, seg: Optional[torch.Tensor],
                          num_seg: int, quantum: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A flat [F, 3] ray batch in chunks of ``min(ray_chunk,
        ceil(quantum / 2), F)`` rays, the last chunk padded with zero rays
        tagged with the dump segment ``num_seg``. ``quantum`` is the stage's
        per-session ray count; the chunk rule is the reference's, kept so
        each chunk's RIT holds the same samples."""
        n = o.shape[0]
        c = min(self.ray_chunk, max(-(-quantum // 2), 1), n)
        npad = round_up(n, c)
        pad = npad - n
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_zeros((pad, 3))])
            if seg is not None:
                seg = torch.cat([seg, seg.new_full((pad,), num_seg)])
        cols, deps = [], []
        for i in range(0, npad, c):
            col, dep = self.model.render_rays(
                params, o[i:i + c], d[i:i + c],
                seg=None if seg is None else seg[i:i + c], num_seg=num_seg)
            cols.append(col)
            deps.append(dep)
        return torch.cat(cols)[:n], torch.cat(deps)[:n]

    def _dense_fill_flat(self, params: dict, tgt_poses: torch.Tensor
                         ) -> torch.Tensor:
        """Dense re-render of every target frame — the overflow fallback,
        itself one flat batch. [S, N, HW, 3]."""
        s, n = tgt_poses.shape[:2]
        hw = self.cam.height * self.cam.width
        o, d = rays.generate_rays_batch(self.cam, tgt_poses.reshape(-1, 4, 4))
        seg = (torch.arange(s, device=self.device).repeat_interleave(n * hw)
               if self._seg_aware else None)
        col, _ = self._render_rays_flat(params, o.reshape(-1, 3),
                                        d.reshape(-1, 3), seg, s,
                                        quantum=n * hw)
        return col.reshape(s, n, hw, 3)

    def _pooled_fill(self, params: dict, tgt_poses: torch.Tensor,
                     holes: torch.Tensor, live: torch.Tensor, bucket: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sparse fill over a pooled [S * bucket] hole batch, chunked at
        ``quantum = pool_min_bucket`` (bucket-independent, as in the
        reference). Returns ([S, N, HW, 3] sparse frames, [S] totals)."""
        s, n = tgt_poses.shape[:2]
        hw = self.cam.height * self.cam.width
        addr, totals = sparw.compact_holes_pooled(holes, bucket, live)
        batch, flat_addr = raybatch.pack_hole_rays_pooled(self.cam, tgt_poses,
                                                          addr)
        fill, _ = self._render_rays_flat(
            params, batch.origins, batch.dirs,
            batch.seg if self._seg_aware else None, s,
            quantum=self.pool_min_bucket)
        valid = (torch.arange(bucket, device=self.device)[None, :]
                 < totals[:, None]).reshape(-1)
        sparse = raybatch.scatter_segments(fill, flat_addr, valid, s * n * hw)
        return sparse.reshape(s, n, hw, 3), totals

    def _render_windows(self, params: dict, ref_poses: torch.Tensor,
                        tgt_poses: torch.Tensor, win_lens: torch.Tensor,
                        caps: torch.Tensor, pool_caps: torch.Tensor,
                        bucket: int) -> BatchedWindowResult:
        """S sessions' windows through the staged stages (1)-(4).

        ``win_lens`` [S] masks padded frames out of the overflow decision,
        ``caps`` [S] are per-frame hole capacities and ``pool_caps`` [S]
        per-session pool capacities. ``bucket == 0`` selects the per-frame
        fixed-capacity hole batch instead of the pooled one. A session that
        overflows takes its frames from the dense fill.
        """
        s, n = tgt_poses.shape[:2]
        h, w = self.cam.height, self.cam.width
        hw = h * w
        cap = self.hole_cap
        # (1) one flat reference render across all sessions' rays
        ref = raybatch.pack_reference_rays(self.cam, ref_poses)
        col, dep = self._render_rays_flat(
            params, ref.origins, ref.dirs,
            ref.seg if self._seg_aware else None, s, quantum=hw)
        # (2)(3) one flat warp scatter pass + hole compaction
        warped = sparw.warp_frames_flat(col.reshape(s, h, w, 3),
                                        dep.reshape(s, h, w), ref_poses,
                                        tgt_poses, self.cam,
                                        phi_deg=self.phi_deg)
        holes = warped.holes.reshape(s, n, hw)
        live = torch.arange(n, device=self.device)[None, :] < win_lens[:, None]
        counts = torch.sum(holes & live[:, :, None], dim=2)  # [S, N]
        frame_over = torch.amax(torch.where(live, counts, 0), dim=1) > caps
        if bucket == 0:
            # (4) per-frame fixed-capacity flat hole batch [S*N*cap]
            idx, _ = sparw.compact_holes_flat(holes, cap)
            batch, addr = raybatch.pack_hole_rays(self.cam, tgt_poses, idx)
            fill, _ = self._render_rays_flat(
                params, batch.origins, batch.dirs,
                batch.seg if self._seg_aware else None, s, quantum=n * cap)
            valid = (torch.arange(cap, device=self.device)[None, None, :]
                     < counts[..., None])
            sparse = raybatch.scatter_segments(
                fill, addr, valid.reshape(-1), s * n * hw).reshape(s, n, hw, 3)
            overflowed = frame_over
        else:
            # (4) pooled: the window's holes share one [S*bucket] batch
            sparse, totals = self._pooled_fill(params, tgt_poses, holes, live,
                                               bucket)
            overflowed = frame_over | (totals > pool_caps)
        fill = sparse
        if bool(overflowed.any()):
            dense = self._dense_fill_flat(params, tgt_poses)
            fill = torch.where(overflowed[:, None, None, None], dense, sparse)
        frames = torch.where(holes[..., None], fill,
                             warped.rgb.reshape(s, n, hw, 3))
        return BatchedWindowResult(frames.reshape(s, n, h, w, 3), counts,
                                   overflowed)

    def _bucket(self) -> int:
        return self.pool_ctl.bucket if self.pool_holes else 0

    def render_windows(self, ref_poses: torch.Tensor, tgt_poses: torch.Tensor
                       ) -> BatchedWindowResult:
        """S sessions' full windows ([S,4,4] references vs [S,N,4,4]
        targets) at the engine's capacities."""
        s, n = tgt_poses.shape[:2]
        bucket = self._bucket()
        full = lambda v: torch.full((s,), v, device=self.device)
        self.num_window_calls += 1
        with torch.no_grad():
            return self._render_windows(
                self.params, ref_poses.to(self.device),
                tgt_poses.to(self.device), full(n), full(self.hole_cap),
                full(bucket), bucket)

    def render_window(self, ref_pose: torch.Tensor, tgt_poses: torch.Tensor
                      ) -> WindowResult:
        """One warp window: N target poses vs a shared reference pose."""
        res = self.render_windows(ref_pose[None], tgt_poses[None])
        return WindowResult(res.frames[0], res.hole_counts[0],
                            res.overflowed[0])

    def _observe_window(self, res: WindowResult) -> None:
        """Feed a finished window's hole total to the pool controller."""
        if self.pool_holes:
            self.pool_ctl.observe(int(res.hole_counts.sum()))

    def render_trajectory(self, poses: List[torch.Tensor]
                          ) -> Tuple[List[torch.Tensor], RenderStats]:
        """SpaRW over a pose trajectory (off-trajectory schedule).

        Before dispatching window ``i`` the pool controller observes window
        ``i-2`` — the reference's two-window pipeline delay, kept so the
        bucket ladder (and so every overflow decision) matches. The
        controller resets at entry, so a cached engine acts like a new one.
        """
        plan = schedule.WarpSchedule(self.window, "offtraj").windows(poses)
        hw = self.cam.height * self.cam.width
        frames: List[Optional[torch.Tensor]] = [None] * len(poses)
        stats = RenderStats()
        results = []
        self.pool_ctl.reset()
        pending: List[WindowResult] = []
        for win in plan:
            if self.pool_holes and len(pending) >= 2:
                self._observe_window(pending.pop(0))
            tgt = torch.stack([poses[i] for i in win["frames"]])
            res = self.render_window(win["ref_pose"], tgt)
            results.append((win["frames"], res))
            pending.append(res)
            stats.reference_renders += 1
        for idxs, res in results:
            counts = res.hole_counts.tolist()
            ovf = bool(res.overflowed)
            for j, f in enumerate(idxs):
                frames[f] = res.frames[j]
                stats.record_frame(int(counts[j]), ovf, hw)
        return [f for f in frames if f is not None], stats
