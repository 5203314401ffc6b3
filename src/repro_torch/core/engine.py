"""SpaRW render engine (port of ``repro.core.engine.DeviceSparwEngine``).

Staged path, one warp window per call: (1) render the reference frame
through the flat ray batch, (2) warp it into every target of the window in
one scatter pass (:func:`sparw.warp_frames_flat`), (3) compact the
window's holes into one pooled ``[bucket]`` batch
(:func:`sparw.compact_holes_pooled`), (4) render that batch and
segment-scatter it back, with a dense re-render of the window when it
overflows its capacity. The NeRF calls chunk exactly as the reference's
``lax.map`` does, so every chunk's RIT — and its overflow set — is the one
the reference builds. With ``RenderConfig.adaptive_sampling`` step (4)
splits the holes by warped-neighbourhood disagreement
(:func:`sparw.warp_disagreement`): the fine ones fill one pool at the full
sample budget, the coarse ones a second pool at ``num_samples //
coarse_factor``, each sized by its own controller.

Fused path (``RenderConfig.fused_tick``): after one staged priming
reference render, each window is one unified streaming tick
(:func:`raybatch.render_tick_streaming`) that fills this window's holes
and renders the next window's reference through one MVoxel-table sweep.
Both paths serve :class:`repro_torch.serve.render_engine.RenderServeEngine`;
in its multi-scene mode ``params`` hold the stacked scene pages and a
``scene_of_seg`` map, which every flat stage carries to the gathers with
the rays' segment ids (kernels B4 and B5).

Not ported yet: session sharding and the autotune cache
(``ref_cap_factor`` is the reference's default, 2).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

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
    fine_counts: torch.Tensor  # [N] full-budget holes (== hole_counts
    #                            unless adaptive sampling split the pool)


class BatchedWindowResult(NamedTuple):
    frames: torch.Tensor  # [S, N, H, W, 3]
    hole_counts: torch.Tensor  # [S, N]
    overflowed: torch.Tensor  # [S] bool — per-session dense-fallback flag
    fine_counts: torch.Tensor  # [S, N] full-budget holes (feeds pool_ctl)


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
        self.adaptive_sampling = bool(config.adaptive_sampling)
        self.adaptive_var_threshold = float(config.adaptive_var_threshold)
        self.coarse_factor = int(config.coarse_factor)
        if self.adaptive_sampling and \
                model.cfg.num_samples % self.coarse_factor != 0:
            raise ValueError(
                f"adaptive_sampling needs the model's num_samples "
                f"({model.cfg.num_samples}) divisible by coarse_factor "
                f"({self.coarse_factor})")
        ctl_kw = dict(worst=self.window * self.hole_cap,
                      min_bucket=self.pool_min_bucket,
                      safety=config.pool_safety, alpha=config.pool_ewma_alpha,
                      fixed=config.pool_bucket)
        self.pool_ctl = HoleCapController(**ctl_kw)
        self.pool_ctl_coarse = HoleCapController(**ctl_kw)
        # every (bucket, bucket_coarse) this engine has run at (the
        # reference counts them as compile targets; serving reports the
        # per-run delta)
        self.pool_buckets_used: set = set()
        self.num_window_calls = 0
        self._staged: Dict[Tuple[int, int], torch.Tensor] = {}
        # the fused tick's reference-set RIT capacity factor; the reference
        # may override it from an autotune cache, which the port never reads
        self.ref_cap_factor = 2
        self.fused_tick = bool(config.fused_tick)
        if self.fused_tick and not self._seg_aware:
            raise ValueError(
                "fused_tick requires a dvgo model on the streaming backend")

    @property
    def pool_ladder_size(self) -> int:
        """Bound on the distinct (bucket, bucket_coarse) pairs this engine
        can run at."""
        fine = self.pool_ctl.ladder_size
        return fine * (self.pool_ctl_coarse.ladder_size
                       if self.adaptive_sampling else 1)

    def _current_buckets(self) -> Tuple[int, int]:
        """The pool bucket(s) the next window runs at (0 disables the
        pooled path / the coarse sub-pool)."""
        if not self.pool_holes:
            return 0, 0
        return (self.pool_ctl.bucket,
                self.pool_ctl_coarse.bucket if self.adaptive_sampling else 0)

    def _render_rays_flat(self, params: dict, o: torch.Tensor,
                          d: torch.Tensor, seg: Optional[torch.Tensor],
                          num_seg: int, quantum: int,
                          num_samples: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A flat [F, 3] ray batch in chunks of ``min(ray_chunk,
        ceil(quantum / 2), F)`` rays, the last chunk padded with zero rays
        tagged with the dump segment ``num_seg``. ``quantum`` is the stage's
        per-session ray count; the chunk rule is the reference's, kept so
        each chunk's RIT holds the same samples. ``num_samples`` overrides
        the model's samples per ray."""
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
                seg=None if seg is None else seg[i:i + c], num_seg=num_seg,
                num_samples=num_samples)
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
                     holes: torch.Tensor, live: torch.Tensor, bucket: int,
                     num_samples: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sparse fill over a pooled [S * bucket] hole batch, chunked at
        ``quantum = pool_min_bucket`` (bucket-independent, as in the
        reference), at ``num_samples`` samples per ray (default: the
        model's). Returns ([S, N, HW, 3] sparse frames, [S] totals)."""
        s, n = tgt_poses.shape[:2]
        hw = self.cam.height * self.cam.width
        addr, totals = sparw.compact_holes_pooled(holes, bucket, live)
        batch, flat_addr = raybatch.pack_hole_rays_pooled(self.cam, tgt_poses,
                                                          addr)
        fill, _ = self._render_rays_flat(
            params, batch.origins, batch.dirs,
            batch.seg if self._seg_aware else None, s,
            quantum=self.pool_min_bucket, num_samples=num_samples)
        valid = (torch.arange(bucket, device=self.device)[None, :]
                 < totals[:, None]).reshape(-1)
        sparse = raybatch.scatter_segments(fill, flat_addr, valid, s * n * hw)
        return sparse.reshape(s, n, hw, 3), totals

    def _render_windows(self, params: dict, ref_poses: torch.Tensor,
                        tgt_poses: torch.Tensor, win_lens: torch.Tensor,
                        caps: torch.Tensor, pool_caps: torch.Tensor,
                        pool_caps_coarse: torch.Tensor, bucket: int,
                        bucket_coarse: int) -> BatchedWindowResult:
        """S sessions' windows through the staged stages (1)-(4).

        ``win_lens`` [S] masks padded frames out of the overflow decision,
        ``caps`` [S] are per-frame hole capacities and ``pool_caps`` /
        ``pool_caps_coarse`` [S] per-session capacities of the fine and
        coarse pools. ``bucket == 0`` selects the per-frame fixed-capacity
        hole batch instead of the pooled one; ``bucket_coarse == 0`` turns
        the adaptive coarse sub-pool off. A session that overflows any of
        them takes its frames from the dense fill.
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
        fine_counts = counts
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
        elif bucket_coarse == 0:
            # (4) pooled: the window's holes share one [S*bucket] batch
            sparse, totals = self._pooled_fill(params, tgt_poses, holes, live,
                                               bucket)
            overflowed = frame_over | (totals > pool_caps)
        else:
            # (4) pooled + adaptive sampling: holes with few warped
            # neighbours or disagreeing ones keep the full sample budget,
            # the others fill a coarse pool at num_samples / coarse_factor
            var, cnt = sparw.warp_disagreement(warped.rgb, warped.holes)
            fine_m = warped.holes & ((cnt < 3)
                                     | (var > self.adaptive_var_threshold))
            fine = fine_m.reshape(s, n, hw) & live[:, :, None]
            coarse = holes & live[:, :, None] & ~fine
            sparse_f, tot_f = self._pooled_fill(params, tgt_poses, fine,
                                                live, bucket)
            sparse_c, tot_c = self._pooled_fill(
                params, tgt_poses, coarse, live, bucket_coarse,
                num_samples=self.model.cfg.num_samples // self.coarse_factor)
            sparse = sparse_f + sparse_c  # disjoint masks: no overlap
            overflowed = (frame_over | (tot_f > pool_caps)
                          | (tot_c > pool_caps_coarse))
            fine_counts = torch.sum(fine, dim=2)
        fill = sparse
        if bool(overflowed.any()):
            dense = self._dense_fill_flat(params, tgt_poses)
            fill = torch.where(overflowed[:, None, None, None], dense, sparse)
        frames = torch.where(holes[..., None], fill,
                             warped.rgb.reshape(s, n, hw, 3))
        return BatchedWindowResult(frames.reshape(s, n, h, w, 3), counts,
                                   overflowed, fine_counts)

    def _full(self, s: int, value: int) -> torch.Tensor:
        """The default per-session mask or capacity ``[s]`` of ``value``,
        staged on the device once per (s, value) (the reference's
        ``_staged_masks`` / ``_staged_pool_caps``); never written to."""
        staged = self._staged.get((s, value))
        if staged is None:
            staged = torch.full((s,), value, device=self.device)
            self._staged[(s, value)] = staged
        return staged

    def render_windows(self, ref_poses: torch.Tensor, tgt_poses: torch.Tensor,
                       win_lens: Optional[torch.Tensor] = None,
                       caps: Optional[torch.Tensor] = None,
                       pool_caps: Optional[torch.Tensor] = None,
                       pool_caps_coarse: Optional[torch.Tensor] = None,
                       bucket: Optional[int] = None,
                       bucket_coarse: Optional[int] = None
                       ) -> BatchedWindowResult:
        """S sessions' windows ([S,4,4] references vs [S,N,4,4] targets).

        ``win_lens``/``caps``/``pool_caps``/``pool_caps_coarse`` [S] are
        the per-session window lengths, hole capacities and fine / coarse
        pool capacities (the serving engine's per-slot masks); omitted,
        they default to the full window and the engine's capacities.
        ``bucket``/``bucket_coarse`` default to the pool controllers'.
        """
        s, n = tgt_poses.shape[:2]
        cur = self._current_buckets()
        bucket = cur[0] if bucket is None else bucket
        bucket_coarse = cur[1] if bucket_coarse is None else bucket_coarse
        win_lens = self._full(s, n) if win_lens is None else win_lens
        caps = self._full(s, self.hole_cap) if caps is None else caps
        pool_caps = self._full(s, bucket) if pool_caps is None else pool_caps
        pool_caps_coarse = (self._full(s, bucket_coarse)
                            if pool_caps_coarse is None else pool_caps_coarse)
        self.pool_buckets_used.add((bucket, bucket_coarse))
        self.num_window_calls += 1
        dev = self.device
        with torch.no_grad():
            return self._render_windows(
                self.params, ref_poses.to(dev), tgt_poses.to(dev),
                win_lens.to(dev), caps.to(dev), pool_caps.to(dev),
                pool_caps_coarse.to(dev), bucket, bucket_coarse)

    def render_window(self, ref_pose: torch.Tensor, tgt_poses: torch.Tensor
                      ) -> WindowResult:
        """One warp window: N target poses vs a shared reference pose."""
        res = self.render_windows(ref_pose[None], tgt_poses[None])
        return WindowResult(res.frames[0], res.hole_counts[0],
                            res.overflowed[0], res.fine_counts[0])

    def _observe_window(self, res) -> None:
        """Feed a finished window's fine hole total to the pool controller
        and, with adaptive sampling, its coarse total to the coarse one."""
        if not self.pool_holes:
            return
        total, fine = torch.stack([res.hole_counts.sum(),
                                   res.fine_counts.sum()]).tolist()
        self.pool_ctl.observe(fine)
        if self.adaptive_sampling:
            self.pool_ctl_coarse.observe(total - fine)

    # ------------------------------------------------------------------
    # unified streaming tick (fused reference -> warp -> hole fill)
    # ------------------------------------------------------------------
    def _prime_reference(self, params: dict, ref_poses: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The staged flat reference render of ``[S,4,4]`` poses ->
        ([S,H,W,3], [S,H,W]): run once per trajectory (or per admission)
        before the fused ticks take over."""
        s = ref_poses.shape[0]
        h, w = self.cam.height, self.cam.width
        ref = raybatch.pack_reference_rays(self.cam, ref_poses)
        col, dep = self._render_rays_flat(params, ref.origins, ref.dirs,
                                          ref.seg, s, quantum=h * w)
        return col.reshape(s, h, w, 3), dep.reshape(s, h, w)

    def prime_reference(self, ref_poses: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return self._prime_reference(self.params,
                                         ref_poses.to(self.device))

    def _prime_select(self, params: dict, prime_poses: torch.Tensor,
                      mask: torch.Tensor, rgb_ref: torch.Tensor,
                      dep_ref: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        rgb_p, dep_p = self._prime_reference(params, prime_poses)
        return raybatch.substitute_reference_rows(mask, rgb_p, dep_p,
                                                  rgb_ref, dep_ref)

    def prime_reference_select(self, prime_poses: torch.Tensor,
                               mask: torch.Tensor, rgb_ref: torch.Tensor,
                               dep_ref: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serving admission: render the full ``[S,4,4]`` slot batch of
        poses through the staged reference stage and substitute only the
        rows where ``mask`` is True into the running recurrence; the other
        rows pass through bitwise."""
        with torch.no_grad():
            return self._prime_select(self.params, prime_poses.to(self.device),
                                      mask.to(self.device), rgb_ref, dep_ref)

    def _tick_streaming(self, params: dict, rgb_ref: torch.Tensor,
                        dep_ref: torch.Tensor, ref_poses: torch.Tensor,
                        tgt_poses: torch.Tensor, next_ref_poses: torch.Tensor,
                        win_lens: torch.Tensor, caps: torch.Tensor,
                        pool_caps: torch.Tensor, bucket: int
                        ) -> raybatch.StreamingTickResult:
        return raybatch.render_tick_streaming(
            self.model, params, self.cam, phi_deg=self.phi_deg,
            rgb_ref=rgb_ref, dep_ref=dep_ref, ref_poses=ref_poses,
            tgt_poses=tgt_poses, next_ref_poses=next_ref_poses,
            win_lens=win_lens, caps=caps, pool_caps=pool_caps,
            bucket=bucket, ref_cap_factor=self.ref_cap_factor,
            dense_fill=lambda tp: self._dense_fill_flat(params, tp))

    def render_windows_streaming(self, rgb_ref: torch.Tensor,
                                 dep_ref: torch.Tensor,
                                 ref_poses: torch.Tensor,
                                 tgt_poses: torch.Tensor,
                                 next_ref_poses: torch.Tensor,
                                 win_lens: Optional[torch.Tensor] = None,
                                 caps: Optional[torch.Tensor] = None,
                                 pool_caps: Optional[torch.Tensor] = None,
                                 bucket: Optional[int] = None
                                 ) -> raybatch.StreamingTickResult:
        """One unified streaming tick for S sessions: warp the references
        rendered last tick (``rgb_ref``/``dep_ref`` at ``ref_poses``) into
        ``tgt_poses``, fill the pooled holes AND render ``next_ref_poses``
        through one fused MVoxel sweep; the result's ``next_rgb_ref`` /
        ``next_dep_ref`` feed the next call. Defaults as in
        :meth:`render_windows`."""
        s, n = tgt_poses.shape[:2]
        if bucket is None:
            bucket = self._current_buckets()[0]
        if bucket == 0:
            raise ValueError("the fused streaming tick requires a pooled "
                             "hole bucket (pool_holes=True)")
        win_lens = self._full(s, n) if win_lens is None else win_lens
        caps = self._full(s, self.hole_cap) if caps is None else caps
        pool_caps = self._full(s, bucket) if pool_caps is None else pool_caps
        self.pool_buckets_used.add((bucket, 0))
        self.num_window_calls += 1
        dev = self.device
        with torch.no_grad():
            return self._tick_streaming(
                self.params, rgb_ref, dep_ref, ref_poses.to(dev),
                tgt_poses.to(dev), next_ref_poses.to(dev), win_lens.to(dev),
                caps.to(dev), pool_caps.to(dev), bucket)

    # ------------------------------------------------------------------
    # per-tick bytes-moved accounting (staged vs fused MVoxel traffic)
    # ------------------------------------------------------------------
    def _staged_chunk_sweeps(self, n_rays: int, quantum: int) -> int:
        """Chunks one staged flat stage runs (each one full MVoxel-table
        sweep); the chunk math of :meth:`_render_rays_flat`."""
        if n_rays == 0:
            return 0
        c = min(self.ray_chunk, max(-(-quantum // 2), 1), n_rays)
        return round_up(n_rays, c) // c

    def tick_memory_stats(self, sessions: int, window: Optional[int] = None,
                          bucket: Optional[int] = None) -> Dict[str, float]:
        """Analytic per-tick MVoxel-table traffic, staged vs fused: the
        staged tick re-streams the whole halo table once per chunk of each
        stage, the fused tick once."""
        n = int(window) if window is not None else self.window
        s = int(sessions)
        hw = self.cam.height * self.cam.width
        if bucket is None:
            bucket = self._current_buckets()[0]
        scfg = self.model.streaming_cfg
        table_bytes = scfg.num_mvoxels * scfg.halo_rows \
            * self.model.cfg.channels * 4
        ref_sweeps = self._staged_chunk_sweeps(s * hw, hw)
        if bucket > 0:
            fill_sweeps = self._staged_chunk_sweeps(s * bucket,
                                                    self.pool_min_bucket)
        else:
            fill_sweeps = self._staged_chunk_sweeps(
                s * n * self.hole_cap, n * self.hole_cap)
        staged_sweeps = ref_sweeps + fill_sweeps
        frames = s * n
        return {
            "sessions": float(s),
            "window": float(n),
            "pool_bucket": float(bucket),
            "mvoxel_table_bytes": float(table_bytes),
            "staged_table_sweeps_per_tick": float(staged_sweeps),
            "staged_ref_sweeps": float(ref_sweeps),
            "staged_fill_sweeps": float(fill_sweeps),
            "staged_mvoxel_bytes_per_tick": float(staged_sweeps
                                                  * table_bytes),
            "staged_mvoxel_bytes_per_frame": staged_sweeps * table_bytes
            / frames,
            "fused_table_sweeps_per_tick": 1.0,
            "fused_mvoxel_bytes_per_tick": float(table_bytes),
            "fused_mvoxel_bytes_per_frame": table_bytes / frames,
            "bytes_reduction_staged_over_fused": float(staged_sweeps),
        }

    def render_trajectory(self, poses: List[torch.Tensor]
                          ) -> Tuple[List[torch.Tensor], RenderStats]:
        """SpaRW over a pose trajectory (off-trajectory schedule).

        Before dispatching window ``i`` the pool controller observes window
        ``i-2`` — the reference's two-window pipeline delay, kept so the
        bucket ladder (and so every overflow decision) matches. The
        controller resets at entry, so a cached engine acts like a new one.
        With ``fused_tick`` the windows run as fused streaming ticks.
        """
        if self.fused_tick:
            return self._render_trajectory_fused(poses)
        plan = schedule.WarpSchedule(self.window, "offtraj").windows(poses)
        hw = self.cam.height * self.cam.width
        frames: List[Optional[torch.Tensor]] = [None] * len(poses)
        stats = RenderStats()
        results = []
        self.pool_ctl.reset()
        self.pool_ctl_coarse.reset()
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

    def _render_trajectory_fused(self, poses: List[torch.Tensor]
                                 ) -> Tuple[List[torch.Tensor], RenderStats]:
        """Trajectory rendering through the unified streaming tick: the
        staged loop's schedule and controller cadence, but tick ``i`` warps
        the reference tick ``i-1``'s sweep rendered and co-renders tick
        ``i+1``'s (the first is primed by the staged reference stage). The
        last tick re-renders its own reference as the next-reference
        placeholder; that output is discarded, as in the reference."""
        plan = schedule.WarpSchedule(self.window, "offtraj").windows(poses)
        hw = self.cam.height * self.cam.width
        frames: List[Optional[torch.Tensor]] = [None] * len(poses)
        stats = RenderStats()
        results = []
        self.pool_ctl.reset()
        self.pool_ctl_coarse.reset()
        pending: List[raybatch.StreamingTickResult] = []
        ref_pose = plan[0]["ref_pose"][None]
        rgb_ref, dep_ref = self.prime_reference(ref_pose)
        stats.reference_renders += 1  # the priming render
        for i, win in enumerate(plan):
            if self.pool_holes and len(pending) >= 2:
                self._observe_window(pending.pop(0))
            tgt = torch.stack([poses[j] for j in win["frames"]])[None]
            next_pose = (plan[i + 1]["ref_pose"][None]
                         if i + 1 < len(plan) else ref_pose)
            res = self.render_windows_streaming(rgb_ref, dep_ref, ref_pose,
                                                tgt, next_pose)
            rgb_ref, dep_ref = res.next_rgb_ref, res.next_dep_ref
            ref_pose = next_pose
            results.append((win["frames"], res))
            pending.append(res)
            stats.reference_renders += 1
        for idxs, res in results:
            counts = res.hole_counts[0].tolist()
            ovf = bool(res.overflowed[0])
            for j, f in enumerate(idxs):
                frames[f] = res.frames[0, j]
                stats.record_frame(int(counts[j]), ovf, hw)
        return [f for f in frames if f is not None], stats
