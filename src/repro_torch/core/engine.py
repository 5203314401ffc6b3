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

Each staged window and fused tick is one *tick program* per key
``(path, S, N, bucket, bucket_coarse)``, the key under which the reference
compiles one XLA program (:class:`TickProgram`). It reads only
fixed-address inputs the engine owns (:meth:`DeviceSparwEngine.tick_inputs`,
:meth:`DeviceSparwEngine.recurrence`) and reads nothing back: the dense
overflow fallback is decided where the frames are first read
(:class:`raybatch.DeferredFrames`). On the card a steady call is one
CUDA-graph replay and issues no synchronizing call.

Session sharding (``RenderConfig.shard``): the engine lays the session
axis over the ranks of a process group, one per device, for its lifetime
(:func:`raybatch.make_mesh`), and takes the params, MVoxel table included,
from the mesh's first rank. A staged :meth:`DeviceSparwEngine.
render_windows` of S > 1 sessions then renders only the rank's S / D
sessions through its own tick program (keyed on S / D), resolves their
dense fallback on that rank, and gathers every field of the result back
to ``[S, ...]`` on every rank, outside the tick program (a gloo
collective cannot be captured). The gather reads the frames back, so a
sharded window synchronizes the host once.

Not ported yet: the autotune cache (``ref_cap_factor`` is the
reference's default, 2).
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import raybatch, schedule, sparw
from repro_torch.core.config import HoleCapController, RenderConfig, \
    RenderStats
from repro_torch.kernels import _build
from repro_torch.nerf import rays
from repro_torch.utils import params_device, round_up


class BatchedWindowResult(raybatch.DeferredFrames):
    """S sessions' windows: ``hole_counts`` [S, N] true (uncapped) hole
    counts, ``overflowed`` [S] the per-session dense-fallback flag,
    ``fine_counts`` [S, N] full-budget holes (== ``hole_counts`` unless
    adaptive sampling split the pool; they feed ``pool_ctl``); ``frames``
    [S, N, H, W, 3] as in :class:`raybatch.DeferredFrames`."""

    def __init__(self, sparse_frames: torch.Tensor, holes: torch.Tensor,
                 hole_counts: torch.Tensor, overflowed: torch.Tensor,
                 fine_counts: torch.Tensor,
                 dense_fill: Optional[Callable[[], torch.Tensor]] = None):
        super().__init__(sparse_frames, holes, overflowed, dense_fill)
        self.hole_counts = hole_counts
        self.fine_counts = fine_counts


class WindowResult:
    """One window: session 0 of a :class:`BatchedWindowResult`
    (``frames`` [N, H, W, 3], ``hole_counts`` / ``fine_counts`` [N],
    ``overflowed`` [] bool)."""

    def __init__(self, batched: BatchedWindowResult):
        self.batched = batched

    frames = property(lambda self: self.batched.frames[0])
    hole_counts = property(lambda self: self.batched.hole_counts[0])
    overflowed = property(lambda self: self.batched.overflowed[0])
    fine_counts = property(lambda self: self.batched.fine_counts[0])


class TickProgram:
    """One tick program: ``fn()`` reads its engine's fixed-address inputs
    and returns a dict of output tensors.

    Called with ``graphs`` (a CUDA engine), the first call runs ``fn``
    eagerly: that builds the kernels, sets their attributes, pads B2's
    weights and sizes the library workspaces. The second captures ``fn``
    into a CUDA graph in the engine's memory pool and replays it; every
    later call replays it. Each replay's outputs are copied out of the
    pool, which the next replay overwrites. Without ``graphs`` (the CPU,
    or an engine whose ``cuda_graphs`` is off) every call runs ``fn``
    eagerly. The kernels' launch counts count every replay, not the
    capture (``kernels._build``). A capture that fails raises.
    """

    def __init__(self, fn: Callable[[], Dict[str, torch.Tensor]],
                 pool=None):
        self.fn = fn
        self.pool = pool
        self.calls = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._launches: _build.LaunchCounts = []
        self._keep: list = []  # what the graph reads by address

    def __call__(self, graphs: bool) -> Dict[str, torch.Tensor]:
        self.calls += 1
        if not graphs or (self.graph is None and self.calls == 1):
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _build.add_launches(self._launches)
        return {k: v.clone() for k, v in self._static.items()}

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = _build.launch_snapshot()
        # no garbage may be freed while capturing: releasing a pinned host
        # block records an event on the stream it was copied on, which
        # invalidates the capture; so collect first and pause the collector
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with _build.kept_alive() as keep, \
                    torch.cuda.graph(graph, pool=self.pool):
                static = self.fn()
        finally:
            if gc_was_on:
                gc.enable()
        # the capture ran nothing: its counts belong to the replays
        self._launches = _build.launches_since(before)
        _build.add_launches(self._launches, sign=-1)
        self.graph, self._static, self._keep = graph, static, keep


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
        self.device = params_device(self.params, config.device)
        # multi-device session sharding: one mesh for the engine's life;
        # every rank renders from the first rank's params and MVoxel table
        self.mesh = raybatch.make_mesh(config.shard, self.device.type)
        if self.mesh is not None:
            self.params = raybatch.replicated_sharding(self.mesh)(self.params)
        # the segment axis rides into the Gathering Unit only: the dense
        # grid on the streaming backend (the reference's rule)
        self._seg_aware = (model.cfg.backend == "streaming"
                           and model.cfg.kind == "dvgo")
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
        # tick programs by key (path, S, N, bucket, bucket_coarse), their
        # inputs by (S, N), the fused recurrence by S; on a CUDA engine the
        # programs replay CUDA graphs (off: every call eager, e.g. for a
        # spy that must see each call), captured into one memory pool
        self.tick_programs: Dict[tuple, TickProgram] = {}
        self._inputs: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._recurrence: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.cuda_graphs = self.device.type == "cuda"
        self._graph_pool = None
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
                        bucket_coarse: int) -> Dict[str, torch.Tensor]:
        """S sessions' windows through the staged stages (1)-(4): the
        fields of a :class:`BatchedWindowResult`.

        ``win_lens`` [S] masks padded frames out of the overflow decision,
        ``caps`` [S] are per-frame hole capacities and ``pool_caps`` /
        ``pool_caps_coarse`` [S] per-session capacities of the fine and
        coarse pools. ``bucket == 0`` selects the per-frame fixed-capacity
        hole batch instead of the pooled one; ``bucket_coarse == 0`` turns
        the adaptive coarse sub-pool off. A session that overflows any of
        them is flagged; its frames take the dense fill where they are
        read.
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
        frames = torch.where(holes[..., None], sparse,
                             warped.rgb.reshape(s, n, hw, 3))
        return dict(sparse_frames=frames.reshape(s, n, h, w, 3),
                    holes=warped.holes, hole_counts=counts,
                    overflowed=overflowed, fine_counts=fine_counts)

    # ------------------------------------------------------------------
    # tick programs and their fixed-address inputs
    # ------------------------------------------------------------------
    def tick_inputs(self, s: int, n: int) -> Dict[str, torch.Tensor]:
        """The inputs every tick program of ``s`` sessions x ``n`` targets
        reads, kept for the engine's life and written in place: ``poses``
        [s, n + 2, 4, 4] (row 0 the reference, rows 1..n the targets, row
        n + 1 the next reference; ``ref_poses``, ``tgt_poses`` and
        ``next_ref_poses`` are views of it, so one copy fills a tick's
        poses) and ``win_lens``, ``caps``, ``pool_caps`` and
        ``pool_caps_coarse`` [s] int64."""
        bufs = self._inputs.get((s, n))
        if bufs is None:
            poses = torch.zeros((s, n + 2, 4, 4), device=self.device)
            bufs = dict(poses=poses, ref_poses=poses[:, 0],
                        tgt_poses=poses[:, 1:n + 1],
                        next_ref_poses=poses[:, n + 1])
            for name in ("win_lens", "caps", "pool_caps",
                         "pool_caps_coarse"):
                bufs[name] = torch.zeros((s,), dtype=torch.int64,
                                         device=self.device)
            self._inputs[(s, n)] = bufs
        return bufs

    def recurrence(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused tick's cross-tick references for ``s`` sessions, [s,
        H, W, 3] and [s, H, W]: every fused program of ``s`` sessions
        warps them and then writes the next tick's references into them."""
        rec = self._recurrence.get(s)
        if rec is None:
            h, w = self.cam.height, self.cam.width
            rec = (torch.zeros((s, h, w, 3), device=self.device),
                   torch.zeros((s, h, w), device=self.device))
            self._recurrence[s] = rec
        return rec

    def upload(self, src: torch.Tensor) -> torch.Tensor:
        """``src`` on the engine's device without a host sync: a host
        tensor goes through pinned memory and a non-blocking copy (the
        host allocator keeps the pinned block until the copy has run)."""
        if self.device.type == "cuda" and src.device.type == "cpu":
            return src.pin_memory().to(self.device, non_blocking=True)
        return src.to(self.device)

    def stage(self, dst: torch.Tensor, src: Optional[torch.Tensor],
              default: Optional[int] = None) -> None:
        """Write a tick input into its buffer ``dst`` without a host sync:
        nothing when ``src`` is ``dst`` itself, ``default`` everywhere when
        ``src`` is None."""
        if src is None:
            dst.fill_(default)
        elif not (src.device == dst.device
                  and src.data_ptr() == dst.data_ptr()
                  and src.shape == dst.shape
                  and src.stride() == dst.stride()):
            src = src.to(dst.dtype)
            if dst.device.type == "cuda" and src.device.type == "cpu":
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def _program(self, key: tuple,
                 fn: Callable[[], Dict[str, torch.Tensor]]) -> TickProgram:
        """The tick program of ``key``, made from ``fn`` at its first
        call."""
        prog = self.tick_programs.get(key)
        if prog is None:
            if self.cuda_graphs and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            prog = TickProgram(fn, self._graph_pool)
            self.tick_programs[key] = prog
        return prog

    @property
    def num_captures(self) -> int:
        """Tick programs captured into a CUDA graph so far."""
        return sum(p.graph is not None for p in self.tick_programs.values())

    def _fallback(self, params: dict, tgt_poses: torch.Tensor
                  ) -> Callable[[], torch.Tensor]:
        """The dense fill a result runs where its frames are read and a
        session overflowed: :meth:`_dense_fill_flat` on this call's params
        and targets, snapshotted on the device (serving re-stages the
        targets and the scene map in place; it resolves pending results
        before it rewrites a scene page)."""
        if "scene_of_seg" in params:
            params = dict(params, scene_of_seg=params["scene_of_seg"].clone())
        tgt = tgt_poses.clone()

        def fill() -> torch.Tensor:
            with torch.no_grad():
                return self._dense_fill_flat(params, tgt)
        return fill

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

        With ``config.shard`` enabled and S > 1 this rank renders its S / D
        sessions and every field is gathered back to ``[S, ...]`` on every
        rank (S must divide evenly: sessions are pinned whole); S == 1
        renders unsharded, on every rank.
        """
        s, n = tgt_poses.shape[:2]
        sharded = self.mesh is not None and s > 1
        if sharded:
            ndev = self.mesh.size()
            if s % ndev != 0:
                raise ValueError(
                    f"render_windows: {s} sessions cannot shard evenly "
                    f"over {ndev} devices")
            (ref_poses, tgt_poses, win_lens, caps, pool_caps,
             pool_caps_coarse) = raybatch.shard_session_inputs(
                self.mesh, ref_poses, tgt_poses, win_lens, caps, pool_caps,
                pool_caps_coarse)
            s //= ndev
        cur = self._current_buckets()
        bucket = cur[0] if bucket is None else bucket
        bucket_coarse = cur[1] if bucket_coarse is None else bucket_coarse
        b = self.tick_inputs(s, n)
        self.stage(b["ref_poses"], ref_poses)
        self.stage(b["tgt_poses"], tgt_poses)
        self.stage(b["win_lens"], win_lens, n)
        self.stage(b["caps"], caps, self.hole_cap)
        self.stage(b["pool_caps"], pool_caps, bucket)
        self.stage(b["pool_caps_coarse"], pool_caps_coarse, bucket_coarse)
        self.pool_buckets_used.add((bucket, bucket_coarse))
        self.num_window_calls += 1
        prog = self._program(
            ("staged_sharded" if sharded else "staged", s, n, bucket,
             bucket_coarse),
            lambda: self._render_windows(
                self._local_params(sharded), b["ref_poses"], b["tgt_poses"],
                b["win_lens"], b["caps"], b["pool_caps"],
                b["pool_caps_coarse"], bucket, bucket_coarse))
        with torch.no_grad():
            out = prog(self.cuda_graphs)
        res = BatchedWindowResult(**out, dense_fill=self._fallback(
            self._local_params(sharded), b["tgt_poses"]))
        if not sharded:
            return res
        # the owner resolves its sessions' dense fallback, then every rank
        # gets every session's fields
        frames = res.frames
        gather = lambda t: raybatch.gather_sessions(self.mesh, t)
        return BatchedWindowResult(gather(frames), gather(res.holes),
                                   gather(res.hole_counts),
                                   gather(res.overflowed),
                                   gather(res.fine_counts))

    def _local_params(self, sharded: bool) -> dict:
        """The params this rank's block renders from: a multi-scene
        engine's segment->page map narrowed to the rank's sessions (a view,
        at a fixed address)."""
        params = self.params
        if sharded and "scene_of_seg" in params:
            params = dict(params, scene_of_seg=raybatch.session_sharding(
                self.mesh)(params["scene_of_seg"]))
        return params

    def render_window(self, ref_pose: torch.Tensor, tgt_poses: torch.Tensor
                      ) -> WindowResult:
        """One warp window: N target poses vs a shared reference pose."""
        return WindowResult(self.render_windows(ref_pose[None],
                                                tgt_poses[None]))

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
            return self._prime_reference(self.params, self.upload(ref_poses))

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
            return self._prime_select(self.params, self.upload(prime_poses),
                                      self.upload(mask), rgb_ref, dep_ref)

    def _tick_streaming(self, params: dict, b: Dict[str, torch.Tensor],
                        rgb_ref: torch.Tensor, dep_ref: torch.Tensor,
                        bucket: int) -> Dict[str, torch.Tensor]:
        """One fused tick on the inputs ``b`` and the recurrence buffers:
        the fields of a :class:`raybatch.StreamingTickResult`; the next
        tick's references are also written into the recurrence, after the
        warp has read this tick's."""
        r = raybatch.render_tick_streaming(
            self.model, params, self.cam, phi_deg=self.phi_deg,
            rgb_ref=rgb_ref, dep_ref=dep_ref, ref_poses=b["ref_poses"],
            tgt_poses=b["tgt_poses"], next_ref_poses=b["next_ref_poses"],
            win_lens=b["win_lens"], caps=b["caps"], pool_caps=b["pool_caps"],
            bucket=bucket, ref_cap_factor=self.ref_cap_factor)
        rgb_ref.copy_(r.next_rgb_ref)
        dep_ref.copy_(r.next_dep_ref)
        return dict(sparse_frames=r.sparse_frames, holes=r.holes,
                    hole_counts=r.hole_counts, overflowed=r.overflowed,
                    next_rgb_ref=r.next_rgb_ref, next_dep_ref=r.next_dep_ref)

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
        ``next_dep_ref`` feed the next call, and :meth:`recurrence` holds
        them too (pass it back to skip the copy in). Defaults as in
        :meth:`render_windows`."""
        s, n = tgt_poses.shape[:2]
        if bucket is None:
            bucket = self._current_buckets()[0]
        if bucket == 0:
            raise ValueError("the fused streaming tick requires a pooled "
                             "hole bucket (pool_holes=True)")
        b = self.tick_inputs(s, n)
        rgb_buf, dep_buf = self.recurrence(s)
        self.stage(rgb_buf, rgb_ref)
        self.stage(dep_buf, dep_ref)
        self.stage(b["ref_poses"], ref_poses)
        self.stage(b["tgt_poses"], tgt_poses)
        self.stage(b["next_ref_poses"], next_ref_poses)
        self.stage(b["win_lens"], win_lens, n)
        self.stage(b["caps"], caps, self.hole_cap)
        self.stage(b["pool_caps"], pool_caps, bucket)
        self.pool_buckets_used.add((bucket, 0))
        self.num_window_calls += 1
        path = "fused_paged" if "scene_of_seg" in self.params else "fused"
        prog = self._program(
            (path, s, n, bucket, 0),
            lambda: self._tick_streaming(self.params, b, rgb_buf, dep_buf,
                                         bucket))
        with torch.no_grad():
            out = prog(self.cuda_graphs)
        return raybatch.StreamingTickResult(
            **out, dense_fill=self._fallback(self.params, b["tgt_poses"]))

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
            rgb_ref, dep_ref = self.recurrence(1)  # == res.next_*_ref
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
