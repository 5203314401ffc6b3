"""Multi-session SpaRW render serving engine: continuous batching of warp
windows (port of ``repro.serve.render_engine``).

A *session* is one client's camera trajectory. The engine admits sessions
into a fixed number of **slots**, aligns their warp **windows** into one
device batch and renders every active session's next window in one call
per **tick**; a session that finishes frees its slot for the next queued
session (chosen by a :mod:`~repro_torch.serve.policies` policy).

* **Staged tick** — :meth:`~repro_torch.core.engine.DeviceSparwEngine.
  render_windows` with per-slot window lengths and capacities: ragged
  sessions batch into one fixed ``[num_slots, window]`` shape by pose
  padding and masking. With ``RenderConfig.adaptive_sampling`` each slot
  also carries a coarse-pool controller (``ctl_c``), fed the window's
  holes that are not fine.
* **Fused tick** (``RenderConfig.fused_tick``) — :meth:`~repro_torch.core.
  engine.DeviceSparwEngine.render_windows_streaming`: the engine threads a
  ``[num_slots, H, W]`` cross-tick reference recurrence from tick to tick
  (tick t co-renders tick t+1's references in its sweep), and a tick that
  admits sessions first primes their rows with one masked staged render
  (``prime_reference_select``), so a reused slot never warps the previous
  occupant's reference.
* **Multi-scene serving** (``scene_loader=...``) — each slot's occupant
  may view a different scene. Per-scene tables are paged through a
  device-resident LRU (:class:`~repro_torch.core.scene_cache.SceneCache`,
  byte budget ``RenderConfig.scene_cache_bytes``): ``K = num_slots``
  pages stored as one stacked ``table [K, res^3, C]`` and one stacked
  halo table ``mv_table [K, num_mv, P, C]``. Admitting a cached scene
  uploads nothing; a miss uploads one dense table into the LRU-evicted
  page (its halo re-layout is built on the device). The slot->page map
  rides into every gather as ``scene_of_seg`` (int32, on the device,
  re-staged only when slot composition changes), where kernels B4
  (staged) and B5 (fused) steer each segment to its page. Live slots pin
  their pages. Pages are written in place, on the current stream: a page
  recycled while the previous tick is still in flight (``run`` dispatches
  one tick ahead) is overwritten only after that tick's kernels, in
  stream order, so this engine must not move work to a second stream.
* **Session sharding** (``RenderConfig.shard``) — the staged tick's
  session axis is laid over the ranks of a process group, one per device
  (``num_slots`` divisible by ``num_devices``; sessions pinned whole):
  every rank runs this engine on the same sessions, renders its block of
  slots and receives every slot's results, gathered; :meth:`finalize`
  reads them back on every rank, so the pool controllers, buckets and
  statistics agree on every rank. Multi-scene serving keeps every page on
  every rank.

:meth:`RenderServeEngine.step` dispatches; frames and hole statistics are
read back in :meth:`RenderServeEngine.finalize`, which also runs the dense
fallback for a session that overflowed (its frames are resolved there,
:class:`~repro_torch.core.raybatch.DeferredFrames`). A steady tick (no
admission, no page upload) reads nothing back and issues no synchronizing
call: every tensor the tick reads lives at a fixed address and is
rewritten in place, its poses go up in one non-blocking copy from a ring
of pinned host buffers, and on the card the engine call is one CUDA-graph
replay. The reference holds its poses on the device and transfers
nothing; the port makes that one asynchronous upload per tick. A sharded
steady tick is dispatch-only too: its gathers stay in stream order over
NCCL (over gloo they pass through host memory), and its dense fallback
is decided in :meth:`finalize`, as the unsharded tick's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import schedule, streaming
from repro_torch.core.config import HoleCapController, RenderConfig, \
    RenderRequest, RenderStats
from repro_torch.core.engine import DeviceSparwEngine
from repro_torch.core.scene_cache import SceneCache
from repro_torch.kernels import streaming_pipeline
from repro_torch.serve.policies import SchedulingPolicy, resolve_policy


@dataclass
class RenderSession:
    """One client trajectory moving through the serving engine.

    ``window``/``hole_cap``/``pool_bucket`` override the engine config
    (bounded by its static capacities, validated at submit);
    ``priority``/``deadline_ms`` feed the admission policy. ``scene``
    names the scene this client views (None: the engine's own params;
    a name needs a multi-scene engine). ``arrival`` and
    ``submitted_s`` are stamped by :meth:`RenderServeEngine.submit`,
    ``admitted_s`` when the session takes a slot; ``shed=True`` marks a
    session the policy dropped from the queue.
    """

    sid: int
    poses: List[torch.Tensor]
    frames: List[Optional[torch.Tensor]] = field(default_factory=list)
    stats: RenderStats = field(default_factory=RenderStats)
    frame_latencies_s: List[float] = field(default_factory=list)
    done: bool = False
    window: Optional[int] = None
    hole_cap: Optional[int] = None
    pool_bucket: Optional[int] = None
    priority: int = 0
    deadline_ms: Optional[float] = None
    scene: Optional[str] = None
    arrival: int = -1
    submitted_s: Optional[float] = None
    admitted_s: Optional[float] = None
    shed: bool = False

    def __post_init__(self) -> None:
        if not self.poses:
            raise ValueError(f"session {self.sid}: empty trajectory")
        self.frames = [None] * len(self.poses)

    @classmethod
    def from_request(cls, request: RenderRequest, sid: int
                     ) -> "RenderSession":
        return cls(sid=request.sid if request.sid is not None else sid,
                   poses=list(request.poses), window=request.window,
                   hole_cap=request.hole_cap,
                   pool_bucket=request.pool_bucket,
                   priority=request.priority,
                   deadline_ms=request.deadline_ms, scene=request.scene)


@dataclass
class _Slot:
    """Engine-side state of an occupied slot."""

    session: RenderSession
    window: int  # effective warp window
    cap: int  # effective hole capacity
    cursor: int = 0  # next un-rendered pose index
    extrapolator: Optional[schedule.RefPoseExtrapolator] = None
    ctl: Optional[HoleCapController] = None  # fresh at admit
    ctl_c: Optional[HoleCapController] = None  # adaptive coarse sub-pool
    # fused tick: pose of the reference held in this slot's recurrence row
    ref_pose: Optional[torch.Tensor] = None
    # multi-scene: the occupant's scene key (pins its page while the slot
    # is occupied) and the page index
    scene_key: Optional[str] = None
    page: int = 0


class RenderServeEngine:
    """Fixed-slot continuous batching of SpaRW warp windows.

    ``config.num_slots`` sessions render per tick; further sessions queue
    and take over slots as earlier trajectories finish, the ``policy``
    choosing which. Sessions may override ``window`` (<= ``config.window``)
    and ``hole_cap`` (<= the engine's capacity). With ``scene_loader``
    (scene name -> dense table ``[res^3, C]``, or a dict holding it under
    ``"table"``) sessions may name their scene (see the module docstring).
    """

    POSE_RING = 3  # host pose buffers: run() keeps 2 ticks in flight

    def __init__(self, model, params: dict, *, config: RenderConfig,
                 policy: Union[None, str, SchedulingPolicy] = None,
                 scene_loader: Optional[Callable[[str], object]] = None):
        config = config.resolved()
        self.config = config
        self.policy = resolve_policy(policy)
        self.num_slots = config.num_slots
        self.window = config.window
        self.engine = DeviceSparwEngine(model, params, config=config)
        self.device = self.engine.device
        self.slots: List[Optional[_Slot]] = [None] * self.num_slots
        self.queue: List[RenderSession] = []
        self.num_ticks = 0
        self._num_submitted = 0  # arrival stamp for policy tie-breaking
        self._num_shed = 0
        self._queue_depth_log: List[int] = []
        self._occupancy_log: List[int] = []
        # idle slots render a self-warp (reference == target: no holes)
        self._idle_pose = torch.eye(4)
        # the engine's fixed-address tick inputs at [num_slots, window]:
        # the per-slot (window, cap, pool cap, coarse pool cap) signature
        # is rewritten into them only when admission, draining or a ladder
        # step changes it; the poses arrive through a ring of host buffers
        # (pinned on the card), one copy a tick, a buffer reused only once
        # its copy has run
        self._inputs = self.engine.tick_inputs(self.num_slots, self.window)
        self._win_lens = self._inputs["win_lens"]
        self._caps = self._inputs["caps"]
        self._pool_caps = self._inputs["pool_caps"]
        self._pool_caps_c = self._inputs["pool_caps_coarse"]
        pinned = self.device.type == "cuda"
        self._pose_ring = [
            [torch.empty(self._inputs["poses"].shape, pin_memory=pinned),
             None] for _ in range(self.POSE_RING)]
        self._slot_sig: Optional[Tuple[Tuple[int, int, int, int],
                                       ...]] = None
        self._tick_bucket = 0
        self._tick_bucket_c = 0
        # deferred readback: (assignments, result, (bucket, bucket_coarse))
        # per tick, where assignments[s] = (session, [frame indices], ctl,
        # ctl_c) or None
        self._pending: List[tuple] = []
        self._last_result = None
        self._last_event = None  # marks the end of the last tick's work
        self._pool_log: List[dict] = []
        # fused tick: row s of _rgb_ref/_dep_ref (the engine's recurrence)
        # is the reference the next tick warps for slot s
        self.fused = self.engine.fused_tick
        self._rgb_ref, self._dep_ref = self.engine.recurrence(self.num_slots)
        self._primed = False
        self._num_admission_ticks = 0
        # multi-scene paging: scene name -> page index, LRU under the byte
        # budget; the stacked [K, ...] tensors are the page storage
        self.scene_loader = scene_loader
        self.multi_scene = scene_loader is not None
        if self.multi_scene:
            if not self.engine._seg_aware:
                raise ValueError(
                    "multi-scene serving needs the segment-aware streaming "
                    "backend (backend='streaming' with a grid model): the "
                    "scene->segment map rides the flat batch's seg axis")
            base = dict(self.engine.params)
            self._default_table = base.pop("table")
            self._default_mv = base.pop("mv_table")  # base: the decoder
            k = self.num_slots
            self._table_stack = self._default_table.new_zeros(
                (k,) + tuple(self._default_table.shape))
            self._mv_stack = self._default_mv.new_zeros(
                (k,) + tuple(self._default_mv.shape))
            self._free_pages = list(range(k))[::-1]  # pop() gives page 0
            self.scene_cache = SceneCache(
                budget_bytes=config.scene_cache_bytes, max_entries=k)
            self._num_uploads = 0
            self._uploaded_bytes = 0
            # the slot->page map, rewritten in place only when it changes;
            # the engine renders from the stacked pages from now on
            self._scene_sig: Optional[Tuple[int, ...]] = None
            self._scene_of_seg = torch.zeros((k,), dtype=torch.int32,
                                             device=self.device)
            self.engine.params = dict(
                base, table=self._table_stack, mv_table=self._mv_stack,
                scene_of_seg=self._scene_of_seg)

    # ------------------------------------------------------------------
    def _effective(self, sess: RenderSession) -> Tuple[int, int]:
        """Validate and resolve a session's (window, hole_cap) overrides
        against the engine's static capacities."""
        win = sess.window if sess.window is not None else self.window
        if not 1 <= win <= self.window:
            raise ValueError(
                f"session {sess.sid}: window override {win} outside "
                f"[1, {self.window}] (the engine's batch shape)")
        cap = (sess.hole_cap if sess.hole_cap is not None
               else self.engine.hole_cap)
        if not 1 <= cap <= self.engine.hole_cap:
            raise ValueError(
                f"session {sess.sid}: hole_cap override {cap} outside "
                f"[1, {self.engine.hole_cap}] (the engine's compaction "
                f"capacity)")
        if sess.pool_bucket is not None:
            if not self.engine.pool_holes:
                raise ValueError(
                    f"session {sess.sid}: pool_bucket override set but "
                    f"the engine has pool_holes disabled")
            if sess.pool_bucket > self.engine.pool_ctl.max_bucket:
                raise ValueError(
                    f"session {sess.sid}: pool_bucket override "
                    f"{sess.pool_bucket} exceeds the engine's worst-case "
                    f"bucket {self.engine.pool_ctl.max_bucket}")
        return win, cap

    def _live_sids(self) -> set:
        return ({s.sid for s in self.queue}
                | {slot.session.sid for slot in self.slots
                   if slot is not None})

    # ------------------------------------------------------------------
    # multi-scene paging
    # ------------------------------------------------------------------
    def _pinned_scenes(self) -> set:
        """Scene keys whose pages live slots hold: never evictable."""
        return {slot.scene_key for slot in self.slots if slot is not None}

    def _recycle(self, evicted: List[tuple]) -> None:
        self._free_pages.extend(page for _key, page in evicted if page >= 0)

    def _page_of(self, skey: Optional[str], pinned: set) -> int:
        """Resolve ``skey`` to its device page, paging it in on a miss.

        A hit uploads nothing. A miss recycles the least recently used
        unpinned scene's page (a placeholder entry lets the cache's own
        LRU and pin rules choose the victim) and uploads exactly one dense
        table into it; the halo re-layout is built on the device. The
        page is written in place on the current stream (see the module
        docstring)."""
        page = self.scene_cache.get(skey)
        if page is not None:
            return page
        if not self._free_pages:
            self._recycle(self.scene_cache.put(skey, -1, 0, pinned=pinned))
            if not self._free_pages:
                raise RuntimeError(
                    "scene cache exhausted: every page is pinned by a live "
                    "slot (more distinct scenes in flight than num_slots "
                    "pages — should be unreachable, slots == pages)")
        page = self._free_pages.pop()
        # a pending tick's fallback may read the page about to be rewritten
        self._resolve_pending()
        if skey is None:
            table, mv = self._default_table, self._default_mv
        else:
            loaded = self.scene_loader(skey)
            table = loaded["table"] if isinstance(loaded, dict) else loaded
            if not isinstance(table, torch.Tensor):
                table = torch.as_tensor(np.asarray(table))
            table = table.to(device=self.device,
                             dtype=self._default_table.dtype)
            if table.shape != self._default_table.shape:
                raise ValueError(
                    f"scene {skey!r}: table shape {tuple(table.shape)} "
                    f"differs from the engine's page shape "
                    f"{tuple(self._default_table.shape)} (all scenes share "
                    f"one grid geometry)")
            mv = streaming.build_mvoxel_table(
                table, self.engine.model.streaming_cfg)
        self._table_stack[page].copy_(table)
        self._mv_stack[page].copy_(mv)
        nbytes = (table.numel() * table.element_size()
                  + mv.numel() * mv.element_size())
        self._num_uploads += 1
        self._uploaded_bytes += nbytes
        self._recycle(self.scene_cache.put(skey, page, nbytes,
                                           pinned=pinned))
        return page

    def _resolve_pending(self) -> None:
        """Run the dense fallback of every pending tick that needs one
        (reads each tick's ``overflowed`` back)."""
        for _assignments, res, _buckets in self._pending:
            res.frames

    def _stage_scene_map(self) -> None:
        """Rewrite the slot->page map in place iff it changed (admit,
        drain, repage), without a host sync; a steady-state tick uploads
        nothing and reads nothing back."""
        sig = tuple(slot.page if slot is not None else 0
                    for slot in self.slots)
        if sig != self._scene_sig:
            self._scene_sig = sig
            self.engine.stage(self._scene_of_seg,
                              torch.tensor(sig, dtype=torch.int32))

    def submit(self, sessions: List[RenderSession]) -> None:
        """Queue sessions for admission. The whole batch is validated
        before any state changes; duplicate sids (within the batch or
        against a queued or in-slot session) are rejected, as is a scene
        on an engine without a ``scene_loader``."""
        live = self._live_sids()
        batch_sids = set()
        for sess in sessions:
            self._effective(sess)
            if sess.scene is not None and not self.multi_scene:
                raise ValueError(
                    f"session {sess.sid}: scene={sess.scene!r} but the "
                    f"engine has no scene_loader (construct with "
                    f"scene_loader=... for multi-scene serving)")
            if sess.sid in live or sess.sid in batch_sids:
                raise ValueError(
                    f"session sid {sess.sid} duplicates a live session "
                    f"(sids must be unique among queued/in-flight "
                    f"sessions — per-session metrics are keyed on sid)")
            batch_sids.add(sess.sid)
        now = time.time()
        for sess in sessions:
            sess.arrival = self._num_submitted
            self._num_submitted += 1
            if sess.submitted_s is None:
                sess.submitted_s = now
        self.queue.extend(sessions)

    def _admit(self) -> List[int]:
        """Shed what the policy drops, then fill free slots from the queue;
        returns the slots filled this tick. In fused mode a new slot's
        first reference pose is extrapolated here."""
        now = time.time()
        shed_fn = getattr(self.policy, "shed", None)
        if shed_fn is not None and self.queue:
            for i in sorted(shed_fn(self.queue, now), reverse=True):
                sess = self.queue.pop(i)
                sess.shed = True
                sess.done = True
                self._num_shed += 1
        newly: List[int] = []
        for s in range(self.num_slots):
            if self.slots[s] is None and self.queue:
                sess = self.queue.pop(self.policy.select(self.queue, now))
                sess.admitted_s = now
                win, cap = self._effective(sess)
                cfg = self.engine.config
                ctl_kw = dict(worst=win * cap,
                              min_bucket=self.engine.pool_min_bucket,
                              safety=cfg.pool_safety,
                              alpha=cfg.pool_ewma_alpha,
                              fixed=(sess.pool_bucket
                                     if sess.pool_bucket is not None
                                     else cfg.pool_bucket))
                slot = _Slot(
                    session=sess, window=win, cap=cap,
                    extrapolator=schedule.RefPoseExtrapolator(window=win),
                    ctl=HoleCapController(**ctl_kw),
                    ctl_c=HoleCapController(**ctl_kw))
                if self.multi_scene:
                    # page the scene in now (upload on a miss); occupied
                    # slots pin their pages, so admission never steals one
                    slot.scene_key = sess.scene
                    slot.page = self._page_of(sess.scene,
                                              self._pinned_scenes())
                if self.fused:
                    slot.ref_pose = slot.extrapolator.next_reference(
                        sess.poses[:win])
                self.slots[s] = slot
                newly.append(s)
        return newly

    def _prime_admitted(self, newly: List[int]) -> None:
        """Prime the recurrence rows of the slots admitted this tick: one
        staged reference render over the full slot batch (new rows at
        their first reference pose, the others at the idle pose, their
        output discarded), substituted row by row. The first call primes
        every row over a zero recurrence."""
        first = not self._primed
        if not newly and not first:
            return
        if first:
            self._rgb_ref.zero_()
            self._dep_ref.zero_()
            self._primed = True
            mask = [True] * self.num_slots
        else:
            mask = [s in newly for s in range(self.num_slots)]
        poses = [self.slots[s].ref_pose
                 if mask[s] and self.slots[s] is not None
                 else self._idle_pose for s in range(self.num_slots)]
        rgb, dep = self.engine.prime_reference_select(
            self._stack(poses), torch.tensor(mask), self._rgb_ref,
            self._dep_ref)
        self._rgb_ref.copy_(rgb)
        self._dep_ref.copy_(dep)
        self._num_admission_ticks += 1

    def _stage_slot_masks(self) -> None:
        """Refresh the per-slot win_lens/caps/pool-caps device arrays iff
        the slot signature changed. Idle slots take the engine defaults
        and the minimum pool bucket (their self-warp has no holes)."""
        engine = self.engine
        adaptive = engine.adaptive_sampling
        sig = []
        for slot in self.slots:
            if slot is None:
                bf = engine.pool_min_bucket if engine.pool_holes else 0
                sig.append((self.window, engine.hole_cap, bf,
                            bf if adaptive else 0))
            elif not engine.pool_holes:
                sig.append((slot.window, slot.cap, 0, 0))
            else:
                sig.append((slot.window, slot.cap, slot.ctl.bucket,
                            slot.ctl_c.bucket if adaptive else 0))
        sig = tuple(sig)
        if sig != self._slot_sig:
            self._slot_sig = sig
            cols = torch.tensor(sig).T  # [4, num_slots]
            for buf, col in zip((self._win_lens, self._caps, self._pool_caps,
                                 self._pool_caps_c), cols):
                self.engine.stage(buf, col)
            self._tick_bucket = max(e[2] for e in sig)
            self._tick_bucket_c = max(e[3] for e in sig)

    def _stack(self, poses: List[torch.Tensor]) -> torch.Tensor:
        """Host-side pose batch (the engine moves it to the device)."""
        return torch.stack([p.to(self._idle_pose.device) for p in poses])

    def _upload_poses(self, rows: List[List[torch.Tensor]]) -> None:
        """Write the tick's poses ([num_slots] rows of reference, window
        targets, next reference) into the next ring buffer and copy it to
        the engine's pose input in one non-blocking copy. A buffer is
        rewritten only once its last copy has run (under :meth:`run` it
        has: its tick finished two ticks ago)."""
        slot = self._pose_ring[self.num_ticks % self.POSE_RING]
        host, done = slot
        if done is not None and not done.query():
            done.synchronize()
        host.copy_(torch.stack([self._stack(r) for r in rows]))
        self._inputs["poses"].copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            slot[1] = torch.cuda.Event()
            slot[1].record()

    def step(self) -> bool:
        """One tick: admit queued sessions into free slots, then one
        batched device call rendering every active session's next window.
        Frames and statistics stay on the device until :meth:`finalize`.
        Returns False when no work remains.

        On the fused tick the sweep warps the references co-rendered by
        the previous tick (newly admitted slots primed this tick) and
        co-renders the next tick's; a draining slot's last sweep
        co-renders the idle reference into its row."""
        newly = self._admit()
        occupied = sum(s is not None for s in self.slots)
        if occupied == 0:
            return False
        self._queue_depth_log.append(len(self.queue))
        self._occupancy_log.append(occupied)
        self._stage_slot_masks()
        if self.multi_scene:
            self._stage_scene_map()
        if self.fused:
            self._prime_admitted(newly)

        # each slot's row: reference, window targets, next reference
        rows, assignments = [], []
        idle = self._idle_pose
        for s in range(self.num_slots):
            slot = self.slots[s]
            if slot is None:
                rows.append([idle] * (self.window + 2))
                assignments.append(None)
                continue
            sess = slot.session
            idxs = list(range(slot.cursor,
                              min(slot.cursor + slot.window,
                                  len(sess.poses))))
            win = [sess.poses[i] for i in idxs]
            ref = (slot.ref_pose if self.fused
                   else slot.extrapolator.next_reference(win))
            # pad short windows with the last real pose; win_lens keeps the
            # pads out of the overflow decision, finalize drops them
            row = [ref] + win + [win[-1]] * (self.window - len(win))
            assignments.append((sess, idxs, slot.ctl, slot.ctl_c))
            sess.stats.reference_renders += 1
            slot.cursor += len(idxs)
            if slot.cursor >= len(sess.poses):
                row.append(idle)
                self.slots[s] = None
            elif self.fused:
                nxt = range(slot.cursor,
                            min(slot.cursor + slot.window, len(sess.poses)))
                slot.ref_pose = slot.extrapolator.next_reference(
                    [sess.poses[i] for i in nxt])
                row.append(slot.ref_pose)
            else:
                row.append(idle)
            rows.append(row)

        self._upload_poses(rows)
        b = self._inputs
        if self.fused:
            result = self.engine.render_windows_streaming(
                self._rgb_ref, self._dep_ref, b["ref_poses"], b["tgt_poses"],
                b["next_ref_poses"], self._win_lens, self._caps,
                pool_caps=self._pool_caps, bucket=self._tick_bucket)
        else:
            result = self.engine.render_windows(
                b["ref_poses"], b["tgt_poses"], self._win_lens, self._caps,
                pool_caps=self._pool_caps, pool_caps_coarse=self._pool_caps_c,
                bucket=self._tick_bucket, bucket_coarse=self._tick_bucket_c)
        self._pending.append((assignments, result,
                              (self._tick_bucket, self._tick_bucket_c)))
        self._last_result = result
        if self.device.type == "cuda":
            self._last_event = torch.cuda.Event()
            self._last_event.record()
        self.num_ticks += 1
        return True

    # ------------------------------------------------------------------
    def finalize(self, keep: int = 0) -> None:
        """Read pending ticks' hole statistics back to the host and hand
        their frames to the sessions; ``keep`` leaves that many of the
        newest ticks pending."""
        hw = self.engine.cam.height * self.engine.cam.width
        pool = self.engine.pool_holes
        adaptive = self.engine.adaptive_sampling
        split = max(len(self._pending) - keep, 0)
        done, self._pending = self._pending[:split], self._pending[split:]
        for assignments, res, (bf, bc) in done:
            counts, fine = torch.stack([res.hole_counts,
                                        res.fine_counts]).cpu().numpy()
            overflowed = res.overflowed.cpu().numpy()
            tick_holes = tick_fine = active = 0
            for s, assign in enumerate(assignments):
                if assign is None:
                    continue
                sess, idxs, ctl, ctl_c = assign
                ovf = bool(overflowed[s])
                for j, f in enumerate(idxs):
                    sess.frames[f] = res.frames[s, j]
                    sess.stats.record_frame(int(counts[s, j]), ovf, hw)
                if sess.frames.count(None) == 0:
                    sess.done = True
                win_total = int(counts[s, :len(idxs)].sum())
                fine_total = int(fine[s, :len(idxs)].sum())
                tick_holes += win_total
                tick_fine += fine_total
                active += 1
                # the fine total feeds the session's controller and, with
                # adaptive sampling, the rest its coarse one; the readback
                # runs a tick behind dispatch, so each observation lands
                # two dispatches after its window (the reference's cadence)
                if pool and ctl is not None:
                    ctl.observe(fine_total)
                    if adaptive:
                        ctl_c.observe(win_total - fine_total)
            if pool:
                self._pool_log.append(dict(
                    bucket=bf, bucket_coarse=bc, hole_total=tick_holes,
                    fine_total=tick_fine, active_slots=active))

    def _observe_tick(self, tick_t0: float, assignments: List[tuple],
                      done_event) -> None:
        """Wait for a dispatched tick's device work and attribute its wall
        time to the sessions it served."""
        if done_event is not None:
            done_event.synchronize()
        tick_s = time.time() - tick_t0
        for assign in assignments:
            if assign is not None:
                sess, idxs = assign[0], assign[1]
                sess.frame_latencies_s.extend([tick_s / len(idxs)]
                                              * len(idxs))

    def run(self, sessions: List[RenderSession], max_ticks: int = 10_000
            ) -> Dict[str, object]:
        """Serve ``sessions`` to completion; returns aggregate metrics
        (the reference's keys; ``scene_cache`` is None on a single-scene
        engine, ``devices`` the session mesh's size, 1 unsharded).

        The loop dispatches tick t+1 before waiting for tick t, and drains
        completed ticks as it goes."""
        self.submit(sessions)
        start_ticks = self.num_ticks
        log_start = len(self._pool_log)
        buckets_start = len(self.engine.pool_buckets_used)
        adm_start = self._num_admission_ticks
        qd_start = len(self._queue_depth_log)
        shed_start = self._num_shed
        sc_start = self._scene_counters() if self.multi_scene else None
        t0 = time.time()
        in_flight = None  # (dispatch_t0, assignments, done event)
        while self.num_ticks - start_ticks < max_ticks:
            tick_t0 = time.time()
            if not self.step():
                break
            dispatched = (tick_t0, self._pending[-1][0], self._last_event)
            if in_flight is not None:
                self._observe_tick(*in_flight)
                self.finalize(keep=1)
            in_flight = dispatched
        if in_flight is not None:
            self._observe_tick(*in_flight)
        wall_s = time.time() - t0
        self.finalize()
        total_frames = sum(len(s.poses) for s in sessions if not s.shed)
        per_session = {
            s.sid: {
                "frames": len(s.poses),
                "p50_latency_s": float(np.percentile(s.frame_latencies_s, 50))
                if s.frame_latencies_s else float("nan"),
                "p95_latency_s": float(np.percentile(s.frame_latencies_s, 95))
                if s.frame_latencies_s else float("nan"),
                "hole_fraction": s.stats.mean_hole_fraction,
                "scene": s.scene,
                "shed": s.shed,
            } for s in sessions
        }
        depths = self._queue_depth_log[qd_start:]
        occs = self._occupancy_log[qd_start:]
        waits = [s.admitted_s - s.submitted_s for s in sessions
                 if s.admitted_s is not None and s.submitted_s is not None]
        queue_metrics = {
            "depth_mean": float(np.mean(depths)) if depths else 0.0,
            "depth_max": int(max(depths)) if depths else 0,
            "wait_p50_s": float(np.percentile(waits, 50)) if waits else 0.0,
            "wait_p95_s": float(np.percentile(waits, 95)) if waits else 0.0,
            "shed": self._num_shed - shed_start,
        }
        slot_metrics = {
            "num_slots": self.num_slots,
            "occupancy_mean": (float(np.mean(occs)) / self.num_slots
                               if occs else 0.0),
            "active_slot_ticks": int(sum(occs)),
        }
        # scene-cache spend of THIS run: lifetime counters snapshotted at
        # entry, as for pool.recompiles
        scene_metrics = None
        if self.multi_scene:
            end = self._scene_counters()
            scene_metrics = {
                k: end[k] - sc_start[k]
                for k in ("hits", "misses", "evictions", "evicted_bytes",
                          "uploads", "uploaded_bytes")}
            looked = scene_metrics["hits"] + scene_metrics["misses"]
            scene_metrics["hit_rate"] = scene_metrics["hits"] / max(looked, 1)
            scene_metrics["resident_bytes"] = end["resident_bytes"]
            scene_metrics["resident_scenes"] = end["entries"]
            scene_metrics["budget_bytes"] = self.config.scene_cache_bytes
        engine = self.engine
        ns = engine.model.cfg.num_samples
        fixed_spt = self.num_slots * self.window * engine.hole_cap * ns
        entries = self._pool_log[log_start:]
        if engine.pool_holes and entries:
            spt = [self.num_slots * (e["bucket"] * ns + e["bucket_coarse"]
                                     * (ns // engine.coarse_factor))
                   for e in entries]
            samples_last = spt[-1]
            samples_mean = float(np.mean(spt))
            pool_slots = sum(self.num_slots * (e["bucket"]
                                               + e["bucket_coarse"])
                             for e in entries)
            util = float(sum(e["hole_total"] for e in entries)
                         / max(pool_slots, 1))
        else:
            samples_last, samples_mean, util = (fixed_spt, float(fixed_spt),
                                                float("nan"))
        pool_metrics = {
            "enabled": engine.pool_holes,
            "adaptive_sampling": engine.adaptive_sampling,
            "samples_per_tick": samples_last,
            "samples_per_tick_mean": samples_mean,
            "samples_per_tick_fixed_cap": fixed_spt,
            "work_reduction_vs_fixed_cap": fixed_spt / max(samples_last, 1),
            "utilization": util,
            "recompiles": len(engine.pool_buckets_used) - buckets_start,
            "ladder_size": engine.pool_ladder_size,
        }
        memory_metrics = (engine.tick_memory_stats(
            self.num_slots, self.window,
            bucket=self._tick_bucket if self._tick_bucket else None)
            if engine._seg_aware else None)
        if memory_metrics is not None:
            ticks_run = self.num_ticks - start_ticks
            adm_ticks = self._num_admission_ticks - adm_start
            staged = memory_metrics["staged_table_sweeps_per_tick"]
            memory_metrics["serving_path"] = ("fused" if self.fused
                                              else "staged")
            memory_metrics["admission_ticks"] = adm_ticks
            memory_metrics["serving_table_sweeps_per_tick_steady"] = (
                1.0 if self.fused else staged)
            memory_metrics["serving_table_sweeps_per_tick_amortized"] = (
                streaming_pipeline.serving_sweeps_per_tick(
                    ticks_run, adm_ticks, memory_metrics["staged_ref_sweeps"])
                if self.fused else staged)
        return {
            "ticks": self.num_ticks - start_ticks,
            "wall_s": wall_s,
            "aggregate_fps": total_frames / max(wall_s, 1e-9),
            "total_frames": total_frames,
            "per_session": per_session,
            "complete": all(s.done for s in sessions),
            "policy": self.policy.name,
            "pool": pool_metrics,
            "memory": memory_metrics,
            "queue": queue_metrics,
            "slots": slot_metrics,
            "scene_cache": scene_metrics,
            "devices": (self.engine.mesh.size()
                        if self.engine.mesh is not None else 1),
        }

    def _scene_counters(self) -> Dict[str, float]:
        return dict(self.scene_cache.counters(), uploads=self._num_uploads,
                    uploaded_bytes=self._uploaded_bytes)
