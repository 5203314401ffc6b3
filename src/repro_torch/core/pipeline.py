"""CiceroRenderer — the end-to-end SpaRW pipeline (paper Fig. 10; port of
``repro.core.pipeline``).

Two engines drive the same algorithm:

* ``engine="device"`` (the default, off-trajectory schedule): each warp
  window is one :class:`DeviceSparwEngine` call (staged or fused tick);
  concurrent sessions are served through :class:`RenderServeEngine`.
* ``engine="host"``: the per-frame host loop, one frame at a time, the
  hole mask read back every frame and the holes rendered at their exact
  count (:meth:`CiceroRenderer.sparse_frame`). It is the paper's baseline
  loop and the only engine for TEMP-N (``mode="temporal"``), whose
  reference is the previously rendered frame.

Also the paper's other comparison baselines: full NeRF every frame
(:meth:`CiceroRenderer.render_baseline`) and DS-2, half resolution
upsampled x2 (:meth:`CiceroRenderer.render_ds2`).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import schedule, sparw
from repro_torch.core.config import RenderConfig, RenderRequest, \
    RenderResult, RenderStats
from repro_torch.core.engine import DeviceSparwEngine
from repro_torch.core.scene_cache import ParamsToken, SceneCache
from repro_torch.nerf import models, rays
from repro_torch.serve.policies import resolve_policy
from repro_torch.serve.render_engine import RenderServeEngine, RenderSession
from repro_torch.utils import params_device, psnr


class _EngineLRU(SceneCache):
    """A small least-recently-used cache of engines: a long-lived server
    renders many distinct per-request override configs, and an unbounded
    dict would keep one engine per config forever. It keeps the
    ``maxsize`` most recently used entries; an evicted engine keeps
    working for whoever holds it."""

    def __init__(self, maxsize: int = 16):
        super().__init__(max_entries=maxsize)
        self.maxsize = maxsize

    def put(self, key: tuple, value: object) -> None:
        super().put(key, value, nbytes=0)


class CiceroRenderer:
    """One (model, params, config). Engines are cached per ``(params
    identity, config)`` in small LRUs, so a request's ``window`` /
    ``hole_cap`` overrides get their own engine."""

    def __init__(self, model: models.NerfModel, params: dict, *,
                 config: RenderConfig):
        self.config = config.resolved()
        self.model = model
        self.params = model.prepare_streaming(params)
        self.cam = self.config.camera
        self.device = params_device(self.params, self.config.device)
        self._device_engines = _EngineLRU()
        self._serve_engines = _EngineLRU()

    # read-only views of the config's schedule knobs
    @property
    def window(self) -> int:
        return self.config.window

    @property
    def phi_deg(self) -> Optional[float]:
        return self.config.phi_deg

    @property
    def mode(self) -> str:
        return self.config.mode

    @property
    def engine(self) -> str:
        return self.config.engine

    @property
    def hole_cap(self) -> Optional[int]:
        return self.config.hole_cap

    def _engine_key(self, config: RenderConfig) -> tuple:
        return (ParamsToken(self.params), config)

    def device_engine_for(self, config: RenderConfig) -> DeviceSparwEngine:
        """The cached device engine for ``config`` (built on first use)."""
        key = self._engine_key(config)
        eng = self._device_engines.get(key)
        if eng is None:
            eng = DeviceSparwEngine(self.model, self.params, config=config)
            self._device_engines.put(key, eng)
        return eng

    @property
    def device_engine(self) -> DeviceSparwEngine:
        return self.device_engine_for(self.config)

    def full_frame(self, c2w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return self.model.render_image(self.params, self.cam,
                                           c2w.to(self.device))

    def sparse_frame(self, c2w: torch.Tensor, holes: torch.Tensor
                     ) -> torch.Tensor:
        """The host loop's sparse render: the hole pixels of ``holes``
        [H, W] at their exact count, in chunks of 8,192 rays; a full
        [H, W, 3] image, zero off the holes. Reads the mask back to the
        host (the baseline's per-frame sync, by design)."""
        h, w = self.cam.height, self.cam.width
        with torch.no_grad():
            o, d = rays.generate_rays(self.cam, c2w.to(self.device))
            idx = torch.nonzero(holes.reshape(-1))[:, 0].to(self.device)
            out = torch.zeros((h * w, 3), device=self.device)
            chunk = 1 << 13
            for i in range(0, idx.shape[0], chunk):
                sel = idx[i:i + chunk]
                out[sel], _ = self.model.render_rays(self.params, o[sel],
                                                     d[sel])
        return out.reshape(h, w, 3)

    def render_trajectory(self, poses: Sequence[torch.Tensor], *,
                          config: Optional[RenderConfig] = None
                          ) -> Tuple[List[torch.Tensor], RenderStats]:
        """SpaRW rendering of a pose trajectory: (frames, stats). Routes
        through the device engine except for TEMP-N (``mode="temporal"``,
        whose reference is the previous rendered frame) and
        ``engine="host"``, which take the host loop."""
        cfg = config or self.config
        if cfg.engine == "device" and cfg.mode == "offtraj":
            return self.device_engine_for(cfg).render_trajectory(list(poses))
        return self.render_trajectory_host(list(poses), config=cfg)

    def render(self, request: RenderRequest) -> RenderResult:
        """Render one :class:`RenderRequest`: frames, stats and the wall
        time up to the last frame being finished on the device."""
        cfg = self.config.apply_request(request)
        t0 = time.perf_counter()
        frames, stats = self.render_trajectory(request.poses, config=cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return RenderResult(frames=tuple(frames), stats=stats,
                            wall_s=time.perf_counter() - t0, sid=request.sid)

    def serve_engine_for(self, config: RenderConfig) -> RenderServeEngine:
        """The cached serving engine for ``config`` (keyed on the whole
        config, slots included)."""
        key = self._engine_key(config)
        eng = self._serve_engines.get(key)
        if eng is None:
            eng = RenderServeEngine(self.model, self.params, config=config)
            self._serve_engines.put(key, eng)
        return eng

    def serve(self, requests: Sequence[Union[RenderRequest,
                                             Sequence[torch.Tensor]]],
              policy=None, num_slots: Optional[int] = None
              ) -> Tuple[List[RenderResult], Dict[str, object]]:
        """Serve several sessions through one batched device call per tick
        (see :mod:`repro_torch.serve.render_engine`) with an admission
        ``policy`` (default FIFO). Returns (per-request results, serve
        metrics); a result's ``wall_s`` is the sum of its frame
        latencies."""
        if self.config.mode != "offtraj":
            raise ValueError("multi-session serving requires mode='offtraj' "
                             "(TEMP-N is inherently serialized)")
        reqs = [r if isinstance(r, RenderRequest)
                else RenderRequest(poses=tuple(r)) for r in requests]
        slots = num_slots or self.config.num_slots
        serve = self.serve_engine_for(self.config.replace(num_slots=slots))
        serve.policy = resolve_policy(policy)
        sessions = [RenderSession.from_request(req, sid=i)
                    for i, req in enumerate(reqs)]
        metrics = serve.run(sessions)
        results = [RenderResult(frames=tuple(s.frames), stats=s.stats,
                                wall_s=float(sum(s.frame_latencies_s)),
                                sid=s.sid)
                   for s in sessions]
        return results, metrics

    def render_trajectories(self, trajectories: List[List[torch.Tensor]],
                            num_slots: Optional[int] = None
                            ) -> Tuple[List[List[torch.Tensor]],
                                       List[RenderStats], Dict[str, object]]:
        """Multi-session SpaRW over bare pose lists: :meth:`serve` with FIFO
        admission and (by default) one slot per trajectory."""
        results, metrics = self.serve(
            [RenderRequest(poses=tuple(t)) for t in trajectories],
            policy="fifo", num_slots=num_slots or len(trajectories))
        return ([list(r.frames) for r in results],
                [r.stats for r in results], metrics)

    def render_trajectory_host(self, poses: List[torch.Tensor], *,
                               config: Optional[RenderConfig] = None
                               ) -> Tuple[List[torch.Tensor], RenderStats]:
        """The per-frame host loop (one frame at a time, the hole mask read
        back every frame): the paper's baseline loop and TEMP-N. In
        TEMP-N a window's reference is the previously rendered frame, with
        depth from a full render of its pose; only real reference renders
        count in ``stats.reference_renders``."""
        cfg = config or self.config
        stats = RenderStats()
        plan = schedule.WarpSchedule(cfg.window, cfg.mode).plan(poses)
        frames: List[Optional[torch.Tensor]] = [None] * len(poses)
        ref_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = {}
        for rec in plan:
            f = rec["frame"]
            k = rec["window_start"]
            if k not in ref_cache:
                idx = rec["ref_frame_idx"]
                if cfg.mode == "temporal" and idx is not None \
                        and frames[idx] is not None:
                    ref_pose = poses[idx]
                    rgb_ref = frames[idx]
                    _, dep_ref = self.full_frame(ref_pose)
                else:
                    ref_pose = rec["ref_pose"]
                    rgb_ref, dep_ref = self.full_frame(ref_pose)
                    stats.reference_renders += 1
                ref_cache = {k: (rgb_ref, dep_ref, ref_pose)}  # one window
            rgb_ref, dep_ref, ref_pose = ref_cache[k]
            with torch.no_grad():
                warped = sparw.warp_frame(
                    rgb_ref, dep_ref, ref_pose.to(self.device),
                    poses[f].to(self.device), self.cam, phi_deg=cfg.phi_deg)
            holes = warped.holes.cpu()
            frames[f] = sparw.combine(warped,
                                      self.sparse_frame(poses[f], holes),
                                      warped.holes)
            n_holes = int(holes.sum())
            stats.frames += 1
            stats.total_pixels += holes.numel()
            stats.sparse_pixels += n_holes
            stats.warped_pixels += holes.numel() - n_holes
            stats.hole_fractions.append(n_holes / holes.numel())
        return [f for f in frames if f is not None], stats

    def render_baseline(self, poses: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Full NeRF render of every frame (the paper's baseline)."""
        return [self.full_frame(p)[0] for p in poses]

    def render_ds2(self, poses: List[torch.Tensor]) -> List[torch.Tensor]:
        """DS-2 baseline: render at half resolution, bilinear upsample x2
        (half-pixel centres, the edge rows and columns taking the edge
        pixel, as ``jax.image.resize`` does)."""
        half = rays.Camera(self.cam.height // 2, self.cam.width // 2,
                           self.cam.focal / 2.0, self.cam.cx / 2.0,
                           self.cam.cy / 2.0)
        out = []
        with torch.no_grad():
            for p in poses:
                img, _ = self.model.render_image(self.params, half,
                                                 p.to(self.device))
                up = torch.nn.functional.interpolate(
                    img.permute(2, 0, 1)[None],
                    size=(self.cam.height, self.cam.width), mode="bilinear",
                    align_corners=False, antialias=False)
                out.append(up[0].permute(1, 2, 0))
        return out


def trajectory_psnr(frames: List[torch.Tensor],
                    gt: List[torch.Tensor]) -> float:
    return float(np.mean([float(psnr(f, g)) for f, g in zip(frames, gt)]))


def orbit_trajectory(n_frames: int, step_deg: float = 1.0,
                     radius: float = 2.6, wobble: float = 0.05,
                     phase_deg: float = 0.0) -> List[torch.Tensor]:
    """A smooth orbit (consecutive frames close together — the paper's
    real-time premise); CPU poses, moved to the device by the engine."""
    return [rays.orbit_pose(math.radians(phase_deg + i * step_deg),
                            radius=radius, wobble=wobble)
            for i in range(n_frames)]
