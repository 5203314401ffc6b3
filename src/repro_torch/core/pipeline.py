"""CiceroRenderer — the end-to-end SpaRW pipeline (paper Fig. 10; port of
the device-engine parts of ``repro.core.pipeline``).

Renders a trajectory through :class:`DeviceSparwEngine` (staged or fused
tick), serves concurrent sessions through :class:`RenderServeEngine` and
provides the full-NeRF-every-frame baseline. Not ported yet: the host
frame loop (TEMP-N) and DS-2.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import RenderConfig, RenderRequest, \
    RenderResult, RenderStats
from repro_torch.core.engine import DeviceSparwEngine
from repro_torch.nerf import models, rays
from repro_torch.serve.policies import resolve_policy
from repro_torch.serve.render_engine import RenderServeEngine, RenderSession
from repro_torch.utils import psnr


class CiceroRenderer:
    """One (model, params, config); engines are cached per config, so a
    request's ``window``/``hole_cap`` overrides get their own engine."""

    def __init__(self, model: models.NerfModel, params: dict, *,
                 config: RenderConfig):
        self.config = config.resolved()
        self.model = model
        self.params = model.prepare_streaming(params)
        self.cam = self.config.camera
        self.device = self.params["table"].device
        self._engines: Dict[RenderConfig, DeviceSparwEngine] = {}
        self._serve_engines: Dict[RenderConfig, RenderServeEngine] = {}

    def device_engine_for(self, config: RenderConfig) -> DeviceSparwEngine:
        eng = self._engines.get(config)
        if eng is None:
            eng = DeviceSparwEngine(self.model, self.params, config=config)
            self._engines[config] = eng
        return eng

    def full_frame(self, c2w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return self.model.render_image(self.params, self.cam,
                                           c2w.to(self.device))

    def render_trajectory(self, poses: Sequence[torch.Tensor], *,
                          config: Optional[RenderConfig] = None
                          ) -> Tuple[List[torch.Tensor], RenderStats]:
        """SpaRW rendering of a pose trajectory: (frames, stats)."""
        cfg = config or self.config
        return self.device_engine_for(cfg).render_trajectory(list(poses))

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
        eng = self._serve_engines.get(config)
        if eng is None:
            eng = RenderServeEngine(self.model, self.params, config=config)
            self._serve_engines[config] = eng
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

    def render_baseline(self, poses: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Full NeRF render of every frame (the paper's baseline)."""
        return [self.full_frame(p)[0] for p in poses]


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
