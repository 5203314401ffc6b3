"""repro_torch.api — the rendering facade of the port.

    from repro_torch import api
    from repro_torch.core.config import RenderConfig, RenderRequest

    renderer = api.make_renderer(RenderConfig(backend="streaming"))
    result = renderer.render(RenderRequest(poses=tuple(traj)))
    results, metrics = renderer.serve([RenderRequest(poses=tuple(t))
                                       for t in trajs], policy="priority")

``RenderConfig`` carries every knob: ``adaptive_sampling`` (with
``adaptive_var_threshold`` and ``coarse_factor``) splits the pooled holes
into a full-budget and a coarse sub-pool; ``engine="host"`` and
``mode="temporal"`` (TEMP-N) take the per-frame host loop;
``Renderer.render_baseline`` and ``render_ds2`` are the paper's full-NeRF
and DS-2 baselines.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or ``RenderConfig(device="cpu")``), where the kernels'
plain PyTorch versions run; with no card and no explicit CPU they raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import pipeline
from repro_torch.core.config import (  # noqa: F401 (facade re-exports)
    RenderConfig,
    RenderRequest,
    RenderResult,
    RenderStats,
)
from repro_torch.nerf import models, scenes
from repro_torch.serve.policies import (  # noqa: F401 (facade re-exports)
    FifoPolicy,
    PriorityPolicy,
    SchedulingPolicy,
)
from repro_torch.utils import DeviceLike, resolve_device


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):  # NGP's level tables, TensoRF's
        return [_to_device(v, device) for v in tree]  # planes and lines
    return tree.to(device)


class Renderer:
    """The facade over one (model, params, config); ``.pipeline`` is the
    underlying :class:`~repro_torch.core.pipeline.CiceroRenderer`."""

    def __init__(self, config: RenderConfig, model: models.NerfModel,
                 params: dict):
        self.config = config.resolved()
        self.model = model
        self.pipeline = pipeline.CiceroRenderer(model, params,
                                                config=self.config)
        self.params = self.pipeline.params
        self.cam = self.config.camera
        self.device = self.pipeline.device

    def render(self, request: Union[RenderRequest, Sequence[torch.Tensor]]
               ) -> RenderResult:
        """Render one session (a request, or a bare pose sequence)."""
        if not isinstance(request, RenderRequest):
            request = RenderRequest(poses=tuple(request))
        return self.pipeline.render(request)

    def serve(self, requests: Sequence[Union[RenderRequest,
                                             Sequence[torch.Tensor]]],
              policy: Union[None, str, SchedulingPolicy] = None,
              num_slots: Optional[int] = None
              ) -> Tuple[List[RenderResult], Dict[str, object]]:
        """Serve concurrent sessions through one batched device call per
        tick; ``policy`` picks the admission policy ("fifo" default,
        "priority", or any :class:`SchedulingPolicy`), ``num_slots``
        overrides ``config.num_slots``. Returns (results, metrics)."""
        return self.pipeline.serve(requests, policy=policy,
                                   num_slots=num_slots)

    # the paper's comparison baselines (full NeRF every frame; DS-2)
    def render_baseline(self, poses: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        return self.pipeline.render_baseline(list(poses))

    def render_ds2(self, poses: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        return self.pipeline.render_ds2(list(poses))


def make_renderer(config: RenderConfig, *,
                  model: Optional[models.NerfModel] = None,
                  params: Optional[dict] = None,
                  device: DeviceLike = None) -> Renderer:
    """Build a :class:`Renderer` for ``config`` on ``device`` (default:
    ``config.device``, else the CUDA card).

    With no ``model``/``params`` the scene is baked into a dense grid
    (``model_kind="dvgo"`` only) for the configured backend; otherwise both
    are used as given (``params`` moved to the device), e.g. a model of
    any kind with ``NerfModel.init`` weights or the reference's from
    :func:`repro_torch.convert.params_from_numpy`, or an ``oracle`` with
    ``{}``. The renderer's config records the device.
    """
    config = config.resolved()
    dev = resolve_device(device if device is not None else config.device)
    if config.device is None:
        config = config.replace(device=str(dev))
    if (model is None) != (params is None):
        raise TypeError("make_renderer: pass model and params together "
                        "(or neither)")
    if model is None and config.model_kind != "dvgo":
        raise ValueError(f"make_renderer bakes a dense grid: model_kind "
                         f"{config.model_kind!r} needs model= and params= "
                         f"(e.g. NerfModel.init)")
    if model is None:
        model, _ = models.make_model(
            config.model_kind, grid_res=config.grid_res,
            channels=config.channels, decoder=config.decoder,
            num_samples=config.num_samples, backend=config.backend,
            stream_capacity=config.stream_capacity,
            mvoxel_layout=config.mvoxel_layout)
        params = model.init_baked(scenes.make_scene(config.scene),
                                  device=dev)
    return Renderer(config, model, _to_device(params, dev))
