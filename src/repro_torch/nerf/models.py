"""NeRF model: dense grid + decoder + volume renderer (port of
``repro.nerf.models`` for the ``dvgo`` kind; ``ngp``, ``tensorf`` and the
analytic ``oracle`` are not ported yet).

Two execution backends (``NerfConfig.backend``):

* ``"reference"`` — pixel-centric gather + plain decoder;
* ``"streaming"`` — memory-centric order through the kernels:
  ``kernels.ops.gather_features_streaming`` (the GU kernel over MVoxel
  halo blocks) and, for ``decoder="mlp"``, ``kernels.ops.nerf_mlp``.
  The halo re-layout of the feature table is built once per table by
  :meth:`NerfModel.prepare_streaming` and travels in ``params``.

Multi-scene serving rides the same calls: params holding the stacked
resident pages (``table [K, res^3, C]``, ``mv_table [K, num_mv, P, C]``)
and a ``scene_of_seg [num_seg]`` map make each segment gather from its own
scene's page.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import streaming
from repro_torch.core.scene_cache import ParamsToken, SceneCache
from repro_torch.kernels import ops
from repro_torch.nerf import grids, mlp, rays, scenes, volrend


@dataclass(frozen=True)
class NerfConfig:
    kind: str  # dvgo
    grid_res: int = 64
    channels: int = 8
    decoder: str = "mlp"  # mlp | direct
    mlp_hidden: int = 64
    num_samples: int = 64
    near: float = 0.5
    far: float = 6.0
    white_bkgd: bool = True
    backend: str = "reference"  # reference | streaming (kernel hot path)
    stream_mvoxel_edge: int = 8  # paper: 8^3-point MVoxels
    stream_capacity: int = 512  # RIT capacity (overflow -> fallback)
    mvoxel_layout: str = "identity"  # identity | bank_interleaved

    def __post_init__(self) -> None:
        if self.kind != "dvgo":
            raise NotImplementedError(
                f"model kind {self.kind!r} is not ported yet (dvgo only)")
        if self.backend not in ("reference", "streaming"):
            raise ValueError(f"backend must be reference|streaming, got "
                             f"{self.backend!r}")
        if self.decoder not in ("mlp", "direct"):
            raise ValueError(f"decoder must be mlp|direct, got "
                             f"{self.decoder!r}")

    @property
    def dense_cfg(self) -> grids.DenseGridCfg:
        return grids.DenseGridCfg(res=self.grid_res, channels=self.channels)

    @property
    def decoder_cfg(self) -> mlp.DecoderCfg:
        return mlp.DecoderCfg(mode=self.decoder, in_channels=self.channels,
                              hidden=self.mlp_hidden)


class NerfModel:
    """Stateless apart from the halo-table cache: params (tensors on one
    device) are passed to every call."""

    def __init__(self, cfg: NerfConfig):
        self.cfg = cfg
        # (table identity, StreamingCfg) -> halo table. An LRU, so a model
        # serving alternating scenes rebuilds no table once both are
        # resident; the token keeps the table alive, so an identity hit
        # can never alias a recycled id
        self._mv_table_cache = SceneCache(max_entries=8)

    def init_baked(self, scene: scenes.Scene, device=None) -> dict:
        """Dense grid baked from the analytic scene; decoder = direct."""
        if self.cfg.decoder != "direct":
            raise ValueError("init_baked needs decoder='direct' (the baked "
                             "table holds sigma and rgb directly)")
        table = scenes.bake_dense_table(scene, self.cfg.grid_res,
                                        self.cfg.channels, device=device)
        return {"table": table, "decoder": {}}

    @property
    def streaming_cfg(self) -> streaming.StreamingCfg:
        c = self.cfg
        return streaming.StreamingCfg(grid_res=c.grid_res,
                                      mvoxel_edge=c.stream_mvoxel_edge,
                                      capacity=c.stream_capacity,
                                      layout=c.mvoxel_layout)

    def prepare_streaming(self, params: dict) -> dict:
        """Attach the MVoxel halo table (``"mv_table"``) for the streaming
        backend, built once per (table, streaming geometry) and cached in a
        small LRU. A table staged under another layout is rebuilt; a
        stacked multi-scene page set ``[K, num_mv, P, C]`` (owned by the
        serving engine's scene pager) passes through. No-op on the
        reference backend."""
        if self.cfg.backend != "streaming":
            return params
        scfg = self.streaming_cfg
        mv_table = params.get("mv_table")
        if mv_table is not None and (mv_table.ndim == 4
                                     or mv_table.shape[1] == scfg.halo_rows):
            return params
        table = params["table"]
        mv_table = self._mv_table_cache.get_or_build(
            (ParamsToken(table), scfg),
            lambda: ((built := streaming.build_mvoxel_table(table, scfg)),
                     built.numel() * built.element_size()))
        return {**params, "mv_table": mv_table}

    def query_features(self, params: dict, points: torch.Tensor,
                       seg: Optional[torch.Tensor] = None,
                       num_seg: int = 1) -> torch.Tensor:
        """Features at ``points`` [S, 3]; ``seg``/``num_seg`` bucket the
        streaming gather's RIT per (segment, MVoxel). Params carrying a
        ``scene_of_seg`` map (the stacked multi-scene pages) need ``seg``:
        each segment gathers from its own scene's page."""
        if self.cfg.backend == "streaming":
            scene_of_seg = params.get("scene_of_seg")
            if scene_of_seg is not None and seg is None:
                raise ValueError(
                    "multi-scene params (scene_of_seg present) need the "
                    "segment axis: render through the flat ray-batch core")
            return ops.gather_features_streaming(
                params["table"], points, self.streaming_cfg,
                mv_table=params.get("mv_table"), seg=seg, num_seg=num_seg,
                scene_of_seg=scene_of_seg)
        return grids.dense_query(params, points, self.cfg.dense_cfg)

    def decode_features(self, params: dict, feats: torch.Tensor,
                        dirs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gathered features -> (sigma, rgb); the streaming backend's MLP
        decoder runs the fused kernel."""
        if self.cfg.backend == "streaming" and self.cfg.decoder == "mlp":
            return ops.nerf_mlp(feats, mlp._dir_enc(dirs), params["decoder"])
        return mlp.decode(params["decoder"], feats, dirs,
                          self.cfg.decoder_cfg)

    def render_rays(self, params: dict, origins: torch.Tensor,
                    dirs: torch.Tensor, seg: Optional[torch.Tensor] = None,
                    num_seg: int = 1, num_samples: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render rays [R, 3] -> (colour [R, 3], depth [R]). ``seg`` [R]
        tags each ray with its segment for the streaming RIT;
        ``num_samples`` overrides the config's samples per ray (adaptive
        sampling's coarse sub-pool renders at ``num_samples //
        coarse_factor``)."""
        c = self.cfg
        ns = int(num_samples) if num_samples is not None else c.num_samples
        pts, t_vals = rays.sample_along_rays(origins, dirs, c.near, c.far, ns)
        sample_seg = seg.repeat_interleave(ns) if seg is not None else None
        feats = self.query_features(params, pts.reshape(-1, 3),
                                    seg=sample_seg, num_seg=num_seg)
        sigma, rgb = self.decode_features(params, feats,
                                          dirs.repeat_interleave(ns, dim=0))
        color, depth, _ = volrend.composite(sigma.reshape(-1, ns),
                                            rgb.reshape(-1, ns, 3), t_vals,
                                            c.far, c.white_bkgd)
        return color, depth

    def render_rays_flat(self, params: dict, origins: torch.Tensor,
                         dirs: torch.Tensor,
                         seg: Optional[torch.Tensor] = None,
                         num_seg: int = 1, num_samples: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rays of any leading shape flattened into one call."""
        return self.render_rays(params, origins.reshape(-1, 3),
                                dirs.reshape(-1, 3), seg=seg, num_seg=num_seg,
                                num_samples=num_samples)

    def render_image(self, params: dict, cam: rays.Camera, c2w: torch.Tensor,
                     chunk: int = 1 << 14
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-frame render, chunked over rays: ([H,W,3], [H,W])."""
        o, d = rays.generate_rays(cam, c2w)
        cols, deps = zip(*(self.render_rays(params, o[i:i + chunk],
                                            d[i:i + chunk])
                           for i in range(0, o.shape[0], chunk)))
        return (torch.cat(cols).reshape(cam.height, cam.width, 3),
                torch.cat(deps).reshape(cam.height, cam.width))

    def render_image_batch(self, params: dict, cam: rays.Camera,
                           c2ws: torch.Tensor, chunk: int = 1 << 14
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full frames for a pose batch [S,4,4] -> ([S,H,W,3], [S,H,W]);
        each chunk is one call over all S poses' rays, segment-tagged."""
        o, d = rays.generate_rays_batch(cam, c2ws)  # [S, HW, 3]
        s = o.shape[0]
        cols, deps = [], []
        for i in range(0, o.shape[1], chunk):
            width = o[:, i:i + chunk].shape[1]
            seg = torch.arange(s, device=o.device).repeat_interleave(width)
            col, dep = self.render_rays_flat(params, o[:, i:i + chunk],
                                             d[:, i:i + chunk], seg=seg,
                                             num_seg=s)
            cols.append(col.reshape(s, width, 3))
            deps.append(dep.reshape(s, width))
        return (torch.cat(cols, 1).reshape(s, cam.height, cam.width, 3),
                torch.cat(deps, 1).reshape(s, cam.height, cam.width))


def make_model(kind: str, **kw) -> Tuple[NerfModel, NerfConfig]:
    cfg = NerfConfig(kind=kind, **kw)
    return NerfModel(cfg), cfg
