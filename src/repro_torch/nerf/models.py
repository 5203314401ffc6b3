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
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import streaming
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

    _CACHE_ENTRIES = 8

    def __init__(self, cfg: NerfConfig):
        self.cfg = cfg
        # (id(table), StreamingCfg) -> (table, mv_table); the table itself
        # is kept so its id cannot be recycled while the entry lives
        self._mv_tables: "OrderedDict[tuple, tuple]" = OrderedDict()

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
        small LRU. A table staged under another layout is rebuilt. No-op on
        the reference backend."""
        if self.cfg.backend != "streaming":
            return params
        scfg = self.streaming_cfg
        mv_table = params.get("mv_table")
        if mv_table is not None and mv_table.shape[1] == scfg.halo_rows:
            return params
        table = params["table"]
        key = (id(table), scfg)
        hit = self._mv_tables.get(key)
        if hit is not None and hit[0] is table:
            self._mv_tables.move_to_end(key)
            mv_table = hit[1]
        else:
            mv_table = streaming.build_mvoxel_table(table, scfg)
            self._mv_tables[key] = (table, mv_table)
            while len(self._mv_tables) > self._CACHE_ENTRIES:
                self._mv_tables.popitem(last=False)
        return {**params, "mv_table": mv_table}

    def query_features(self, params: dict, points: torch.Tensor,
                       seg: Optional[torch.Tensor] = None,
                       num_seg: int = 1) -> torch.Tensor:
        """Features at ``points`` [S, 3]; ``seg``/``num_seg`` bucket the
        streaming gather's RIT per (segment, MVoxel)."""
        if self.cfg.backend == "streaming":
            return ops.gather_features_streaming(
                params["table"], points, self.streaming_cfg,
                mv_table=params.get("mv_table"), seg=seg, num_seg=num_seg)
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
                    num_seg: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render rays [R, 3] -> (colour [R, 3], depth [R]). ``seg`` [R]
        tags each ray with its segment for the streaming RIT."""
        c = self.cfg
        ns = c.num_samples
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
                         num_seg: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rays of any leading shape flattened into one call."""
        return self.render_rays(params, origins.reshape(-1, 3),
                                dirs.reshape(-1, 3), seg=seg, num_seg=num_seg)

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
