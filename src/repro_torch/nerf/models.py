"""NeRF models: feature grid + decoder + volume renderer (port of
``repro.nerf.models``). Four kinds: ``dvgo`` (dense grid), ``ngp`` (hash
grid), ``tensorf`` (VM grid) and ``oracle``, which renders the analytic
scene (exact density, view-dependent radiance) for warp-threshold
experiments.

Two execution backends (``NerfConfig.backend``):

* ``"reference"`` — pixel-centric gather + plain decoder;
* ``"streaming"`` — memory-centric order through the kernels: a ``dvgo``
  grid's features come from ``kernels.ops.gather_features_streaming`` (the
  GU kernel over MVoxel halo blocks), whose halo re-layout is built once
  per table by :meth:`NerfModel.prepare_streaming` and travels in
  ``params``; the hash and VM grids keep their plain queries (the paper's
  NGP-level fallback). With ``decoder="mlp"`` every kind's features decode
  through ``kernels.ops.nerf_mlp``.

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
from repro_torch.utils import DeviceLike, resolve_device


KINDS = ("dvgo", "ngp", "tensorf", "oracle")


@dataclass(frozen=True)
class NerfConfig:
    kind: str  # dvgo | ngp | tensorf | oracle
    grid_res: int = 64
    channels: int = 8
    hash_levels: int = 8
    hash_table_size: int = 2**14
    hash_base_res: int = 16
    hash_max_res: int = 256
    tensorf_rank: int = 8
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
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {'|'.join(KINDS)}, got "
                             f"{self.kind!r}")
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
    def hash_cfg(self) -> grids.HashGridCfg:
        return grids.HashGridCfg(num_levels=self.hash_levels,
                                 base_res=self.hash_base_res,
                                 max_res=self.hash_max_res,
                                 table_size=self.hash_table_size, channels=2)

    @property
    def tensorf_cfg(self) -> grids.TensoRFCfg:
        return grids.TensoRFCfg(res=self.grid_res, rank=self.tensorf_rank,
                                channels=self.channels)

    @property
    def feat_channels(self) -> int:
        if self.kind == "ngp":
            return self.hash_cfg.out_channels
        return self.channels

    @property
    def decoder_cfg(self) -> mlp.DecoderCfg:
        return mlp.DecoderCfg(mode=self.decoder,
                              in_channels=self.feat_channels,
                              hidden=self.mlp_hidden)

    def feature_table_bytes(self) -> int:
        """Model size (the paper's Fig. 2 x-axis): feature vectors only."""
        if self.kind == "dvgo":
            return self.grid_res**3 * self.channels * 4
        if self.kind == "ngp":
            return self.hash_levels * self.hash_table_size * 2 * 4
        if self.kind == "tensorf":
            return (3 * self.grid_res**2 * self.tensorf_rank
                    + 3 * self.grid_res * self.tensorf_rank) * 4
        return 0


class NerfModel:
    """Stateless apart from the halo-table cache: params (tensors on one
    device) are passed to every call. ``scene`` is the analytic scene an
    ``oracle`` renders (its params are ``{}``)."""

    def __init__(self, cfg: NerfConfig,
                 scene: Optional[scenes.Scene] = None):
        self.cfg = cfg
        self.scene = scene
        # (table identity, StreamingCfg) -> halo table. An LRU, so a model
        # serving alternating scenes rebuilds no table once both are
        # resident; the token keeps the table alive, so an identity hit
        # can never alias a recycled id
        self._mv_table_cache = SceneCache(max_entries=8)

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> dict:
        """Random parameters drawn from ``generator`` on its own device,
        placed on ``device`` (default: the CUDA card; raises without one):
        the kind's grid, then the decoder, at the reference's shapes and
        scales (the numbers differ from the reference's; tests carry its
        weights across with ``repro_torch.convert.params_from_numpy``)."""
        c = self.cfg
        dev = resolve_device(device)
        if c.kind == "dvgo":
            params = grids.dense_init(generator, c.dense_cfg, dev)
        elif c.kind == "ngp":
            params = grids.hash_init(generator, c.hash_cfg, dev)
        elif c.kind == "tensorf":
            params = grids.tensorf_init(generator, c.tensorf_cfg, dev)
        else:
            params = {}
        params["decoder"] = mlp.decoder_init(generator, c.decoder_cfg, dev)
        return params

    def init_baked(self, scene: scenes.Scene, device=None) -> dict:
        """Dense grid baked from the analytic scene; decoder = direct."""
        if self.cfg.kind != "dvgo":
            raise ValueError(f"init_baked bakes a dense grid: kind 'dvgo' "
                             f"only, got {self.cfg.kind!r}")
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
        reference backend and for every kind but ``dvgo``."""
        if self.cfg.backend != "streaming" or self.cfg.kind != "dvgo":
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
        each segment gathers from its own scene's page. The hash and VM
        grids query plainly on either backend."""
        c = self.cfg
        if c.backend == "streaming" and c.kind == "dvgo":
            scene_of_seg = params.get("scene_of_seg")
            if scene_of_seg is not None and seg is None:
                raise ValueError(
                    "multi-scene params (scene_of_seg present) need the "
                    "segment axis: render through the flat ray-batch core")
            return ops.gather_features_streaming(
                params["table"], points, self.streaming_cfg,
                mv_table=params.get("mv_table"), seg=seg, num_seg=num_seg,
                scene_of_seg=scene_of_seg)
        if c.kind == "dvgo":
            return grids.dense_query(params, points, c.dense_cfg)
        if c.kind == "ngp":
            return grids.hash_query(params, points, c.hash_cfg)
        if c.kind == "tensorf":
            return grids.tensorf_query(params, points, c.tensorf_cfg)
        raise ValueError(f"kind {c.kind!r} has no feature grid")

    def query_field(self, params: dict, points: torch.Tensor,
                    dirs: torch.Tensor, seg: Optional[torch.Tensor] = None,
                    num_seg: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sigma [S], rgb [S, 3]) at sample points ``points`` seen along
        ``dirs``; the oracle evaluates its analytic scene."""
        if self.cfg.kind == "oracle":
            if self.scene is None:
                raise ValueError("an oracle model needs its scene: "
                                 "NerfModel(cfg, scene=...)")
            return (scenes.scene_density(self.scene, points),
                    scenes.scene_radiance(self.scene, points, dirs))
        feats = self.query_features(params, points, seg=seg,
                                    num_seg=num_seg)
        return self.decode_features(params, feats, dirs)

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
                    num_seg: int = 1, num_samples: Optional[int] = None,
                    jitter: rays.Jitter = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render rays [R, 3] -> (colour [R, 3], depth [R]). ``seg`` [R]
        tags each ray with its segment for the streaming RIT;
        ``num_samples`` overrides the config's samples per ray (adaptive
        sampling's coarse sub-pool renders at ``num_samples //
        coarse_factor``); ``jitter`` stratifies the sample depths (the
        reference's ``key``: photometric training), see
        :func:`rays.sample_along_rays`."""
        c = self.cfg
        ns = int(num_samples) if num_samples is not None else c.num_samples
        pts, t_vals = rays.sample_along_rays(origins, dirs, c.near, c.far, ns,
                                             jitter)
        sample_seg = seg.repeat_interleave(ns) if seg is not None else None
        sigma, rgb = self.query_field(params, pts.reshape(-1, 3),
                                      dirs.repeat_interleave(ns, dim=0),
                                      seg=sample_seg, num_seg=num_seg)
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


def make_model(kind: str, scene: Optional[scenes.Scene] = None,
               **kw) -> Tuple[NerfModel, NerfConfig]:
    cfg = NerfConfig(kind=kind, **kw)
    return NerfModel(cfg, scene=scene), cfg
