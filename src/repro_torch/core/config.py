"""The declarative rendering surface: config / request / result, and the
pooled hole-capacity controller (port of ``repro.core.config``).

:class:`RenderConfig` holds the knobs of the staged and fused render paths
and of the serving engine (multi-scene paging included); ``device`` takes
the place of the reference's Pallas interpret flag (None = the CUDA card,
which must exist; "cpu" runs the plain PyTorch versions of the kernels).
The reference's legacy-kwarg shims and its sharding knobs are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.nerf.rays import Camera


@dataclass
class RenderStats:
    """Per-session SpaRW work accounting (paper Fig. 13/16 quantities)."""

    frames: int = 0
    reference_renders: int = 0
    warped_pixels: int = 0
    sparse_pixels: int = 0  # hole pixels NeRF-rendered
    fallback_pixels: int = 0  # extra non-hole pixels re-rendered on overflow
    total_pixels: int = 0
    hole_fractions: List[float] = field(default_factory=list)

    @property
    def mean_hole_fraction(self) -> float:
        return (float(np.mean(self.hole_fractions))
                if self.hole_fractions else 0.0)

    @property
    def mlp_work_fraction(self) -> float:
        """Fraction of the full-render MLP work actually executed."""
        if self.total_pixels == 0:
            return 1.0
        full_equiv = self.reference_renders * (self.total_pixels
                                               / max(self.frames, 1))
        return (full_equiv + self.sparse_pixels
                + self.fallback_pixels) / self.total_pixels

    def record_frame(self, hole_count: int, overflowed: bool, hw: int) -> None:
        """Accumulate one frame: its holes are always NeRF-rendered; a dense
        fallback also re-renders the warped pixels (``fallback_pixels``)."""
        self.frames += 1
        self.total_pixels += hw
        self.hole_fractions.append(hole_count / hw)
        self.sparse_pixels += hole_count
        if overflowed:
            self.fallback_pixels += hw - hole_count
        self.warped_pixels += hw - hole_count


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclass
class HoleCapController:
    """EWMA controller of a session's pooled hole capacity: the EWMA of
    observed window hole totals times ``safety``, rounded up to a power of
    two and clamped to ``[min_bucket, max_bucket]``; the worst case
    (``window * hole_cap``) until the first observation. ``fixed`` pins
    the bucket."""

    worst: int
    min_bucket: int = 128
    safety: float = 1.25
    alpha: float = 0.4  # EWMA weight of the newest observation
    fixed: Optional[int] = None

    def __post_init__(self) -> None:
        self.max_bucket = max(next_pow2(max(self.worst, 1)), self.min_bucket)
        self.ewma: Optional[float] = None

    def reset(self) -> None:
        self.ewma = None

    def observe(self, window_total: int) -> None:
        t = float(window_total)
        self.ewma = (t if self.ewma is None
                     else self.alpha * t + (1.0 - self.alpha) * self.ewma)

    @property
    def ladder_size(self) -> int:
        """Distinct buckets the controller can emit."""
        if self.fixed is not None:
            return 1
        return int(np.log2(self.max_bucket // self.min_bucket)) + 1

    @property
    def bucket(self) -> int:
        if self.fixed is not None:
            return self.fixed
        if self.ewma is None:
            return self.max_bucket
        target = next_pow2(int(np.ceil(self.ewma * self.safety)))
        return min(max(target, self.min_bucket), self.max_bucket)


@dataclass(frozen=True)
class RenderConfig:
    """Everything that shapes a render, in one frozen, hashable value
    (equal configs share a cached engine)."""

    # --- scene + camera ---------------------------------------------------
    scene: str = "lego"
    camera: Optional[Camera] = None
    res: int = 64  # used only when camera is None
    # --- SpaRW schedule ---------------------------------------------------
    window: int = 16  # warp window N (targets per reference)
    num_slots: int = 4  # serving: concurrent session slots
    phi_deg: Optional[float] = None  # warp angular threshold (Eq. 4)
    hole_cap: Optional[int] = None  # per-frame sparse-ray capacity
    mode: str = "offtraj"  # offtraj | temporal (the TEMP-N baseline)
    engine: str = "device"  # device | host (the per-frame host loop)
    # rays per NeRF call of a flat stage; each stage chunks at
    # min(ray_chunk, ceil(quantum / 2)) exactly as the reference does, so
    # every chunk's RIT (and its overflow set) matches
    ray_chunk: int = 4096
    # --- pooled hole capacity ---------------------------------------------
    pool_holes: bool = True  # False: per-frame [N * hole_cap] hole batch
    pool_bucket: Optional[int] = None  # pin the pooled bucket (pow2)
    pool_min_bucket: int = 128
    pool_safety: float = 1.25
    pool_ewma_alpha: float = 0.4
    # adaptive sampling of the pooled hole batch: holes whose warped 3x3
    # neighbourhood agrees (>= 3 warped neighbours, radiance variance <=
    # adaptive_var_threshold) render at num_samples // coarse_factor in a
    # coarse sub-pool with its own controller; the others keep the full
    # budget
    adaptive_sampling: bool = False
    adaptive_var_threshold: float = 0.0002
    coarse_factor: int = 4
    mvoxel_layout: str = "identity"  # identity | bank_interleaved
    # --- unified streaming tick -------------------------------------------
    # fused_tick=True renders each window's pooled holes and the NEXT
    # window's reference through one dual-RIT MVoxel sweep (kernel B3),
    # for trajectories and for the serving engine
    fused_tick: bool = False
    # --- model shape (what make_renderer builds) ---------------------------
    model_kind: str = "dvgo"
    backend: str = "reference"  # reference | streaming (kernel hot path)
    grid_res: int = 48
    channels: int = 4
    decoder: str = "direct"
    num_samples: int = 32
    stream_capacity: int = 512
    # --- multi-scene serving ----------------------------------------------
    # byte budget of the serving engine's device-resident scene pages
    # (SceneCache): unpinned scenes are evicted LRU once resident dense +
    # MVoxel tables exceed it; 0 = no byte budget (num_slots pages bound
    # residency)
    scene_cache_bytes: int = 0
    # --- where it runs ----------------------------------------------------
    device: Optional[str] = None  # None: the CUDA card; "cpu": plain path

    def __post_init__(self) -> None:
        if self.mode not in ("offtraj", "temporal"):
            raise ValueError(f"mode must be offtraj|temporal, got "
                             f"{self.mode!r}")
        if self.engine not in ("device", "host"):
            raise ValueError(f"engine must be device|host, got "
                             f"{self.engine!r}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.hole_cap is not None and self.hole_cap < 1:
            raise ValueError(f"hole_cap must be >= 1 (or None), got "
                             f"{self.hole_cap}")
        if self.ray_chunk < 1:
            raise ValueError(f"ray_chunk must be >= 1, got {self.ray_chunk}")
        if self.pool_min_bucket < 2 or \
                next_pow2(self.pool_min_bucket) != self.pool_min_bucket:
            raise ValueError(f"pool_min_bucket must be a power of two >= 2, "
                             f"got {self.pool_min_bucket}")
        if self.pool_bucket is not None and (
                self.pool_bucket < 1
                or next_pow2(self.pool_bucket) != self.pool_bucket):
            raise ValueError(f"pool_bucket must be a power of two >= 1 (or "
                             f"None), got {self.pool_bucket}")
        if self.pool_safety < 1.0:
            raise ValueError(f"pool_safety must be >= 1.0, got "
                             f"{self.pool_safety}")
        if not 0.0 < self.pool_ewma_alpha <= 1.0:
            raise ValueError(f"pool_ewma_alpha must be in (0, 1], got "
                             f"{self.pool_ewma_alpha}")
        if self.adaptive_sampling and not self.pool_holes:
            raise ValueError("adaptive_sampling requires pool_holes=True "
                             "(it subdivides the pooled hole batch)")
        if self.coarse_factor < 2:
            raise ValueError(f"coarse_factor must be >= 2, got "
                             f"{self.coarse_factor}")
        if self.adaptive_sampling and \
                self.num_samples % self.coarse_factor != 0:
            raise ValueError(
                f"adaptive_sampling needs num_samples ({self.num_samples}) "
                f"divisible by coarse_factor ({self.coarse_factor})")
        if self.mvoxel_layout not in ("identity", "bank_interleaved"):
            raise ValueError(f"mvoxel_layout must be identity|"
                             f"bank_interleaved, got {self.mvoxel_layout!r}")
        if self.fused_tick and self.backend != "streaming":
            raise ValueError("fused_tick=True requires backend='streaming' "
                             "(the fused tick streams the MVoxel table)")
        if self.fused_tick and not self.pool_holes:
            raise ValueError("fused_tick=True requires pool_holes=True (the "
                             "fused tick renders the pooled hole batch)")
        if self.fused_tick and self.adaptive_sampling:
            raise ValueError(
                "fused_tick=True does not support adaptive_sampling: the "
                "fused sweep carries one hole RIT, not a fine/coarse split")
        if self.scene_cache_bytes < 0:
            raise ValueError(
                f"scene_cache_bytes must be >= 0 (0 disables the byte "
                f"budget), got {self.scene_cache_bytes}")

    def resolved(self) -> "RenderConfig":
        """A config whose ``camera`` is a concrete :class:`Camera`."""
        if self.camera is not None:
            return self
        return dataclasses.replace(self, camera=Camera.square(self.res))

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def apply_request(self, request: "RenderRequest") -> "RenderConfig":
        """Fold a request's per-session overrides in."""
        kw = {k: getattr(request, k)
              for k in ("window", "hole_cap", "pool_bucket")
              if getattr(request, k) is not None}
        return dataclasses.replace(self, **kw) if kw else self


@dataclass(frozen=True, eq=False)  # eq=False: hash by identity (holds poses)
class RenderRequest:
    """One client session: a pose trajectory + per-session overrides.
    ``scene`` names the scene a multi-scene serving engine pages in for
    it (None: the engine's own scene)."""

    poses: Tuple[object, ...]  # [4,4] c2w pose per frame
    sid: Optional[int] = None
    scene: Optional[str] = None
    window: Optional[int] = None
    hole_cap: Optional[int] = None
    pool_bucket: Optional[int] = None
    priority: int = 0  # serving admission (PriorityPolicy)
    deadline_ms: Optional[float] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "poses", tuple(self.poses))
        if not self.poses:
            raise ValueError("RenderRequest needs at least one pose")
        if self.scene is not None and (
                not isinstance(self.scene, str) or not self.scene):
            raise ValueError(
                f"scene must be a non-empty scene name or None (engine's "
                f"configured scene), got {self.scene!r}")
        if self.window is not None and self.window < 1:
            raise ValueError(f"window override must be >= 1, got "
                             f"{self.window}")
        if self.hole_cap is not None and self.hole_cap < 1:
            raise ValueError(f"hole_cap override must be >= 1, got "
                             f"{self.hole_cap}")
        if self.pool_bucket is not None and (
                self.pool_bucket < 1
                or next_pow2(self.pool_bucket) != self.pool_bucket):
            raise ValueError(f"pool_bucket override must be a power of two "
                             f">= 1, got {self.pool_bucket}")


@dataclass(frozen=True, eq=False)
class RenderResult:
    """Frames + work statistics + wall-clock timing for one request."""

    frames: Tuple[object, ...]  # [H,W,3] per frame
    stats: RenderStats
    wall_s: float
    sid: Optional[int] = None

    @property
    def fps(self) -> float:
        return len(self.frames) / max(self.wall_s, 1e-9)
