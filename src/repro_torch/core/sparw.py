"""SpaRW — Sparse Radiance Warping (paper section III; port of
``repro.core.sparw``).

Steps: (1) frame -> point cloud (Eq. 1), (2) rigid transform to the target
camera (Eq. 2), (3) perspective re-projection with z-buffering (Eq. 3),
(4) sparse NeRF rendering of disoccluded pixels (Eq. 4). The z-buffer is a
deterministic two-pass scatter (min depth, then the max source index among
depth ties), written as ``scatter_reduce_`` into buffers with one extra
dump slot that takes every dropped candidate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.nerf.rays import Camera


class WarpResult(NamedTuple):
    rgb: torch.Tensor  # [..., H, W, 3] warped colours (holes = 0)
    depth: torch.Tensor  # [..., H, W] z-buffer depth (holes = +inf)
    holes: torch.Tensor  # [..., H, W] bool — needs sparse NeRF rendering
    warp_angle: torch.Tensor  # [..., H, W] radians (only where warped)


def frame_to_pointcloud(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Eq. 1: per-pixel points in the reference camera frame.
    depth [..., H, W] -> [..., H*W, 3]."""
    h, w = depth.shape[-2:]
    v, u = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    d = depth.reshape(*depth.shape[:-2], h * w)
    x = (u.reshape(-1) + 0.5 - cam.cx) * d / cam.focal
    y = (v.reshape(-1) + 0.5 - cam.cy) * d / cam.focal
    return torch.stack([x, y, d], dim=-1)


def transform_points(points: torch.Tensor, c2w_ref: torch.Tensor,
                     c2w_tgt: torch.Tensor) -> torch.Tensor:
    """Eq. 2: reference-camera points [P, 3] into the target camera's
    frame, ``w2c_tgt @ c2w_ref`` (``R^T x`` written ``x @ R``)."""
    r_ref, t_ref = c2w_ref[:3, :3], c2w_ref[:3, 3]
    r_tgt, t_tgt = c2w_tgt[:3, :3], c2w_tgt[:3, 3]
    world = points @ r_ref.T + t_ref
    return (world - t_tgt) @ r_tgt


def project(points_tgt: torch.Tensor, cam: Camera
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 3: perspective projection of target-frame points [..., 3] ->
    (u, v, z) in the target image, each [...]."""
    z = points_tgt[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.focal * points_tgt[..., 0] / safe_z + cam.cx - 0.5
    v = cam.focal * points_tgt[..., 1] / safe_z + cam.cy - 0.5
    return u, v, z


def _project_to_target(depth_ref: torch.Tensor, c2w_ref: torch.Tensor,
                       c2w_tgt: torch.Tensor, cam: Camera,
                       phi_deg: Optional[float]):
    """Steps 1-3 up to the z-buffer scatter for S sessions x N targets.

    depth_ref [S,H,W], c2w_ref [S,4,4], c2w_tgt [S,N,4,4] -> per reference
    pixel and target: (raster address [S,N,HW] int64, target-space z,
    valid bool, warp angle), each [S, N, HW].
    """
    h, w = depth_ref.shape[-2:]
    pts_ref = frame_to_pointcloud(depth_ref, cam)  # [S, HW, 3]
    r_ref, t_ref = c2w_ref[:, :3, :3], c2w_ref[:, :3, 3]
    world = pts_ref @ r_ref.transpose(1, 2) + t_ref[:, None]  # [S, HW, 3]
    r_tgt, t_tgt = c2w_tgt[..., :3, :3], c2w_tgt[..., :3, 3]  # [S,N,3,3]
    pts_tgt = (world[:, None] - t_tgt[:, :, None]) @ r_tgt  # R^T x == x @ R
    u, v, z = project(pts_tgt, cam)
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    valid = (z > 1e-4) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    # warp-angle heuristic (section III-C / Fig. 26): angle at the scene
    # point between the reference ray and the target ray
    ray_ref = world - t_ref[:, None]  # [S, HW, 3]
    ray_tgt = world[:, None] - t_tgt[:, :, None]  # [S, N, HW, 3]
    cos = torch.sum(ray_ref[:, None] * ray_tgt, -1) / (
        torch.linalg.norm(ray_ref, dim=-1)[:, None]
        * torch.linalg.norm(ray_tgt, dim=-1) + 1e-9)
    angle = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    if phi_deg is not None:
        valid = valid & (angle <= math.radians(phi_deg))
    return vi * w + ui, z, valid, angle


def warp_frames_flat(rgb_ref: torch.Tensor, depth_ref: torch.Tensor,
                     c2w_ref: torch.Tensor, c2w_tgt: torch.Tensor,
                     cam: Camera, phi_deg: Optional[float] = None,
                     depth_eps: float = 1e-3) -> WarpResult:
    """Warp every session's window in one flat scatter pass.

    rgb_ref [S,H,W,3], depth_ref [S,H,W], c2w_ref [S,4,4], c2w_tgt
    [S,N,4,4] -> a :class:`WarpResult` with leading [S, N] axes. Target
    addresses are (session, frame)-major, so no two frames' candidates
    collide.
    """
    s, n = c2w_tgt.shape[:2]
    h, w = depth_ref.shape[-2:]
    hw = h * w
    b = s * n
    dev = depth_ref.device
    raster, z, valid, angle = _project_to_target(depth_ref, c2w_ref, c2w_tgt,
                                                 cam, phi_deg)
    seg_off = (torch.arange(b, device=dev) * hw).reshape(s, n, 1)
    flat = torch.where(valid, seg_off + raster, b * hw).reshape(-1)
    z_flat = z.reshape(-1)
    # pass 1: min depth per target pixel (slot b*hw takes invalid points)
    zbuf = torch.full((b * hw + 1,), float("inf"), device=dev)
    zbuf.scatter_reduce_(0, flat, z_flat, "amin", include_self=True)
    # pass 2: deterministic winner = max source index among depth ties;
    # the source index is offset per session so one gather pulls the
    # winning colour from the packed reference frames
    is_front = valid.reshape(-1) & (z_flat <= zbuf[flat] + depth_eps)
    pid = (torch.arange(hw, device=dev)[None, :]
           + (torch.arange(s, device=dev) * hw)[:, None])  # [S, HW]
    pid = pid[:, None, :].expand(s, n, hw).reshape(-1)
    winner = torch.full((b * hw + 1,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(is_front, flat, b * hw), pid,
                           "amax", include_self=True)
    winner = winner[:b * hw]
    has = winner >= 0
    src = torch.clamp(winner, min=0)
    rgb = torch.where(has[:, None], rgb_ref.reshape(-1, 3)[src], 0.0)
    depth = torch.where(has, zbuf[:b * hw], float("inf"))
    # the warp angle belongs to the (source point, target frame) pair
    ang = torch.take_along_dim(angle.reshape(b, hw),
                               src.reshape(b, hw) % hw, dim=1)
    ang = torch.where(has, ang.reshape(-1), 0.0)
    return WarpResult(rgb=rgb.reshape(s, n, h, w, 3),
                      depth=depth.reshape(s, n, h, w),
                      holes=~has.reshape(s, n, h, w),
                      warp_angle=ang.reshape(s, n, h, w))


def warp_frame(rgb_ref: torch.Tensor, depth_ref: torch.Tensor,
               c2w_ref: torch.Tensor, c2w_tgt: torch.Tensor, cam: Camera,
               phi_deg: Optional[float] = None,
               depth_eps: float = 1e-3) -> WarpResult:
    """Warp one reference frame into one target camera (steps 1-3)."""
    res = warp_frames_flat(rgb_ref[None], depth_ref[None], c2w_ref[None],
                           c2w_tgt[None, None], cam, phi_deg, depth_eps)
    return WarpResult(*(x[0, 0] for x in res))


def combine(warped: WarpResult, sparse_rgb: torch.Tensor,
            holes: torch.Tensor) -> torch.Tensor:
    """Eq. 4: fill the holes with the sparse NeRF output."""
    return torch.where(holes[..., None], sparse_rgb, warped.rgb)


# ---------------------------------------------------------------------------
# fixed-capacity hole compaction (step 4 staging)
# ---------------------------------------------------------------------------


def _compact(flags: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows of ``flags`` [B, L] bool -> [B, cap] positions of the set
    flags in order (cumsum ranks scattered into a region with one dump
    slot); slots past a row's count hold 0."""
    rows, length = flags.shape
    dev = flags.device
    pos = torch.cumsum(flags, dim=1) - 1
    slot = torch.where(flags & (pos < cap), pos, cap)
    slot = slot + torch.arange(rows, device=dev)[:, None] * (cap + 1)
    src = torch.arange(length, device=dev).expand(rows, length)
    out = torch.zeros(rows * (cap + 1), dtype=torch.int64, device=dev)
    out.scatter_(0, slot.reshape(-1), src.reshape(-1))
    return out.reshape(rows, cap + 1)[:, :cap]


def compact_holes(hflat: torch.Tensor, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[HW] bool -> ([cap] hole pixel ids in raster order, true count)."""
    return _compact(hflat[None], cap)[0], hflat.sum()


def compact_holes_flat(holes: torch.Tensor, cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, N, HW] bool -> (idx [S, N, cap] hole pixel ids per frame,
    counts [S, N] true hole counts), one scatter for the whole tick."""
    s, n, hw = holes.shape
    idx = _compact(holes.reshape(s * n, hw), cap)
    return idx.reshape(s, n, cap), holes.sum(dim=2)


def compact_holes_pooled(holes: torch.Tensor, bucket: int,
                         live: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact a session window's holes into ONE pooled region.

    ``holes`` [S, N, HW] -> (addr [S, bucket] frame-local addresses
    ``n*HW + pixel`` in (frame, raster) order, totals [S] live hole
    totals). ``live`` [S, N] masks padded frames out of the pool. Rows
    past a session's total alias address 0 and are masked at scatter time.
    """
    s, n, hw = holes.shape
    if live is not None:
        holes = holes & live[:, :, None]
    hf = holes.reshape(s, n * hw)
    return _compact(hf, bucket), hf.sum(dim=1)


def warp_disagreement(rgb: torch.Tensor, holes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warped-neighbourhood radiance disagreement (adaptive sampling's
    signal). ``rgb`` [..., H, W, 3] warped colours, ``holes`` [..., H, W]
    -> (var [..., H, W], the variance of the warped (non-hole) colours in
    each pixel's zero-padded 3x3 neighbourhood averaged over the channels;
    cnt [..., H, W] int32, the warped neighbours). The box sums add the
    nine shifted slices in the reference's order (row offset, then column
    offset), and the channel mean sums r, g, b in order, so ``var``
    matches the reference's float32 arithmetic."""
    h, w = holes.shape[-2:]
    wgt = (~holes).to(rgb.dtype)[..., None]  # [..., H, W, 1]

    def box3(a: torch.Tensor) -> torch.Tensor:
        p = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
        out = p[..., 0:h, 0:w, :]
        for i in range(3):
            for j in range(3):
                if i or j:
                    out = out + p[..., i:i + h, j:j + w, :]
        return out

    cnt = box3(wgt)
    s1 = box3(rgb * wgt)
    s2 = box3(rgb * rgb * wgt)
    denom = torch.clamp(cnt, min=1.0)
    mean = s1 / denom
    v = torch.clamp(s2 / denom - mean * mean, min=0.0)
    var = (v[..., 0] + v[..., 1] + v[..., 2]) / 3.0
    return var, cnt[..., 0].to(torch.int32)


def hole_fraction(holes: torch.Tensor) -> torch.Tensor:
    return holes.float().mean()
