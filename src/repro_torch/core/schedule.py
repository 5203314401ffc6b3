"""Reference-frame scheduling (paper section III-C; port of
``repro.core.schedule``).

Reference frames are off-trajectory: their pose is extrapolated from the
last two target poses (Eq. 5-6), mid-window. Rotation is extrapolated on
SO(3) via log/exp (Rodrigues), translation linearly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector."""
    cos = torch.clamp((torch.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    scale = torch.where(theta < 1e-6, 0.5,
                        theta / (2.0 * torch.sin(theta) + 1e-12))
    return w * scale


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w)
    k = w / (theta + 1e-12)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    kx = torch.stack([torch.stack([zero, -k[2], k[1]]),
                      torch.stack([k[2], zero, -k[0]]),
                      torch.stack([-k[1], k[0], zero])])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)
    return torch.where(theta < 1e-8, eye, r)


def extrapolate_pose(pose_prev: torch.Tensor, pose_curr: torch.Tensor,
                     steps_ahead: float) -> torch.Tensor:
    """Eq. 5-6: velocity from the last two poses, advanced ``steps_ahead``
    frame intervals (N/2 puts the reference mid-window)."""
    t_prev, t_curr = pose_prev[:3, 3], pose_curr[:3, 3]
    t_ref = t_curr + (t_curr - t_prev) * steps_ahead
    dr = pose_curr[:3, :3] @ pose_prev[:3, :3].T
    r_ref = so3_exp(so3_log(dr) * steps_ahead) @ pose_curr[:3, :3]
    out = torch.eye(4, dtype=pose_curr.dtype, device=pose_curr.device)
    out[:3, :3] = r_ref
    out[:3, 3] = t_ref
    return out


@dataclass
class RefPoseExtrapolator:
    """Per-session reference-pose state, one warp window at a time: call
    :meth:`next_reference` with a window's target poses; it returns the
    window's reference pose and absorbs the window."""

    window: int = 16
    mode: str = "offtraj"
    pose_prev: Optional[torch.Tensor] = None
    pose_curr: Optional[torch.Tensor] = None
    frames_seen: int = 0

    def observe(self, poses: List[torch.Tensor]) -> None:
        for p in poses:
            self.pose_prev, self.pose_curr = self.pose_curr, p
        self.frames_seen += len(poses)

    def next_reference(self, window_poses: List[torch.Tensor]
                       ) -> torch.Tensor:
        """The first window bootstraps with its first target pose; later
        windows extrapolate ``window/2`` intervals past the last two
        observed poses. 'temporal' returns the last observed pose."""
        if not window_poses:
            raise ValueError("empty warp window")
        if self.mode == "offtraj":
            if self.frames_seen == 0:
                ref = window_poses[0]
            else:
                prev = (self.pose_prev if self.pose_prev is not None
                        else self.pose_curr)
                ref = extrapolate_pose(prev, self.pose_curr,
                                       self.window / 2.0)
        elif self.mode == "temporal":
            ref = self.pose_curr if self.frames_seen else window_poses[0]
        else:
            raise ValueError(self.mode)
        self.observe(list(window_poses))
        return ref


@dataclass
class WarpSchedule:
    """Assigns each target frame to a reference frame (window N targets per
    reference; 'offtraj' extrapolates, 'temporal' reuses the last frame)."""

    window: int = 16
    mode: str = "offtraj"

    def windows(self, poses: List[torch.Tensor]) -> List[dict]:
        """Records {window_start, ref_pose, ref_frame_idx, frames}."""
        n = len(poses)
        out = []
        state = RefPoseExtrapolator(window=self.window, mode=self.mode)
        for k in range(0, n, self.window):
            frames = list(range(k, min(k + self.window, n)))
            ref_pose = state.next_reference([poses[f] for f in frames])
            ref_idx = max(k - 1, 0) if self.mode == "temporal" else None
            out.append({"window_start": k, "ref_pose": ref_pose,
                        "ref_frame_idx": ref_idx, "frames": frames})
        return out

    def plan(self, poses: List[torch.Tensor]) -> List[dict]:
        """Per-frame records {frame, window_start, ref_pose, ref_frame_idx}
        (the host loop's view of :meth:`windows`)."""
        return [{"frame": f, "window_start": win["window_start"],
                 "ref_pose": win["ref_pose"],
                 "ref_frame_idx": win["ref_frame_idx"]}
                for win in self.windows(poses) for f in win["frames"]]
