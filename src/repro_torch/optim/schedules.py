"""Learning-rate schedules, pure functions of the step counter (port of
``repro.optim.schedules``), computed in float32."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``: a float32 scalar
    tensor on ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * torch.clamp((step + 1.0) / max(warmup_steps, 1),
                                 max=1.0)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * progress))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
