"""LR schedules (cosine with linear warmup), as the reference's
``repro/optim/schedule.py``: float32 arithmetic on the step."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                  total: int = 10_000, min_ratio: float = 0.1
                  ) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``min_ratio * peak_lr`` at ``total``; a float32 tensor."""
    stepf = torch.as_tensor(step, dtype=torch.float32)
    warm = stepf / max(warmup, 1)
    prog = torch.clamp((stepf - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(stepf < warmup, warm, cos)
