"""LR schedules (pure functions of the step counter), in fp32 as in the
reference (``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``min_ratio * peak_lr`` at ``total_steps``.  ``step`` is an int or a
    tensor; the result is a 0-d fp32 tensor on the step's device."""
    step = torch.as_tensor(step).to(f32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
