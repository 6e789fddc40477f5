"""LR schedules (pure functions of the step counter).

Port of ``repro.optim.schedule``: float32 tensors of the step, which may
be a Python int or an integer tensor (its device is the result's)."""
from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup_steps: int, peak: float):
    step = torch.as_tensor(step)
    return peak * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, *, peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    step = torch.as_tensor(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak * cos)
