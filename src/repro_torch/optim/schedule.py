"""LR schedules (pure functions of the step), the port of
``repro.optim.schedule``. ``step`` is a Python int or a 0-dim tensor; each
returns a 0-dim float32 tensor (on the step's device where it is a
tensor)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float):
    s = _step(step)
    return peak * torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int, peak: float,
                    floor_frac: float = 0.1):
    s = _step(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0, 1)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)
