"""Learning-rate schedules, evaluated from the step count with torch ops: the
count stays a device tensor, so a scheduled step adds no host sync."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    def sched(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), value, dtype=torch.float32, device=count.device)

    return sched


def _frac(count: torch.Tensor, total_steps: int) -> torch.Tensor:
    return torch.clamp(count.to(torch.float32) / total_steps, 0.0, 1.0)


def linear_decay(init: float, total_steps: int, final: float = 0.0):
    def sched(count: torch.Tensor) -> torch.Tensor:
        return init + (final - init) * _frac(count, total_steps)

    return sched


def cosine_decay(init: float, total_steps: int, final: float = 0.0):
    def sched(count: torch.Tensor) -> torch.Tensor:
        return final + 0.5 * (init - final) * (1.0 + torch.cos(math.pi * _frac(count, total_steps)))

    return sched


def warmup_cosine(init: float, warmup_steps: int, total_steps: int, final: float = 0.0):
    cos = cosine_decay(init, max(1, total_steps - warmup_steps), final)

    def sched(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = init * c / max(1, warmup_steps)
        return torch.where(c < warmup_steps, warm, cos(count - warmup_steps))

    return sched
