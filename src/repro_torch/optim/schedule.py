"""LR schedules: step -> lr, a float32 0-d tensor (the reference's
``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        s = _f32(step)
        return lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
    return fn


def cosine_warmup(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return lr * warm * cos
    return fn
