"""LR schedules (multipliers over base LR); port of
``repro/optim/schedule.py``.

Each schedule maps a step (an int tensor or a Python int) to an f32
multiplier tensor on the step's device, with the reference's
``where``/``clip`` semantics.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(warmup: int, total: int, min_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = step / max(warmup, 1)
        t = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def inverse_sqrt(warmup: int):
    def fn(step):
        step = torch.clamp(_f32(step), min=1.0)
        return torch.minimum(step / max(warmup, 1), torch.sqrt(warmup / step))
    return fn
