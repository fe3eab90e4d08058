"""LR schedules.  Paper App. D: linear warmup 2e-5 -> 2e-4, cosine -> 2e-5.

Counterpart of ``repro.optim.schedule``; values are 0-d fp32 tensors on the
CPU, computed in fp32 as the reference does.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant", "get_schedule", "SCHEDULES"]


def warmup_cosine(step, total_steps: int, peak: float = 2e-4,
                  init: float = 2e-5, end: float = 2e-5,
                  warmup_frac: float = 0.05) -> torch.Tensor:
    warmup = max(int(total_steps * warmup_frac), 1)
    step = torch.as_tensor(step, dtype=torch.float32)
    wu = init + (peak - init) * (step / warmup)
    t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
    cos = end + 0.5 * (peak - end) * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < warmup, wu, cos)


def constant(step, lr: float) -> torch.Tensor:
    return torch.full((), lr, dtype=torch.float32)


SCHEDULES = {
    "constant": lambda step, total, peak: constant(step, peak),
    "cosine": lambda step, total, peak: warmup_cosine(
        step, total, peak=peak, init=0.1 * peak, end=0.1 * peak),
}


def get_schedule(name: str):
    if name not in SCHEDULES:
        raise KeyError(f"unknown lr schedule {name!r}; know "
                       f"{sorted(SCHEDULES)}")
    return SCHEDULES[name]
