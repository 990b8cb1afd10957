"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``).
Each returns a ``step -> lr`` callable; ``step`` is the optimizer's 0-d
int32 tensor and lr a 0-d fp32 tensor on the same device, so evaluating a
schedule never waits for the card."""
from __future__ import annotations

import math

import torch


def _lr(lr, step):
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def constant(lr: float):
    return lambda step: _lr(lr, step)


def exponential_decay(lr: float, decay: float, per_steps: int = 1):
    """Per-round multiplicative decay — the paper's CIFAR schedule
    (FedSGD decay 0.9934/round, FedAvg 0.99/round)."""

    def fn(step):
        return _lr(lr, step) * decay ** (step / per_steps)

    return fn


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.0):
    def fn(step):
        frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return _lr(lr, step) * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        warm = _lr(lr, step) * (step + 1) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
