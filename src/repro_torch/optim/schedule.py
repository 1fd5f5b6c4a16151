"""LR schedules (warmup + cosine decay) as functions of the step (port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    """Multiplier in [floor, 1]: linear warmup then cosine decay to floor.
    ``step`` is an int or a 0-d tensor; the result is a 0-d fp32 tensor on
    the step's device, computed there (no host sync)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
