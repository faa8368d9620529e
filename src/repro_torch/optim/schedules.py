"""LR schedules (warmup + cosine, constant): plain functions of an int step.

Each returns a Python float holding a float32 value: the arithmetic runs on
0-dim float32 CPU tensors, with the reference's operations in its order
(``src/repro/optim/schedules.py``, ``jnp`` float32 with weak Python
scalars), so the learning rate of a step matches the reference's to the
last bit or one ulp.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(lr: float):
    value = float(_f32(lr))
    return lambda step: value


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, *,
                  final_frac: float = 0.1):
    def fn(step) -> float:
        s = _f32(int(step))
        if s < warmup_steps:
            return float(peak_lr * s / max(warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return float(cos)

    return fn
