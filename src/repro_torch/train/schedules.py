"""Learning-rate schedules (PyTorch port of ``repro.train.schedules``).
WSD (warmup-stable-decay) is the minicpm-2b preset.

Each schedule maps a step (an integer tensor) to a 0-d float32 tensor on
the step's device, computed in float32 as the reference's jitted step
computes it: XLA turns a division by a constant into a product with its
float32 reciprocal, so the schedules multiply by that reciprocal.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f32_reciprocal(n: int) -> float:
    """The float32 reciprocal of ``n`` (exact as a Python float): what
    XLA multiplies by where the reference divides by the constant
    ``n``."""
    return float(np.float32(1.0) / np.float32(n))


def _f32(step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def _warmup(s: torch.Tensor, warmup: int) -> torch.Tensor:
    return torch.clamp((s + 1) * f32_reciprocal(max(warmup, 1)), max=1.0)


def _ramp(x: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(x / max(n, 1), 0, 1)`` as XLA computes it."""
    return torch.clamp(x * f32_reciprocal(max(n, 1)), 0.0, 1.0)


def linear_warmup(lr: float, warmup: int):
    return lambda step: lr * _warmup(_f32(step), warmup)


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        prog = _ramp(s - warmup, total - warmup)
        c = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return lr * _warmup(s, warmup) * c
    return fn


def wsd(lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01):
    """Warmup-Stable-Decay (minicpm): linear warmup, flat stable phase,
    linear decay tail."""
    def fn(step):
        s = _f32(step)
        d = _ramp(s - warmup - stable, decay)
        return lr * _warmup(s, warmup) * (1.0 - (1.0 - final_frac) * d)
    return fn
